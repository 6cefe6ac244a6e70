"""Local environment probes: box volumes with a parallax-corrected lookup
(counterpart of datum_tpu/ops/envprobe.py).

Per pixel, the first environment box that holds the pixel and whose
specular dominant ray leaves it (t_out > max(t_in, 0), t_in < 0)
supplies the env specular (the cubemap tapped along the corrected ray at
a roughness scaled by the hit distance) and the env diffuse (its deepest
mip along the diffuse direction); pixels in no box keep the global
skybox terms.  The earliest box wins, and a box counts only below the
probe count.  `env_probe_lookup` overrides per pixel (the deferred
lighting); `env_probe_fields` computes the quarter-resolution fields of
the megakernel branch from each probe's quad-packed table.  Plain
PyTorch on every device: the JAX package runs it in XLA.
"""

from __future__ import annotations

import torch

from .sampling import (sample_cubemap, sample_cubemap_lod, sample_cubemap_lod_quad,
                       sample_cubemap_quad)


def ray_box_exit(origin, direction, halfdim):
    """Slab test of rays against the box [-h, h]^3: (t_enter, t_exit).
    origin, direction (..., 3); halfdim (3,).  Direction components
    below 1e-8 in magnitude are taken as +-1e-8."""
    tiny = torch.where(direction < 0, torch.full_like(direction, -1e-8),
                       torch.full_like(direction, 1e-8))
    inv = 1.0 / torch.where(torch.abs(direction) < 1e-8, tiny, direction)
    t0 = (-halfdim - origin) * inv
    t1 = (halfdim - origin) * inv
    return (torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1))


def _box_hits(worldpos, sdir, ddir, roughness, envs):
    """Per box i, in order: (i, hit mask (not yet taken), the unit
    corrected ray, the local diffuse direction, the local roughness)."""
    n_lod = len(envs["mips"])
    taken = torch.zeros(worldpos.shape[:-1], dtype=torch.bool, device=worldpos.device)
    for i in range(envs["position"].shape[0]):
        rot = envs["inv_rot"][i]
        localpos = (worldpos - envs["position"][i]) @ rot.T
        localspec = sdir @ rot.T
        localdiff = ddir @ rot.T
        t_in, t_out = ray_box_exit(localpos, localspec, envs["halfdim"][i])
        hit = ((t_out > torch.clamp(t_in, min=0.0)) & (t_in < 0.0)
               & (i < envs["count"]) & ~taken)
        localray = localpos + t_out[..., None] * localspec
        raylen = torch.clamp(torch.linalg.norm(localray, dim=-1), min=1e-6)
        localrough = torch.minimum(torch.clamp(roughness * t_out / raylen, min=0.0),
                                   roughness)
        yield (i, hit, localray / raylen[..., None], localdiff,
               localrough * (n_lod - 1))
        taken = taken | hit


def env_probe_lookup(worldpos, sdir, ddir, roughness, envs, env_specular,
                     env_diffuse):
    """The global env terms with the box probes' pixels replaced.

    envs: dict(position (E, 3), inv_rot (E, 3, 3), halfdim (E, 3), mips: a
    list of (E, 6, S, S, C) mip levels, count ()).  Returns
    (env_specular, env_diffuse), (..., 3) each."""
    for i, hit, ray, localdiff, lod in _box_hits(worldpos, sdir, ddir, roughness,
                                                 envs):
        mips_i = [m[i] for m in envs["mips"]]
        spec = sample_cubemap_lod(mips_i, ray, lod)[..., :3]
        diff = sample_cubemap(mips_i[-1], localdiff)[..., :3]
        m = hit[..., None]
        env_specular = torch.where(m, spec, env_specular)
        env_diffuse = torch.where(m, diff, env_diffuse)
    return env_specular, env_diffuse


def env_probe_fields(worldpos, sdir, ddir, roughness, envs):
    """The megakernel branch's reduced-resolution probe fields.

    Inputs are (h, w[, 3]); envs carries "flatqs", one quad-packed mip
    table per probe (RenderContext.device_state).  Returns (spec (h, w,
    3), dif (h, w, 3), hit (h, w) f32): the caller upsamples them, blends
    spec into the env specular field where the hit is > 0.5 and hands
    dif and hit to K2 as the edr/edg/edb/edm override planes."""
    n_lod = len(envs["mips"])
    spec_o = torch.zeros(worldpos.shape[:-1] + (3,), dtype=torch.float32,
                         device=worldpos.device)
    dif_o = torch.zeros_like(spec_o)
    taken = torch.zeros(worldpos.shape[:-1], dtype=torch.bool, device=worldpos.device)
    for i, hit, ray, localdiff, lod in _box_hits(worldpos, sdir, ddir, roughness,
                                                 envs):
        flatq = envs["flatqs"][i]
        spec = sample_cubemap_lod_quad(flatq, ray, lod)[..., :3]
        dif = sample_cubemap_quad(flatq, localdiff, level=n_lod - 1)[..., :3]
        m = hit[..., None]
        spec_o = torch.where(m, spec, spec_o)
        dif_o = torch.where(m, dif, dif_o)
        taken = taken | hit
    return spec_o, dif_o, taken.to(torch.float32)
