"""The deferred (XLA) lighting pass and its screen-space helpers
(counterpart of datum_tpu/ops/lighting_pass.py).

`shade_deferred` turns the gbuffer and the lights into hdr colour for
the frame's branches off the megakernel: the environment (the SH +
quad-packed fast path at half resolution, or the flat / per-mip
trilinear taps), the box environment probes' per-pixel override
(ops/envprobe.py; with probes the fast path is off), SH probes, the sun
with the ESM factor or the PCF stack, dense or clustered point lights,
shadowed and unshadowed spots, emissive and exposure.  Plain PyTorch on
every device: the JAX package runs it in XLA, with no Pallas kernel.
While the program's tracing is on, its terms are spans of their own:
frame.shade.lighting.env (the environment taps, then the ambient and
IBL sum), .probes, .sun, .points and .spots.

The dense point loop and the spot loop run once a live light, so their
trip counts are host values: `light_counts` from the host tree
(render/frame.py::host_light_counts, which frame graphs key on), or,
for a caller with the counts on the device only (the sharded frame), a
readback of each count.
"""

from __future__ import annotations

import torch

from ..debug.debug import span
from . import brdf
from .envprobe import env_probe_lookup


def view_ray_grid(invproj, width, height, y0=0, local_h=None):
    """Per-pixel view ray (x, y, -1) through each pixel centre: returns
    the (local_h, width) x and y components of rows y0 .. y0 + local_h - 1
    of a height-row frame (default: all of it)."""
    dev = invproj.device
    lh = local_h or height
    yn = ((torch.arange(lh, dtype=torch.float32, device=dev) + y0 + 0.5)
          / height * 2.0 - 1.0)[:, None]
    xn = ((torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
          / width * 2.0 - 1.0)[None, :]
    rx = invproj[0, 0] * xn
    ry = invproj[1, 1] * yn
    return rx.expand(lh, width), ry.expand(lh, width)


def reconstruct_positions(depth, proj, invview, width, height, y0=0):
    """Reverse-Z depth (H, W) -> (view-space, world-space) positions
    (H, W, 3).  view_z = proj[2][3] / (d + proj[2][2]) is the positive
    distance along -Z.  The denominator is clamped away from 0 (depth 0
    is the background under the infinite projection), so positions stay
    finite and reduced-res pooling never mixes NaN into covered pixels.
    A band of rows (the tile-sharded frame): depth holds rows y0 .. of a
    frame `height` rows high."""
    rx, ry = view_ray_grid(_inv_proj(proj), width, height, y0=y0,
                           local_h=depth.shape[0])
    denom = depth + proj[2, 2]
    tiny = torch.where(denom < 0, torch.full_like(denom, -1e-7),
                       torch.full_like(denom, 1e-7))
    dist = proj[2, 3] / torch.where(torch.abs(denom) < 1e-7, tiny, denom)
    viewpos = torch.stack([rx * dist, ry * dist, -dist], dim=-1)
    worldpos = viewpos @ invview[:3, :3].T + invview[:3, 3]
    return viewpos, worldpos


def _inv_proj(proj):
    """The analytic inverse entries the ray grid needs (perspective)."""
    m = torch.zeros((4, 4), dtype=proj.dtype, device=proj.device)
    m[0, 0] = 1.0 / proj[0, 0]
    m[1, 1] = 1.0 / proj[1, 1]
    return m


def _env_terms(gbuffer, normal, eyevec, rough, ibl, skyrot, h, w, env_scale,
               worldpos, up):
    """(env_specular, env_diffuse, envbrdf) of the environment, (..., 3)
    each: the skybox's terms, with the box probes' pixels replaced.  The
    SH + quad-packed fast path at 1/env_scale runs only without probes;
    with them every term is tapped per pixel.  up(x, h, w) upsamples the
    fast path's fields (resize_up_dense, or a band's closure)."""
    from .blur import downsample_pool, resize_up_dense
    from .sampling import (sample_cubemap, sample_cubemap_lod, sample_cubemap_lod_flat,
                           sample_cubemap_lod_quad)

    mips = ibl["mips"]
    r = 2.0 * (normal * eyevec).sum(-1, keepdim=True) * normal - eyevec
    sdir = brdf.specular_dominant_direction(normal, r, rough)
    ddir = brdf.diffuse_dominant_direction(normal, eyevec, rough)
    lut = ibl["envbrdf"]
    s = lut.shape[0]
    ndv = torch.clamp((normal * eyevec).sum(-1), 0.0, 1.0)
    envs = ibl.get("envprobes")
    if ("sh" in ibl and "flatq" in ibl and envs is None and env_scale > 1
            and h % env_scale == 0 and w % env_scale == 0):
        # radiance at 1/env_scale, mask-weighted (background lanes hold
        # far clamped positions), upsampled; diffuse from the SH-9
        p = env_scale
        mk = gbuffer["mask"].to(torch.float32)[..., None]
        mk_h = torch.clamp(downsample_pool(mk, p), min=1e-6)
        sdir_h = brdf.normalize(downsample_pool(sdir * mk, p) / mk_h)
        rough_h = downsample_pool(rough[..., None] * mk, p)[..., 0] / mk_h[..., 0]
        ndv_h = downsample_pool(ndv[..., None] * mk, p)[..., 0] / mk_h[..., 0]
        spec_h = sample_cubemap_lod_quad(ibl["flatq"], sdir_h @ skyrot.T,
                                         rough_h * (len(mips) - 1))[..., :3]
        bi = torch.clamp((rough_h * s).to(torch.int32), 0, s - 1)
        bj = torch.clamp((ndv_h * s).to(torch.int32), 0, s - 1)
        eb_h = lut.reshape(-1, lut.shape[-1])[(bi * s + bj).long()]
        # the deepest specular mip is ~E(d)/pi and probe_irradiance gives
        # E(d); ddir is not unit length, the SH basis needs it normalised
        env_diffuse = brdf.probe_irradiance(ibl["sh"], brdf.normalize(ddir) @ skyrot.T) / brdf.PI
        return up(spec_h, h, w), env_diffuse, up(eb_h, h, w)
    lod = rough * (len(mips) - 1)
    sdir_e, ddir_e = sdir @ skyrot.T, ddir @ skyrot.T
    if "flat" in ibl:
        env_specular = sample_cubemap_lod_flat(ibl["flat"], sdir_e, lod)[..., :3]
    else:
        mips_t = [torch.as_tensor(m, device=normal.device) for m in mips]
        env_specular = sample_cubemap_lod(mips_t, sdir_e, lod)[..., :3]
    env_diffuse = sample_cubemap(torch.as_tensor(mips[-1], device=normal.device),
                                 ddir_e)[..., :3]
    bi = torch.clamp((rough * s).to(torch.int32), 0, s - 1).long()
    bj = torch.clamp((ndv * s).to(torch.int32), 0, s - 1).long()
    if envs is not None and envs["position"].shape[0] > 0:
        env_specular, env_diffuse = env_probe_lookup(worldpos, sdir, ddir, rough, envs,
                                                     env_specular, env_diffuse)
    return env_specular, env_diffuse, lut[bi, bj]


def shade_deferred(gbuffer, depth, sceneset, *, proj, invview, light_counts, ssao=None,
                   shadowmaps=None, ibl=None, cluster=None, spotmaps=None,
                   shadow_factor_scale=2, env_scale=2, shadow_slice_blend=0.0,
                   full_size=None, y0=0, up_to=None):
    """The deferred shade: hdr (H, W, 3) times the camera exposure, black
    on the background (the sky fills it later).

    gbuffer: resolve_gbuffer's dict; depth (H, W) reverse-Z; ssao (H,
    W) ambient factor or None; shadowmaps: build_esm's (esm, zmax,
    zscale) tuple (the ESM factor at 1/shadow_factor_scale, upsampled)
    or the raw (S, R, R) cascades (PCF) or None; ibl: the state's
    environment or None (constant ambient); cluster: (lists, counts,
    tiles_x, tiles_y) of bin_lights or None (the dense point-light
    loop); spotmaps: (n, R, R) perspective depth maps of the first n
    spots or None.  A band of rows (the tile-sharded frame's reduced
    path): full_size (H, W) of the frame, y0 the band's first row, and
    up_to(x, h, w) the upsampler of the reduced-res factor and env fields
    (default resize_up_dense; a band passes its all-gather closure).
    light_counts: (point, spot) live light counts as Python ints, equal
    to sceneset's count entries (render/frame.py::read_light_counts)."""
    from .blur import downsample_pool, resize_up_dense
    from .shadow import shadow_factor, shadow_factor_esm_fast, spot_shadow_factor

    h, w = depth.shape
    fh, fw = full_size if full_size is not None else (h, w)
    up = up_to if up_to is not None else resize_up_dense
    viewpos, worldpos = reconstruct_positions(depth, proj, invview, fw, fh, y0=y0)
    campos = invview[:3, 3]
    cam = sceneset["camera"]
    normal = gbuffer["normal"][..., :3] * 2.0 - 1.0
    rough = gbuffer["specular"][..., 3]
    material = dict(diffuse=gbuffer["diffuse"][..., :3], specular=gbuffer["specular"][..., :3],
                    roughness=rough, alpha=rough ** 2,
                    emissive=128.0 * gbuffer["diffuse"][..., 3] ** 3)
    eyevec = brdf.normalize(campos - worldpos)
    ambient = cam["ambientintensity"]
    if ssao is not None:
        ambient = ambient * ssao

    with span("frame.shade.lighting.env"):
        env_specular = env_diffuse = envbrdf = None
        if ibl is not None:
            env_specular, env_diffuse, envbrdf = _env_terms(
                gbuffer, normal, eyevec, rough, ibl, cam["skyrot_inv"], h, w, env_scale,
                worldpos, up)

    probes = sceneset.get("probes")
    if probes is not None and probes["position"].shape[0] > 0 and env_diffuse is not None:
        with span("frame.shade.lighting.probes"):
            total_w = torch.ones(worldpos.shape[:-1], dtype=torch.float32,
                                 device=depth.device)
            acc = env_diffuse
            for i in range(probes["position"].shape[0]):
                on = (i < probes["count"]).to(torch.float32)
                pd = torch.linalg.norm(probes["position"][i, :3] - worldpos, dim=-1)
                dr = pd / torch.clamp(probes["position"][i, 3], min=1e-6)
                dr2 = dr * dr
                att = torch.clamp(1.0 - dr2 * dr2, 0.0, 1.0)
                att = att * att * on
                acc = acc + brdf.probe_irradiance(probes["sh"][i], normal) * att[..., None]
                total_w = total_w + att
            env_diffuse = acc / total_w[..., None]

    with span("frame.shade.lighting.env"):
        if env_diffuse is not None:
            diffuse, specular = brdf.env_light(material, env_diffuse, env_specular, envbrdf,
                                               torch.as_tensor(ambient).expand(h, w))
            specular = specular * cam["specularintensity"]
        else:
            # the constant-ambient fallback without an environment
            amb = torch.as_tensor(ambient * 0.2)
            diffuse = torch.zeros((h, w, 3), dtype=torch.float32, device=depth.device) \
                + (amb[..., None] if amb.ndim == 2 else amb)
            specular = torch.zeros((h, w, 3), dtype=torch.float32, device=depth.device)

    with span("frame.shade.lighting.sun"):
        ml = sceneset["mainlight"]
        if isinstance(shadowmaps, tuple):
            p = shadow_factor_scale
            esm, zmx, zsc = shadowmaps[:3]
            sf_h = shadow_factor_esm_fast(
                downsample_pool(worldpos, p), esm, zmx, zsc, ml["splits"], ml["shadowview"],
                downsample_pool(-viewpos[..., 2], p), normal=downsample_pool(normal, p),
                slice_blend=shadow_slice_blend)
            sf = up(sf_h, h, w)
        elif shadowmaps is not None:
            sf = shadow_factor(worldpos, shadowmaps, ml["splits"], ml["shadowview"],
                               -viewpos[..., 2], normal=normal)
        else:
            sf = torch.ones((h, w), dtype=torch.float32, device=depth.device)
        d, s = brdf.main_light(normal, eyevec, material, ml["direction"], ml["intensity"],
                               ml["cutoff"], sf)
        diffuse = diffuse + d
        specular = specular + s

    with span("frame.shade.lighting.points"):
        pl = sceneset["pointlights"]
        nlights = pl["position"].shape[0]
        if cluster is not None and nlights > 0:
            from .cluster import clustered_point_lights
            lists, _, ctx_, cty_ = cluster
            d, s = clustered_point_lights(worldpos, normal, eyevec, material, pl, lists,
                                          ctx_, cty_)
            diffuse = diffuse + d
            specular = specular + s
        elif nlights > 0:
            # the reference's chunked loop adds 0 times the lights past count
            for i in range(min(light_counts[0], nlights)):
                d, s = brdf.point_light(worldpos, normal, eyevec, material,
                                        pl["position"][i], pl["intensity"][i],
                                        pl["attenuation"][i])
                diffuse = diffuse + d
                specular = specular + s

    with span("frame.shade.lighting.spots"):
        sl = sceneset.get("spotlights")
        if sl is not None and sl["position"].shape[0] > 0:
            n_maps = spotmaps.shape[0] if spotmaps is not None else 0
            scount = min(light_counts[1], sl["position"].shape[0])
            # the first n_maps slots shadowed, the rest unshadowed; the
            # reference adds 0 times the slots past count
            for i in range(scount):
                shadow = (spot_shadow_factor(worldpos, spotmaps[i], sl["shadowview"][i])
                          if i < n_maps else 1.0)
                d, s = brdf.spot_light(worldpos, normal, eyevec, material,
                                       sl["position"][i], sl["intensity"][i],
                                       sl["attenuation"][i], sl["direction"][i],
                                       sl["cutoff"][i], shadow)
                diffuse = diffuse + d
                specular = specular + s

    color = (material["diffuse"] * diffuse + specular
             + material["emissive"][..., None] * material["diffuse"])
    color = color * cam["exposure"]
    return torch.where(gbuffer["mask"][..., None], color, torch.zeros_like(color))
