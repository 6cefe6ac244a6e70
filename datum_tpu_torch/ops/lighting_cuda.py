"""The deferred branch's lighting pass on the card: csrc/lighting.cu.

No Pallas counterpart: the JAX package runs the pass
(datum_tpu/ops/lighting_pass.py::shade_deferred) in XLA.  With
`use_kernel` (the frame's `use_pallas`) and CUDA tensors,
ops/lighting_pass.py::shade_deferred takes its reduced-resolution
environment and sun taps as PyTorch operations, then hands the
per-pixel work to one launch (`lighting_cuda`): the gbuffer decode, the
world position, the sky's SH-9 diffuse on the fast environment path,
the SH probe blend over the live slots, the IBL apply, the sun, the
dense or clustered point lights, the spots with their perspective maps,
emissive and exposure.  `lighting_inputs` packs its arguments: the
params vector (PARAMS_LAYOUT), the point light, spot and probe tables
(a row each), the host light counts, the band's ints.
`lighting_reference` is its plain PyTorch version on those arguments:
it unpacks them and runs the plain pass's per-pixel terms
(lighting_pass._lit), so the two agree bit for bit on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels, brdf
from .common import TILE_H, TILE_W, constant
from .lighting_pass import _lit, _material, reconstruct_positions

LROW, SROW, PROW = 12, 32, 32     # point light, spot and probe table rows
# the params vector: (first index, length) of each value
PARAMS_LAYOUT = dict(proj=(0, 4), invview=(4, 12), sun_direction=(16, 3),
                     sun_intensity=(19, 3), sun_cutoff=(22, 1), ambient=(23, 1),
                     exposure=(24, 1), specularintensity=(25, 1), skyrot=(26, 9),
                     sky_sh=(35, 27))
PARAMS = 64


def _param(params, name):
    i, n = PARAMS_LAYOUT[name]
    return params[i] if n == 1 else params[i:i + n]


def lighting_inputs(gbuffer, depth, sceneset, *, proj, invview, light_counts, ssao=None,
                    env=None, sky_sh=None, sf=None, spotmaps=None, cluster=None, y0=0,
                    full_size=None):
    """The kernel's arguments, as the launcher and lighting_reference take
    them.  env: (env_spec, env_diff or None, env_brdf) (H, W, 3) planes, or
    None (the constant ambient); env_diff None: the sky's SH-9 sky_sh (9,
    3), evaluated per pixel; sf (H, W) the sun factor or None (1);
    light_counts: the host (point, spot) counts; cluster, spotmaps, y0 and
    full_size as lighting_pass.shade_deferred's."""
    dev = depth.device
    H, W = depth.shape
    fh, fw = full_size if full_size is not None else (H, W)
    f32 = dict(dtype=torch.float32, device=dev)
    cam, ml = sceneset["camera"], sceneset["mainlight"]
    sky = (torch.cat([cam["skyrot_inv"].reshape(-1), sky_sh.reshape(-1)])
           if sky_sh is not None else torch.zeros(36, **f32))
    params = torch.cat([
        torch.stack([proj[0, 0], proj[1, 1], proj[2, 2], proj[2, 3]]),
        invview[:3, :4].reshape(-1), ml["direction"], ml["intensity"],
        torch.stack([ml["cutoff"], cam["ambientintensity"], cam["exposure"],
                     cam["specularintensity"]]),
        sky, torch.zeros(PARAMS - 62, **f32)])

    pl = sceneset["pointlights"]
    L = pl["position"].shape[0]
    lights = torch.cat([pl["position"], pl["intensity"], pl["attenuation"],
                        torch.zeros((L, LROW - 10), **f32)], 1)
    sl = sceneset.get("spotlights")
    S = 0 if sl is None else sl["position"].shape[0]
    spots = (torch.zeros((0, SROW), **f32) if S == 0 else torch.cat(
        [sl["position"], sl["intensity"], sl["attenuation"], sl["direction"],
         sl["cutoff"][:, None], sl["shadowview"].reshape(S, 16),
         torch.zeros((S, SROW - 30), **f32)], 1))
    pr = sceneset.get("probes")
    N = 0 if pr is None else pr["position"].shape[0]
    probes = (torch.zeros((0, PROW), **f32) if N == 0 else torch.cat(
        [pr["position"], pr["sh"].reshape(N, 27), torch.zeros((N, PROW - 31), **f32)], 1))
    probe_count = (constant((0,), torch.int32, dev) if N == 0 else
                   torch.as_tensor(pr["count"], dtype=torch.int32, device=dev).reshape(1))

    cl_lists = cl_counts = None
    tiles_x = 0
    if cluster is not None and L > 0:
        lists, counts, tiles_x, tiles_y = cluster
        if (tiles_y * TILE_H, tiles_x * TILE_W) != (H, W):
            raise ValueError(f"lighting: {tiles_x}x{tiles_y} cluster tiles do not cover "
                             f"{H}x{W}")
        cl_lists = lists.to(torch.int32).contiguous()
        cl_counts = counts.to(torch.int32).contiguous()
    env_spec, env_diff, env_brdf = env if env is not None else (None, None, None)
    cont = lambda t: None if t is None else t.contiguous()
    return dict(
        depth=depth.contiguous(), normal=gbuffer["normal"].contiguous(),
        diffuse=gbuffer["diffuse"].contiguous(), specular=gbuffer["specular"].contiguous(),
        mask=gbuffer["mask"].contiguous(), ssao=cont(ssao), env_spec=cont(env_spec),
        env_brdf=None if env_brdf is None else env_brdf[..., :3].contiguous(),
        env_diff=cont(env_diff), sf=cont(sf), spotmaps=cont(spotmaps),
        params=params.contiguous(), lights=lights.contiguous(),
        n_point=min(int(light_counts[0]), L), spots=spots.contiguous(),
        n_spot=min(int(light_counts[1]), S), probes=probes.contiguous(),
        probe_count=probe_count, cl_lists=cl_lists, cl_counts=cl_counts, tiles_x=int(tiles_x),
        y0=int(y0), full_h=int(fh), full_w=int(fw))


def lighting_reference(depth, normal, diffuse, specular, mask, ssao, env_spec, env_brdf,
                       env_diff, sf, spotmaps, params, lights, n_point, spots, n_spot,
                       probes, probe_count, cl_lists, cl_counts, tiles_x, y0, full_h,
                       full_w):
    """Plain PyTorch version of the kernel: hdr (H, W, 3) from
    lighting_inputs' arguments, through the plain pass's own terms."""
    H, W = depth.shape
    dev = depth.device
    proj = torch.zeros((4, 4), dtype=torch.float32, device=dev)
    proj[0, 0], proj[1, 1], proj[2, 2], proj[2, 3] = _param(params, "proj")
    invview = torch.cat([_param(params, "invview").reshape(3, 4),
                         torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev)])
    _, worldpos = reconstruct_positions(depth, proj, invview, full_w, full_h, y0=y0)
    gbuffer = dict(normal=normal, diffuse=diffuse, specular=specular, mask=mask)
    nrm = normal[..., :3] * 2.0 - 1.0
    rough = specular[..., 3]
    eyevec = brdf.normalize(invview[:3, 3] - worldpos)
    ambient = _param(params, "ambient")
    if ssao is not None:
        ambient = ambient * ssao
    env = None
    if env_spec is not None:
        if env_diff is None:
            skyrot = _param(params, "skyrot").reshape(3, 3)
            ddir = brdf.diffuse_dominant_direction(nrm, eyevec, rough)
            env_diff = brdf.probe_irradiance(_param(params, "sky_sh").reshape(9, 3),
                                             brdf.normalize(ddir) @ skyrot.T) / brdf.PI
        env = (env_spec, env_diff, env_brdf)
    S = spots.shape[0]
    scene = dict(
        camera=dict(exposure=_param(params, "exposure"),
                    specularintensity=_param(params, "specularintensity")),
        mainlight=dict(direction=_param(params, "sun_direction"),
                       intensity=_param(params, "sun_intensity"),
                       cutoff=_param(params, "sun_cutoff")),
        pointlights=dict(position=lights[:, 0:3], intensity=lights[:, 3:6],
                         attenuation=lights[:, 6:10]),
        spotlights=dict(position=spots[:, 0:3], intensity=spots[:, 3:6],
                        attenuation=spots[:, 6:10], direction=spots[:, 10:13],
                        cutoff=spots[:, 13], shadowview=spots[:, 14:30].reshape(S, 4, 4)),
        probes=dict(position=probes[:, 0:4], sh=probes[:, 4:31].reshape(-1, 9, 3),
                    count=probe_count[0]))
    cluster = None if cl_lists is None else (cl_lists, cl_counts, tiles_x, H // TILE_H)
    return _lit(nrm, _material(gbuffer, rough), mask, worldpos, eyevec, ambient, env, scene,
                lambda: sf, cluster, spotmaps, (n_point, n_spot), H, W, dev)


@_kernels.enroll
def lighting_cuda(depth, normal, diffuse, specular, mask, ssao, env_spec, env_brdf, env_diff,
                  sf, spotmaps, params, lights, n_point, spots, n_spot, probes, probe_count,
                  cl_lists, cl_counts, tiles_x, y0, full_h, full_w, out=None):
    """The kernel: the same contract as lighting_reference.  out: the (H,
    W, 3) f32 result's preallocated tensor, written and returned.  Raises
    on what the kernel does not take (it never falls back)."""
    dev = depth.device
    if dev.type != "cuda":
        raise ValueError(f"lighting_cuda needs CUDA tensors, got {dev}")
    H, W = depth.shape
    f32 = torch.float32
    if out is None:
        out = torch.empty((H, W, 3), dtype=f32, device=dev)
    checks = [("depth", depth, f32, (H, W)), ("normal", normal, f32, (H, W, 4)),
              ("diffuse", diffuse, f32, (H, W, 4)), ("specular", specular, f32, (H, W, 4)),
              ("mask", mask, torch.bool, (H, W)), ("params", params, f32, (PARAMS,)),
              ("lights", lights, f32, (lights.shape[0], LROW)),
              ("spots", spots, f32, (spots.shape[0], SROW)),
              ("probes", probes, f32, (probes.shape[0], PROW)),
              ("probe_count", probe_count, torch.int32, (1,)), ("out", out, f32, (H, W, 3))]
    for name, t, shape in (("ssao", ssao, (H, W)), ("sf", sf, (H, W)),
                           ("env_spec", env_spec, (H, W, 3)),
                           ("env_brdf", env_brdf, (H, W, 3)),
                           ("env_diff", env_diff, (H, W, 3))):
        if t is not None:
            checks.append((name, t, f32, shape))
    if (env_spec is None) != (env_brdf is None) or (env_spec is None and env_diff is not None):
        raise ValueError("lighting_cuda: env_spec and env_brdf come together, env_diff "
                         "only with them")
    n_maps = res = 0
    if spotmaps is not None:
        n_maps, res = spotmaps.shape[0], spotmaps.shape[1]
        checks.append(("spotmaps", spotmaps, f32, (n_maps, res, res)))
    cap = 0
    if cl_lists is not None:
        if H % TILE_H or W % TILE_W or W // TILE_W != tiles_x:
            raise ValueError(f"lighting_cuda: clusters need {tiles_x} tiles of "
                             f"{TILE_H}x{TILE_W} a row, got {H}x{W}")
        n_tiles, cap = (H // TILE_H) * tiles_x, cl_lists.shape[-1]
        checks += [("cl_lists", cl_lists, torch.int32, (n_tiles, cap)),
                   ("cl_counts", cl_counts, torch.int32, (n_tiles,))]
    _kernels.check_tensors("lighting_cuda", dev, checks)
    if not (0 <= n_point <= lights.shape[0] and 0 <= n_spot <= spots.shape[0]):
        raise ValueError(f"lighting_cuda: {n_point} point lights of {lights.shape[0]} "
                         f"rows, {n_spot} spots of {spots.shape[0]}")
    if any(t.data_ptr() % 16 for t in (normal, diffuse, specular)):
        raise ValueError("lighting_cuda: the gbuffer planes need 16-byte alignment")
    kl = _kernels.library()
    smem = kl.lib.lighting_smem_bytes(n_point, n_spot, probes.shape[0], int(cap > 0))
    if smem > 48 * 1024:
        raise ValueError(f"lighting_cuda: tables need {smem} B of shared memory (> 48 KB)")
    vp = ctypes.c_void_p
    ptr = lambda t: vp(None if t is None else t.data_ptr())
    code = kl.lib.lighting_launch(
        ptr(depth), ptr(normal), ptr(diffuse), ptr(specular), ptr(mask), ptr(ssao),
        ptr(env_spec), ptr(env_brdf), ptr(env_diff), ptr(sf), ptr(spotmaps), n_maps, res,
        ptr(params), ptr(lights), lights.shape[0], n_point, ptr(spots), n_spot,
        ptr(probes), probes.shape[0], ptr(probe_count), ptr(cl_lists),
        ptr(cl_counts), cap, tiles_x, H, W, y0, full_h, full_w, ptr(out),
        vp(_kernels.stream_ptr(dev)))
    _kernels.check(code, "lighting")
    return out
