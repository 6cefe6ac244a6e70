"""Sun cascades and spot maps with their shadow factors (counterpart of
datum_tpu/ops/shadow.py).

The depth maps are stacked atlases: every slice (or spot) is a band of
one virtual framebuffer, its triangles carry the band as a y scissor,
and one binning and one raster launch cover the stack.  With
`use_kernel` (the frame's `use_pallas`) K3 (ops/raster_depth_cuda.py)
rasters it; without, the scan raster (ops/raster.py::raster) does, as
the JAX package's XLA path does — and like it, without the band
scissor, which the scan raster does not read.

The factors: exponential shadow maps tapped at quarter resolution (the
megakernel path), the 12-tap Poisson PCF of the sun cascades with the
split blend weights, and the single-tap perspective spot test (the
deferred path).

Not ported: the pair-row cascade blend (`build_esm_pair`, `esm_pair`)
and the slow per-slice `shadow_factor_esm` (no frame path calls them).
"""

from __future__ import annotations

import numpy as np
import torch

from . import raster as raster_ops
from .blur import downsample_pool, resize_up_dense, shifted_gaussian_blur
from .common import TILE_H, TILE_W, texel_index
from .lighting_pass import reconstruct_positions
from .raster_depth_cuda import raster_depth

ESM_C = 40.0
SPOT_ESM_C = 30.0
ESM_BLUR_SIGMA, SPOT_ESM_BLUR_SIGMA = 1.5, 1.0
STACK_SPAN = 4        # max tiles a binned shadow-stack triangle covers
NEAR_SLICES = 2       # cascades at full res when the rest use far_res
SCALE = 4             # the factors' reduced resolution (quarter res)

# the PCF's 12-tap unit-disk pattern (golden-angle spiral)
_GOLDEN = np.pi * (3 - np.sqrt(5))
_R = np.sqrt((np.arange(12) + 0.5) / 12)
_A = np.arange(12) * _GOLDEN
POISSON = np.stack([_R * np.cos(_A), _R * np.sin(_A)], -1).astype(np.float32)


def _corners(world_pos, tris):
    """(3, T) world corners p0, p1, p2 and the shared-vertex mask."""
    t = tris.long()
    p0, p1, p2 = (world_pos[t[:, j]].T for j in range(3))
    shared = ((tris[:, 0] == tris[:, 1]) | (tris[:, 1] == tris[:, 2])
              | (tris[:, 0] == tris[:, 2]))
    return p0, p1, p2, shared


def _band_ylim(n, T, dev):
    """Per-triangle NDC y scissor of band (tri // T) of n."""
    band = torch.arange(n * T, dtype=torch.int32, device=dev) // T
    lo = -1.0 + band.to(torch.float32) * (2.0 / n)
    return lo, lo + 2.0 / n


def _stack(comps, shared, tri_valid, n, res, T, cull, tri_block):
    """One stacked atlas: setup of n bands of res x res plus its shape."""
    tiles_x, tiles_y, vh = res // TILE_W, (res * n) // TILE_H, res * n
    setup = raster_ops.triangle_setup_comps(
        comps, shared.repeat(n), res, vh, tiles_x, tiles_y,
        tri_valid=tri_valid, cull=cull, max_span=STACK_SPAN,
        ylim=_band_ylim(n, T, shared.device))
    return dict(setup=setup, n_tris=n * T, n_maps=n, res=res,
                tiles_x=tiles_x, tiles_y=tiles_y, height=vh,
                tri_block=(n, tiles_x * tiles_y // n) if tri_block else None)


def cascade_stack(p0, p1, p2, shared, shadowview, *, res):
    """Setup of the slices of `shadowview` (S, 4, 4) stacked vertically
    into one res x S*res atlas.  Each slice's clip y is remapped to its
    band: y' = y / S + (2s - (S-1)) / S * w; casters facing away from the
    light are culled."""
    n = shadowview.shape[0]
    parts = {f"{c}{j}": [] for c in "xyzw" for j in range(3)}
    for s in range(n):
        m = shadowview[s]
        off = (2.0 * s - (n - 1)) / n
        for j, p in enumerate((p0, p1, p2)):
            cx = m[0, 0] * p[0] + m[0, 1] * p[1] + m[0, 2] * p[2] + m[0, 3]
            cy = m[1, 0] * p[0] + m[1, 1] * p[1] + m[1, 2] * p[2] + m[1, 3]
            cz = m[2, 0] * p[0] + m[2, 1] * p[1] + m[2, 2] * p[2] + m[2, 3]
            cw = m[3, 0] * p[0] + m[3, 1] * p[1] + m[3, 2] * p[2] + m[3, 3]
            parts[f"x{j}"].append(cx)
            parts[f"y{j}"].append(cy * (1.0 / n) + off * cw)
            parts[f"z{j}"].append(cz)
            parts[f"w{j}"].append(cw)
    comps = {k: torch.cat(v) for k, v in parts.items()}
    return _stack(comps, shared, None, n, res, p0.shape[1], cull=-1,
                  tri_block=True)


def cascade_stacks(world_pos, tris, shadowview, *, res, far_res=None):
    """The atlases render_shadow_cascades rasters: one stack of all
    slices, or with far_res a near stack (the first NEAR_SLICES at res)
    and a far stack (the rest at far_res)."""
    p0, p1, p2, shared = _corners(world_pos, tris)
    n = shadowview.shape[0]
    if far_res is None or far_res == res or n <= NEAR_SLICES:
        return [cascade_stack(p0, p1, p2, shared, shadowview, res=res)]
    return [cascade_stack(p0, p1, p2, shared, shadowview[:NEAR_SLICES], res=res),
            cascade_stack(p0, p1, p2, shared, shadowview[NEAR_SLICES:],
                          res=far_res)]


def bin_stack(stack, bin_capacity, big_capacity, return_overflow=False):
    """Near-to-light-first binning of one stack: (bins, counts, big_ids[,
    overflow])."""
    setup = stack["setup"]
    return raster_ops.bin_triangles(
        setup, stack["n_tris"], stack["tiles_x"], stack["tiles_y"],
        bin_capacity, big_capacity, max_span=STACK_SPAN,
        return_overflow=return_overflow, depth_prio=setup["zbound"],
        tri_block=stack["tri_block"])


def raster_stack(stack, bin_capacity, big_capacity, early_z=False, use_kernel=True,
                 overflow=None):
    """Bin and raster one stack: (n_maps, res, res) reverse-Z depth.  K3
    with use_kernel (early_z: its early exit), else the scan raster.
    overflow: a list that gets the stack's dropped bin entries (() i32,
    on the device), or None (not counted)."""
    bins, counts, big_ids, *dropped = bin_stack(stack, bin_capacity, big_capacity,
                                                return_overflow=overflow is not None)
    if overflow is not None:
        overflow.append(dropped[0])
    if use_kernel:
        depth = raster_depth(stack["setup"], bins, big_ids, counts,
                             stack["tiles_x"], stack["tiles_y"], stack["res"],
                             stack["height"], early_z=early_z)
    else:
        depth, _ = raster_ops.raster(stack["setup"], bins, big_ids, stack["tiles_x"],
                                     stack["tiles_y"], stack["res"], stack["height"])
    return depth.reshape(stack["n_maps"], stack["res"], stack["res"])


def render_shadow_cascades(world_pos, tris, shadowview, *, res=1024,
                           bin_capacity=128, big_capacity=32, far_res=None,
                           early_z=False, use_kernel=True, overflow=None):
    """Depth-only cascades: (S, res, res) reverse-Z depth, or with
    far_res a list of per-slice maps [(res, res)] * NEAR_SLICES +
    [(far_res, far_res)] * the rest (build_esm takes either).  K3 rasters
    them with use_kernel, the scan raster without.  overflow: as
    raster_stack's, one entry a stack."""
    maps = [raster_stack(st, bin_capacity, big_capacity, early_z, use_kernel, overflow)
            for st in cascade_stacks(world_pos, tris, shadowview, res=res,
                                     far_res=far_res)]
    if len(maps) == 1:
        return maps[0]
    return [m for stack in maps for m in stack.unbind(0)]


def build_esm(shadowmaps, shadowview):
    """Exponential shadow maps from raw cascade depth.

    Per cascade: e = exp(clip(c * d', 0, 20)) with d' = (zmax - z) *
    scale the depth from the nearest occluder over the cascade's world
    extent, blurred in light space (shifted-add gaussian); reduced-res
    slices blur at their own size and are upsampled to the largest.
    Returns (esm (S, R, R), zmax (S,), zscale (S,))."""
    max_res = max(m.shape[-1] for m in shadowmaps)
    esms, zmaxs, zscales = [], [], []
    for s in range(len(shadowmaps)):
        m = shadowview[s]
        extent = 2.0 / torch.clamp(torch.linalg.norm(m[0, :3]), min=1e-9)
        depth_per_world = torch.linalg.norm(m[2, :3])
        norm_scale = 1.0 / torch.clamp(depth_per_world * extent, min=1e-12)
        zmax = torch.max(shadowmaps[s])
        dprime = (zmax - shadowmaps[s]) * norm_scale
        e = torch.exp(torch.clamp(ESM_C * dprime, 0.0, 20.0))
        e = shifted_gaussian_blur(e, ESM_BLUR_SIGMA, radius=3)
        if e.shape[-1] != max_res:
            e = resize_up_dense(e, max_res, max_res)
        esms.append(e)
        zmaxs.append(zmax)
        zscales.append(norm_scale)
    return torch.stack(esms), torch.stack(zmaxs), torch.stack(zscales)


def shadow_factor_esm_fast(worldpos, esm, zmax, zscale, splits, shadowview,
                           view_dist, normal=None, slice_blend=0.0, affine_next=True):
    """Single-tap ESM sun factor: the cascade is chosen per pixel from
    the view distance, then one nearest tap of its map.

    slice_blend > 0 blends into the next cascade over the last
    slice_blend fraction of each split range, with a second tap of the
    next map.  With affine_next (the frames' path) the next slice's clip
    coordinates are an affine function of this slice's, which holds only
    when all cascades share axes — sun cascades do, since only their
    ortho extents and centres differ — and the normal-offset bias of the
    second tap uses this slice's texel size (a sub-texel difference at
    the seam).  affine_next=False projects the position again through
    the next slice's own matrix, normal offset and bias (cascades with
    unrelated axes)."""
    nslices, res, _ = esm.shape
    s_sel = torch.zeros(view_dist.shape, dtype=torch.int64,
                        device=view_dist.device)
    for s in range(nslices - 1):
        s_sel = s_sel + (view_dist > splits[s] * 1.05).to(torch.int64)

    xnorm = torch.linalg.norm(shadowview[:, 0, :3], dim=-1)
    znorm = torch.linalg.norm(shadowview[:, 2, :3], dim=-1)
    flat = esm.reshape(-1)

    def lit_of(tap, inside, expt):
        return torch.where(inside, torch.clamp(tap * expt, 0.0, 1.0),
                           torch.ones_like(tap))

    def project(sl):
        """Slice sl's texel, inside mask, exp term and clip coords."""
        m = shadowview[sl]                                 # (..., 4, 4)
        zscale_sel = zscale[sl]
        wtexel = 2.0 / (res * xnorm[sl])
        pos = (worldpos if normal is None
               else worldpos + normal * (1.5 * wtexel)[..., None])
        px, py, pz = pos[..., 0], pos[..., 1], pos[..., 2]
        cx = m[..., 0, 0] * px + m[..., 0, 1] * py + m[..., 0, 2] * pz + m[..., 0, 3]
        cy = m[..., 1, 0] * px + m[..., 1, 1] * py + m[..., 1, 2] * pz + m[..., 1, 3]
        ref = m[..., 2, 0] * px + m[..., 2, 1] * py + m[..., 2, 2] * pz + m[..., 2, 3]
        u = cx * 0.5 + 0.5
        v = cy * 0.5 + 0.5
        inside = ((u > 0.01) & (u < 0.99) & (v > 0.01) & (v < 0.99)
                  & (ref > 0) & (ref < 1))
        xi, yi = texel_index(u * res, res), texel_index(v * res, res)
        dref = (zmax[sl] - ref) * zscale_sel
        bias = wtexel * zscale_sel * znorm[sl] * 2.0
        expt = torch.exp(torch.clamp(-ESM_C * (dref - bias), -20.0, 20.0))
        return (sl * res + yi) * res + xi, inside, expt, (cx, cy, ref)

    texel, inside, expt, (cx, cy, ref) = project(s_sel)
    lit = lit_of(flat[texel], inside, expt)
    if not (slice_blend > 0 and nslices > 1):
        return lit

    # fraction into the current slice's range, 0 at its near split
    lo_t = torch.cat([splits[:1] * 0, splits[:nslices - 1]])
    lo = torch.where(s_sel > 0, lo_t[s_sel] * 1.05, torch.zeros_like(view_dist))
    hi = splits[:nslices][s_sel]
    t_ = (view_dist - lo) / torch.clamp(hi - lo, min=1e-3)
    wgt = torch.clamp((t_ - (1.0 - slice_blend)) / slice_blend, 0.0, 1.0)
    wgt = torch.where(s_sel >= nslices - 1, torch.zeros_like(wgt), wgt)
    s_next = torch.clamp(s_sel + 1, max=nslices - 1)
    if not affine_next:
        texel_n, inn, exptn, _ = project(s_next)
        return lit + (lit_of(flat[texel_n], inn, exptn) - lit) * wgt

    # the next slice's clip coords, affine in this slice's (shared axes)
    r3 = shadowview[:, :3, :3]
    n2 = torch.clamp((r3 * r3).sum(-1), min=1e-12)          # (S, 3)
    nxtv = torch.cat([shadowview[1:], shadowview[-1:]], 0)
    a_rc = (nxtv[:, :3, :3] * r3).sum(-1) / n2              # (S, 3)
    b_rc = nxtv[:, :3, 3] - a_rc * shadowview[:, :3, 3]
    a_s, b_s = a_rc[s_sel], b_rc[s_sel]
    cxn = a_s[..., 0] * cx + b_s[..., 0]
    cyn = a_s[..., 1] * cy + b_s[..., 1]
    refn = a_s[..., 2] * ref + b_s[..., 2]
    inn = ((torch.abs(cxn) < 0.98) & (torch.abs(cyn) < 0.98)
           & (refn > 0) & (refn < 1))
    zscn = zscale[s_next]
    drefn = (zmax[s_next] - refn) * zscn
    biasn = (2.0 / (res * xnorm[s_next])) * zscn * znorm[s_next] * 2.0
    exptn = torch.exp(torch.clamp(-ESM_C * (drefn - biasn), -20.0, 20.0))
    xin = texel_index((cxn * 0.5 + 0.5) * res, res)
    yin = texel_index((cyn * 0.5 + 0.5) * res, res)
    lit_next = lit_of(flat[(s_next * res + yin) * res + xin], inn, exptn)
    return lit + (lit_next - lit) * wgt


def sun_shadow_factor_quarter(depth, nrm_planes, shadowmaps, sceneset, *,
                              proj, invview, slice_blend=0.0, y0=0, full_height=None):
    """Quarter-res sun ESM factor straight from the depth plane.
    shadowmaps: build_esm's (esm, zmax, zscale).  y0 and full_height
    (full-res rows) place a band of rows in the frame."""
    esm, zmx, zsc = shadowmaps
    dq = downsample_pool(depth, SCALE, reduce="first")
    h4, w4 = dq.shape
    fh4 = full_height // SCALE if full_height is not None else h4
    viewpos, wpos = reconstruct_positions(dq, proj, invview, w4, fh4, y0=y0 // SCALE)
    nrm = torch.stack([downsample_pool(p, SCALE, reduce="first")
                       for p in nrm_planes], dim=-1)
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                            min=1e-6)
    ml = sceneset["mainlight"]
    return shadow_factor_esm_fast(wpos, esm, zmx, zsc, ml["splits"],
                                  ml["shadowview"], -viewpos[..., 2],
                                  normal=nrm, slice_blend=slice_blend)


def build_spot_esm(spotmaps):
    """Exponential transform + light-space blur of spot depth maps:
    factor = clamp(E[exp(-c occ)] * exp(c ref)), empty texels read lit."""
    e = torch.exp(-SPOT_ESM_C * torch.clamp(spotmaps, 0.0, 1.0))
    return torch.stack([shifted_gaussian_blur(e[i], SPOT_ESM_BLUR_SIGMA, radius=2)
                        for i in range(e.shape[0])])


def _parabolic(m, p, far):
    """Paraboloid warp of points p (3, ...) in the rigid light view m:
    (px, py, 1 - L/far, vz < 0.6 L)."""
    vx = m[0, 0] * p[0] + m[0, 1] * p[1] + m[0, 2] * p[2] + m[0, 3]
    vy = m[1, 0] * p[0] + m[1, 1] * p[1] + m[1, 2] * p[2] + m[1, 3]
    vz = m[2, 0] * p[0] + m[2, 1] * p[1] + m[2, 2] * p[2] + m[2, 3]
    L = torch.sqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=1e-12))
    denom = torch.clamp(L - vz, min=1e-6)
    return vx / denom, vy / denom, 1.0 - L / far, vz < 0.6 * L


def spot_stack_parabolic(world_pos, tris, spotview_rigid, spot_far, n_maps, *,
                         res):
    """Setup of n_maps parabolic spot maps stacked into one atlas.  Each
    caster vertex maps through x' = vx/(L - vz), y' = vy/(L - vz) with
    reverse depth 1 - L/far; triangles with a corner near the
    paraboloid's fold (behind the light) are dropped; two-sided."""
    res = max(res, TILE_W)
    p0, p1, p2, shared = _corners(world_pos, tris)
    parts = {f"{c}{j}": [] for c in "xyzw" for j in range(3)}
    valid_parts = []
    for s in range(n_maps):
        m = spotview_rigid[s]
        far = torch.clamp(spot_far[s], min=1e-3)
        off = (2.0 * s - (n_maps - 1)) / n_maps
        ok = None
        for j, p in enumerate((p0, p1, p2)):
            px, py, pz, corner_ok = _parabolic(m, p, far)
            parts[f"x{j}"].append(px)
            parts[f"y{j}"].append(py * (1.0 / n_maps) + off)
            parts[f"z{j}"].append(pz)
            parts[f"w{j}"].append(torch.ones_like(px))
            ok = corner_ok if ok is None else ok & corner_ok
        valid_parts.append(ok)
    comps = {k: torch.cat(v) for k, v in parts.items()}
    return _stack(comps, shared, torch.cat(valid_parts), n_maps, res,
                  p0.shape[1], cull=0, tri_block=False)


def render_spot_maps_parabolic(world_pos, tris, spotview_rigid, spot_far,
                               n_maps, *, res=256, bin_capacity=128,
                               big_capacity=32, early_z=False, overflow=None):
    """Parabolic spot depth maps (n_maps, res, res), one K3 launch
    (overflow: as raster_stack's)."""
    stack = spot_stack_parabolic(world_pos, tris, spotview_rigid, spot_far,
                                 n_maps, res=res)
    return raster_stack(stack, bin_capacity, big_capacity, early_z, overflow=overflow)


def spot_factor_quarter_parabolic(depth, spot_esm, view_rigid, far, *,
                                  proj, invview, y0=0, full_height=None):
    """Quarter-res parabolic factor of one spot from its ESM map (y0,
    full_height: a band of rows, as sun_shadow_factor_quarter's)."""
    res = spot_esm.shape[0]
    dq = downsample_pool(depth, SCALE, reduce="first")
    h4, w4 = dq.shape
    fh4 = full_height // SCALE if full_height is not None else h4
    _, wpos = reconstruct_positions(dq, proj, invview, w4, fh4, y0=y0 // SCALE)
    m = view_rigid
    vx = wpos @ m[0, :3] + m[0, 3]
    vy = wpos @ m[1, :3] + m[1, 3]
    vz = wpos @ m[2, :3] + m[2, 3]
    L = torch.sqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=1e-12))
    denom = torch.clamp(L - vz, min=1e-6)
    px = vx / denom
    py = vy / denom
    ref = 1.0 - L / torch.clamp(far, min=1e-3)
    inside = (px * px + py * py < 0.96) & (ref > 0) & (ref < 1) & (vz < 0.6 * L)
    xi = texel_index((px * 0.5 + 0.5) * res, res)
    yi = texel_index((py * 0.5 + 0.5) * res, res)
    tap = spot_esm.reshape(-1)[yi * res + xi]
    lit = torch.clamp(tap * torch.exp(torch.clamp(SPOT_ESM_C * ref, 0.0, 30.0)),
                      0.0, 1.0)
    return torch.where(inside, lit, torch.ones_like(lit))


def render_spot_maps(world_pos, tris, spotview, n_maps, *, res=256, bin_capacity=128,
                     big_capacity=32, early_z=True, use_kernel=True, overflow=None):
    """Perspective depth maps of the first n_maps spot lights: the
    cascade stack of their shadowviews (n_maps, res, res), res at least
    one tile wide (overflow: as raster_stack's)."""
    return render_shadow_cascades(world_pos, tris, spotview[:n_maps],
                                  res=max(res, TILE_W), bin_capacity=bin_capacity,
                                  big_capacity=big_capacity, early_z=early_z,
                                  use_kernel=use_kernel, overflow=overflow)


def _spot_project(worldpos, shadowview, res):
    """Perspective projection into a spot map: (texel x, texel y, ref
    depth, inside)."""
    hp = worldpos @ shadowview[:3, :3].T + shadowview[:3, 3]
    ww = worldpos @ shadowview[3, :3] + shadowview[3, 3]
    ws = torch.where(torch.abs(ww) < 1e-8, torch.full_like(ww, 1e-8), ww)
    u = hp[..., 0] / ws * 0.5 + 0.5
    v = hp[..., 1] / ws * 0.5 + 0.5
    ref = hp[..., 2] / ws
    inside = ((u > 0) & (u < 1) & (v > 0) & (v < 1) & (ref > 0) & (ref < 1)
              & (ww > 0))
    return texel_index(u * res, res), texel_index(v * res, res), ref, inside


def spot_shadow_factor(worldpos, spotmap, shadowview, bias=2e-3):
    """Single-tap perspective shadow test of one spot: worldpos (H, W,
    3), spotmap (R, R) reverse-Z, shadowview (4, 4).  1 outside the
    map."""
    xi, yi, ref, inside = _spot_project(worldpos, shadowview, spotmap.shape[0])
    lit = (spotmap[yi, xi] <= ref + bias).to(torch.float32)
    return torch.where(inside, lit, torch.ones_like(lit))


def spot_factor_quarter(depth, spot_esm, shadowview, *, proj, invview, y0=0,
                        full_height=None):
    """Quarter-res perspective factor of one spot from its ESM map (y0,
    full_height: a band of rows, as sun_shadow_factor_quarter's)."""
    res = spot_esm.shape[0]
    dq = downsample_pool(depth, SCALE, reduce="first")
    h4, w4 = dq.shape
    fh4 = full_height // SCALE if full_height is not None else h4
    _, wpos = reconstruct_positions(dq, proj, invview, w4, fh4, y0=y0 // SCALE)
    xi, yi, ref, inside = _spot_project(wpos, shadowview, res)
    tap = spot_esm.reshape(-1)[yi * res + xi]
    lit = torch.clamp(tap * torch.exp(torch.clamp(SPOT_ESM_C * ref, 0.0, 30.0)),
                      0.0, 1.0)
    return torch.where(inside, lit, torch.ones_like(lit))


def shadow_split_weights(splits, nslices, depth_dist):
    """Per-cascade blend weights (..., 4), summing to at most 1: each
    slice hands over to the next over the last quarter of its range
    (smoothstep)."""
    s = splits[:3]
    t = torch.clamp((depth_dist[..., None] - 0.75 * s) / (s - 0.75 * s), 0.0, 1.0)
    t = t * t * (3 - 2 * t)
    a = torch.cat([t, torch.zeros_like(t[..., :1])], -1)
    b = torch.cat([torch.ones_like(t[..., :1]), t], -1)
    w = (1 - a) * b
    on = torch.arange(4, device=w.device) < nslices
    return torch.where(on, w, torch.zeros_like(w))


def shadow_factor(worldpos, shadowmaps, splits, shadowview, view_dist, normal=None,
                  spread=1.5):
    """12-tap Poisson PCF factor in [0, 1] of the sun: worldpos (H, W,
    3); shadowmaps (S, R, R) reverse-Z; view_dist (H, W) the positive
    view distance the split weights read; normal (H, W, 3) offsets the
    receiver against acne.  The bias is slope-scaled per cascade from its
    texel footprint."""
    nslices, res, _ = shadowmaps.shape
    weights = shadow_split_weights(splits, nslices, view_dist)
    total_w = torch.zeros(worldpos.shape[:-1], dtype=torch.float32,
                          device=worldpos.device)
    lit_acc = torch.zeros_like(total_w)
    texel = spread / res
    for s in range(nslices):
        m = shadowview[s]
        wtexel = 2.0 / (res * torch.linalg.norm(m[0, :3]))
        bias = 2.0 * wtexel * torch.linalg.norm(m[2, :3]) + 1e-5
        pos = worldpos if normal is None else worldpos + normal * (1.5 * wtexel)
        clip = pos @ m[:3, :3].T + m[:3, 3]
        u = clip[..., 0] * 0.5 + 0.5
        v = clip[..., 1] * 0.5 + 0.5
        ref = clip[..., 2]
        inside = (u > 0) & (u < 1) & (v > 0) & (v < 1) & (ref > 0) & (ref < 1)
        lit = torch.zeros_like(total_w)
        for k in range(POISSON.shape[0]):
            su = texel_index((u + float(POISSON[k, 0] * texel)) * res, res)
            sv = texel_index((v + float(POISSON[k, 1] * texel)) * res, res)
            # reverse-Z: an occluder nearer to the light stores more
            lit = lit + (shadowmaps[s, sv, su] <= ref + bias).to(torch.float32)
        lit = lit / POISSON.shape[0]
        w_s = weights[..., s] * inside.to(torch.float32)
        lit_acc = lit_acc + w_s * lit
        total_w = total_w + w_s
    return torch.where(total_w > 1e-6, lit_acc / torch.clamp(total_w, min=1e-6),
                       torch.ones_like(total_w))
