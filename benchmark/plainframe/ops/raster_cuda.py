"""K1 and K6: the fused visibility raster + attribute interpolation,
plain, in one phase (K1) or two (K6).

Counterpart of datum_tpu/ops/raster_pallas.py (`raster_shade_pallas`
with planes_2d=True and the extended tangent/material-map planes,
alpha_in_alb, peel_depth and early_z; its Pallas bodies
`_raster_shade_kernel` and, with two_phase=True,
`_raster_shade_kernel_2p` become csrc/raster_shade.cu and
csrc/raster_shade_2p.cu).

`raster_shade` builds the per-triangle 64-float attribute rows (the row
build of `pack_tile_setup_attrs`), then runs the plain PyTorch version
(`raster_shade_reference`, `raster_shade_2p_reference`) on every device:
this copy launches no kernel.  The plain versions are the contract the
port's kernels are held to.  K6 gives
K1's planes bit for bit: its second phase evaluates, from the winning
slot's row, the same arithmetic K1's epilogue does.

Both walk every tile's entries in order — the big list, then the bin —
keeping per pixel the depth and the id of the last entry that passed
the strict reverse-Z test, and evaluate the winner's planes once after
the walk.  The Pallas kernel carries all 23 planes through the walk
instead; the carried values are the winner's values at the pixel, so
the two give the same planes.  Every plane a*xn + b*yn + c (edges,
depth, numerator planes) is evaluated as fma(a, xn, b*yn) + c, as XLA
compiles the JAX kernel's expression (see `_plane`).

The lit translucent layer (render/frame.py) passes alpha_in_alb (the
material alpha rides the albedo-id slot 41) and, from its second layer
on, peel_depth: a fragment then passes only if it is strictly farther
than the previous layer's depth (d < peel).

K1 and K6 split each tile's walk over a cluster of 4 blocks (2 where
the frame has at least twice as many tiles as the card has SMs and
shallow bins): block r walks the slots r (mod 4) of the tile's sequence
and carries its partial (depth, walk slot); the combine takes the
largest depth and, among equal ones, the smallest slot, which is the
sequential walk's winner (`split_walk` is that walk in plain PyTorch,
built from `walk_step`, the plain versions' step).  K6's blocks then run
its second phase on the rows each combined.  Each warp skips the
entries one of whose edges is below 0 on its 32 x 16 rectangle
(`raster_depth_cuda.warp_rect_reject` with scissor=False: K1 reads no y
scissor).  None of it moves a value (csrc/raster_shade.cu,
csrc/raster_shade_2p.cu).

Early-z (raster_early_z): the kernels also take `szb` (early_z_bounds),
per tile and walk slot an upper bound on the depth of every fragment of
that slot and the slots after it.  A walk may stop once a pixel's depth
reaches the bound of everything left: the depth test is strict (d >
depth), so no remaining entry can win and the planes are the same bit
for bit.  The plain versions walk every entry; they are the contract
with and without the exit.

Band mode (the tile-sharded frame, parallel/sharded.py): `tile0`, a
multiple of tiles_x, names the frame tile of the bins' first row; the
bins, counts, szb and peel hold the band's whole tile rows only, the
pixel centres come from the global tile rows (width and height stay the
viewport's), and the planes are band-sized.  The JAX kernel takes a
table of tile ids; a band is always tile0 + arange, so its first tile is
all the kernels need.
"""

from __future__ import annotations


import numpy as np
import torch

from .common import TILE_H, TILE_W, fma
from .raster import _untile, check_band, tile_image

ROW = 64              # floats per triangle row
N_PLANES = 22
PLANE_NAMES = ("depth", "visf", "u", "v", "nx", "ny", "nz", "cr", "cg", "cb",
               "em", "met", "rgh", "rfl", "alb", "mbase", "msize", "tanx",
               "tany", "tanz", "tanw", "absorb")
# row slot of each plane: (o,) = the numerator plane a*xn + b*yn + c from
# slots o..o+2, divided by the winner's s after the walk; int = a
# per-triangle constant slot; depth and visf come from the walk itself
_PLANE_SLOTS = (None, None, (16,), (19,), (22,), (25,), (28,), 34, 35, 36, 37,
                38, 39, 40, 41, 42, 43, (44,), (47,), (50,), 53, 56)


def _plane(a, b, c, xn, yn):
    """a*xn + b*yn + c as XLA compiles it: fma(a, xn, b*yn) + c."""
    return fma(a, xn, b * yn) + c


def tri_attr_rows(setup, tris, uv, normal, tri_material, materials, tangent,
                  alpha_in_alb=False):
    """(T, 64) per-triangle rows: [adj*sgn 0-8, zs 9-11, valid 12, id 13
    (the entry's id, set by the walk), y scissor 14-15 (unused), uv +
    normal numerator coeffs 16-30, material 34-41, matmap base/size
    42-43, tangent coeffs 44-52, tangent w 53, absorb 56].  With
    alpha_in_alb, slot 41 (albedo id, which the mip path never reads)
    holds the material alpha instead.

    Interpolated attributes ship as numerator plane coefficients:
    attr = (X*xn + Y*yn + Z) / s with s = e0+e1+e2."""
    row16 = setup["row16"]
    T = row16.shape[0]
    adj = row16[:, :9].reshape(T, 3, 3)

    def num_coef_batch(vA):
        """(T, 3, A) vertex attrs -> (T, A*3) numerator coeffs
        (attr-major): out[t, a, c] = sum_k adj[t, k, c] * vA[t, k, a]."""
        A = vA.shape[2]
        prod = vA[:, :, :, None] * adj[:, :, None, :]      # (T, 3, A, 3)
        return (prod[:, 0] + prod[:, 1] + prod[:, 2]).reshape(T, A * 3)

    t = tris.long()
    uvn_t = num_coef_batch(torch.cat([uv[t], normal[t]], -1))   # (T, 15)
    pk = materials.get("packed10")
    if pk is None:
        raise ValueError("raster_shade needs materials['packed10'] (the "
                         "combined material rows RenderContext builds)")
    rows10 = pk[tri_material.long()]
    if alpha_in_alb:
        rows10 = torch.cat([rows10[:, :7],
                            materials["color"][tri_material.long(), 3:4],
                            rows10[:, 8:]], -1)
    t_v = tangent[t]                                             # (T, 3, 4)
    zeros = lambda n: torch.zeros((T, n), dtype=row16.dtype, device=row16.device)
    t_t = torch.cat([num_coef_batch(t_v[..., :3]), t_v[:, 0, 3:4], zeros(2)], -1)
    return torch.cat([row16, uvn_t, zeros(3), rows10[:, 0:8], rows10[:, 8:10],
                      t_t, rows10[:, 10:11], zeros(ROW - 57)], -1).contiguous()


def _entry_ids(bins, big_ids):
    """(n_tiles, B+K) entry-id table in walk order (big first)."""
    return torch.cat([big_ids[None, :].expand(bins.shape[0], big_ids.shape[0]),
                      bins], dim=1)


def _ndc_scale(n: int) -> float:
    """2/n rounded to f32, as the JAX kernel's weakly-typed constant."""
    return float(np.float32(2.0 / n))


def early_z_bounds(rows, bins, big_ids, tiles_x, width, height, tile0=0):
    """The kernels' early-z bounds `szb`: (n_tiles, B+K) f32, per tile and
    walk slot the max, over that slot and every later one, of the
    entry's depth plane a*xn + b*yn + c (row slots 9-11) over the tile's
    pixel centres, plus a rounding margin; 0 for empty slots and invalid
    rows (slot 12), which never pass.  A plane is affine, so its max over
    the tile is at a corner pixel; it is taken in f64 at the kernels' f32
    corner coordinates, and the margin 1e-6 * (|a| + |b| + |c|) exceeds
    the ~3 ulps by which the kernels' f32 plane can exceed the exact one.
    So once a pixel's depth reaches szb[t, k], no entry from slot k on can
    pass the strict test d > depth: the walk may end there.  Unlike the
    TPU's bound (the triangle's largest vertex z/w), this holds for
    zero-area triangles too, whose planes are rounding noise.  tile0: the
    frame tile of the bins' first row (band mode)."""
    n_tiles = bins.shape[0]
    ids = _entry_ids(bins, big_ids).long()
    r = rows[torch.clamp(ids, min=0), 9:13]                    # (n, E, 4)
    az, bz, cz = (r[..., j].double() for j in range(3))
    tile = torch.arange(n_tiles, device=rows.device) + tile0

    def ndc(origin, pix, scale):
        # the kernels' pixel-centre coordinate, in f32: (origin + pix + 0.5) * scale - 1
        return (((origin.to(torch.float32) + pix) + 0.5) * scale - 1.0).double()[:, None]

    xs = [ndc((tile % tiles_x) * TILE_W, c, _ndc_scale(width)) for c in (0, TILE_W - 1)]
    ys = [ndc((tile // tiles_x) * TILE_H, c, _ndc_scale(height)) for c in (0, TILE_H - 1)]
    dmax = torch.stack([az * x + bz * y + cz for x in xs for y in ys]).amax(0)
    bound = torch.clamp(dmax + 1e-6 * (az.abs() + bz.abs() + cz.abs()), max=1.0)
    bound = torch.where((ids >= 0) & (r[..., 3] > 0), bound, torch.zeros_like(bound))
    # the max over later slots (NaN planes give NaN bounds, never reached)
    return torch.flip(torch.cummax(torch.flip(bound, [1]), 1).values, [1]).float().contiguous()


def _tile_ndc(n_tiles, tiles_x, width, height, device, tile0=0):
    """The kernels' pixel centres of the tiles tile0 .. tile0 + n_tiles -
    1: xn (n, 1, 128) and yn (n, 32, 1) f32, (origin + pixel + 0.5) *
    (2/size) - 1."""
    tile = torch.arange(n_tiles, device=device) + tile0
    ty = (tile // tiles_x).to(torch.float32)[:, None, None]
    tx = (tile % tiles_x).to(torch.float32)[:, None, None]
    yy = torch.arange(TILE_H, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(TILE_W, device=device, dtype=torch.float32)[None, None, :]
    return ((tx * TILE_W + xx + 0.5) * _ndc_scale(width) - 1.0,
            (ty * TILE_H + yy + 0.5) * _ndc_scale(height) - 1.0)


def walk_step(rows, idk, xn, yn, depth, peel_t=None):
    """One slot of the K1/K6 walk for every tile: the entries idk (n,)
    (-1: none) at every pixel of their tile.  Returns (passed, d): the
    inside test, d > depth, d <= 1 and, with peel_t (n, 32, 128), d <
    peel_t."""
    r = (rows[torch.clamp(idk, min=0).long(), :13]
         * (idk >= 0)[:, None].to(rows.dtype))[:, :, None, None]
    e0 = _plane(r[:, 0], r[:, 1], r[:, 2], xn, yn)
    e1 = _plane(r[:, 3], r[:, 4], r[:, 5], xn, yn)
    e2 = _plane(r[:, 6], r[:, 7], r[:, 8], xn, yn)
    s = e0 + e1 + e2
    inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (s > 0) & (r[:, 12] > 0)
    d = _plane(r[:, 9], r[:, 10], r[:, 11], xn, yn)
    passed = inside & (d > depth) & (d <= 1.0)
    if peel_t is not None:
        passed = passed & (d < peel_t)
    return passed, d


NO_SLOT = 2 ** 31 - 1    # the kernels' slot where no entry passed
WALK_CHUNK = 64          # entries a block stages a round


def split_walk(rows, ids, tiles_x, width, height, split, peel=None, szb=None,
               step=walk_step, tile0=0):
    """The split walk of K1, K5, K6 and K7 in plain PyTorch: (depth, slot),
    each (n_tiles, 32, 128), slot NO_SLOT where no entry passes.  Block r
    walks the slots r, r + split, .. of ids (n_tiles, E) in chunks of
    WALK_CHUNK; with szb each thread (one column, 16 rows) stops at the
    first slot g whose szb[:, g] its partial min depth, refreshed once a
    chunk, reaches.  The blocks' partials combine to the largest depth
    and, among equal ones, the smallest slot.  step(rows, idk, xn, yn,
    depth, peel_t) -> (passed, d) is one slot of the walk (K7's:
    raster_mxu_cuda.mxu_walk_step; K5's: raster_v1_cuda.raster_v1_walk_step).
    tile0: the frame tile of ids' first row (band mode)."""
    n_tiles, E = ids.shape
    xn, yn = _tile_ndc(n_tiles, tiles_x, width, height, rows.device, tile0)
    peel_t = None if peel is None else tile_image(peel, tiles_x, n_tiles // tiles_x)
    best = torch.zeros((n_tiles, TILE_H, TILE_W), device=rows.device)
    best_g = torch.full_like(best, NO_SLOT, dtype=torch.int64)
    for r in range(split):
        mine = list(range(r, E, split))
        depth = torch.zeros_like(best)
        slot = torch.full_like(best_g, NO_SLOT)
        tmin = torch.zeros((n_tiles, 2, TILE_W), device=rows.device)   # per thread
        done = torch.zeros((n_tiles, 2, TILE_W), dtype=torch.bool, device=rows.device)
        for c0 in range(0, len(mine), WALK_CHUNK):
            for g in mine[c0:c0 + WALK_CHUNK]:
                if szb is not None:
                    done |= tmin >= szb[:, g, None, None]
                passed, d = step(rows, ids[:, g], xn, yn, depth, peel_t)
                passed &= ~done.repeat_interleave(TILE_H // 2, 1)
                depth = torch.where(passed, d, depth)
                slot = torch.where(passed, torch.full_like(slot, g), slot)
            tmin = depth.reshape(n_tiles, 2, TILE_H // 2, TILE_W).amin(2)
        better = (depth > best) | ((depth == best) & (slot < best_g))
        best = torch.where(better, depth, best)
        best_g = torch.where(better, slot, best_g)
    return best, best_g


def raster_shade_reference(rows, bins, counts, big_ids, tiles_x, width, height,
                           peel=None, szb=None, tile0=0):
    """Plain PyTorch K1: (22, tiles_y*32, tiles_x*128) f32 planes.  It
    walks every bin slot: slots past a tile's count hold -1 (`counts`
    only bounds the kernel's walk).  peel: optional (tiles_y*32,
    tiles_x*128) f32 depth; only fragments with d < peel pass.  szb (the
    early-z bounds) is not read: the full walk gives the planes the
    kernel's early exit gives.  tile0: the frame tile of the bins' first
    row (band mode: the planes are the band's)."""
    dev = rows.device
    n_tiles = bins.shape[0]
    ids = _entry_ids(bins, big_ids)
    xn, yn = _tile_ndc(n_tiles, tiles_x, width, height, dev, tile0)
    depth = torch.zeros((n_tiles, TILE_H, TILE_W), device=dev)
    win = torch.full((n_tiles, TILE_H, TILE_W), -1, dtype=torch.int32,
                     device=dev)
    peel_t = None if peel is None else tile_image(peel, tiles_x,
                                                  n_tiles // tiles_x)
    # entries beyond a tile's count are -1 in bins: zero rows never pass
    for k in range(ids.shape[1]):
        idk = ids[:, k]
        passed, d = walk_step(rows, idk, xn, yn, depth, peel_t)
        depth = torch.where(passed, d, depth)
        win = torch.where(passed, idk[:, None, None], win)

    has = win >= 0
    r = rows[torch.clamp(win, min=0).long()]                 # (n, 32, 128, 64)
    planes = _winner_planes(r, depth, has, win.to(torch.float32), xn, yn)
    tiles_y = n_tiles // tiles_x
    return torch.stack([_untile(p, tiles_x, tiles_y) for p in planes])


def _winner_planes(r, depth, has, visf, xn, yn):
    """The 22 planes from each pixel's winning row r (..., 64): the
    numerator planes divided by the winner's s, one divide a pixel (K1's
    epilogue and K6's second phase)."""
    def lin(o):
        return _plane(r[..., o], r[..., o + 1], r[..., o + 2], xn, yn)

    s = lin(0) + lin(3) + lin(6)
    rcp = 1.0 / torch.where(s == 0.0, torch.ones_like(s), s)
    zero = torch.zeros_like(depth)
    planes = [depth, torch.where(has, visf, zero - 1.0)]
    for j in range(2, N_PLANES):
        slot = _PLANE_SLOTS[j]
        v = lin(slot[0]) * rcp if isinstance(slot, tuple) else r[..., slot]
        planes.append(torch.where(has, v, zero))
    return planes


def raster_shade_2p_reference(rows, bins, counts, big_ids, tiles_x, width,
                              height, peel=None, szb=None, tile0=0):
    """Plain PyTorch K6, in its two phases: the walk carries (depth, the
    winning slot — the entry's index in walk order); each tile flags the
    slots that won a pixel and compacts them (a prefix sum), stages the
    won rows, and every pixel evaluates its planes from its slot's staged
    row.  The same contract and planes as raster_shade_reference (szb is
    not read)."""
    dev = rows.device
    n_tiles = bins.shape[0]
    ids = _entry_ids(bins, big_ids)
    E = ids.shape[1]
    tile = torch.arange(n_tiles, device=dev)
    xn, yn = _tile_ndc(n_tiles, tiles_x, width, height, dev, tile0)

    # ---- phase 1: depth + winning slot
    depth = torch.zeros((n_tiles, TILE_H, TILE_W), device=dev)
    slot = torch.full((n_tiles, TILE_H, TILE_W), -1, dtype=torch.int64, device=dev)
    peel_t = None if peel is None else tile_image(peel, tiles_x, n_tiles // tiles_x)
    for k in range(E):
        passed, d = walk_step(rows, ids[:, k], xn, yn, depth, peel_t)
        depth = torch.where(passed, d, depth)
        slot = torch.where(passed, torch.full_like(slot, k), slot)

    # ---- between the phases: flag the won slots and compact them
    has = slot >= 0
    flat = slot.reshape(n_tiles, -1)
    won = torch.zeros((n_tiles, E + 1), dtype=torch.int64, device=dev)
    won.scatter_(1, torch.where(flat >= 0, flat, E), 1)      # column E: no winner
    won = won[:, :E]
    pos = torch.cumsum(won, 1) - 1                           # compacted index
    n_won = int(won.sum(1).max()) if n_tiles else 0
    staged = torch.zeros((n_tiles, max(n_won, 1), ROW), dtype=rows.dtype, device=dev)
    t_idx, e_idx = torch.nonzero(won, as_tuple=True)
    staged[t_idx, pos[t_idx, e_idx]] = rows[ids[t_idx, e_idx].long()]

    # ---- phase 2: each pixel's planes from its slot's staged row
    k = torch.gather(pos, 1, torch.clamp(flat, min=0)).reshape(slot.shape)
    r = staged[tile[:, None, None], torch.clamp(k, min=0)]   # (n, 32, 128, 64)
    visf = torch.gather(ids, 1, torch.clamp(flat, min=0)).reshape(slot.shape)
    planes = _winner_planes(r, depth, has, visf.to(torch.float32), xn, yn)
    tiles_y = n_tiles // tiles_x
    return torch.stack([_untile(p, tiles_x, tiles_y) for p in planes])


def raster_inputs(setup, bins, big_ids, counts, tris, uv, normal,
                  tri_material, materials, tiles_x, width, height, tangent,
                  alpha_in_alb=False, peel_depth=None, early_z=False, tile0=0):
    """The K1 arguments both versions take, from the frame's tensors
    (szb, the early-z bounds, with early_z; tile0 in band mode)."""
    rows = tri_attr_rows(setup, tris, uv, normal, tri_material, materials, tangent,
                         alpha_in_alb)
    return dict(rows=rows,
                bins=bins.to(torch.int32).contiguous(),
                counts=counts.to(torch.int32).contiguous(),
                big_ids=big_ids.to(torch.int32).contiguous(),
                tiles_x=tiles_x, width=width, height=height,
                peel=None if peel_depth is None else peel_depth.contiguous(),
                szb=(early_z_bounds(rows, bins, big_ids, tiles_x, width, height, tile0)
                     if early_z else None),
                tile0=tile0)


def raster_shade(setup, bins, big_ids, counts, tris, uv, normal, tri_material,
                 materials, tiles_x, tiles_y, width, height, *, tangent,
                 alpha_in_alb=False, peel_depth=None, two_phase=False,
                 early_z=False, tile0=0):
    """Fused raster + attribute/material interpolation.

    Returns a dict of the 22 (tiles_y*32, tiles_x*128) f32 planes named
    as raster_shade_pallas(planes_2d=True) with tangent/matmaps names
    them.  alpha_in_alb puts the material alpha in the "alb" plane;
    peel_depth (tiles_y*32, tiles_x*128) keeps only fragments strictly
    farther than it.  two_phase runs K6 instead of K1 (the same planes).
    early_z lets the kernel end its walk early (the same planes).  Band
    mode: bins (and peel_depth) hold the tile rows from the frame tile
    tile0 on, and the planes are theirs.  Runs the plain PyTorch version
    on every device."""
    check_band(bins.shape[0], tiles_x, tile0, tiles_y)
    inp = raster_inputs(setup, bins, big_ids, counts, tris, uv, normal,
                        tri_material, materials, tiles_x, width, height, tangent,
                        alpha_in_alb, peel_depth, early_z, tile0)
    fn = raster_shade_2p_reference if two_phase else raster_shade_reference
    return dict(zip(PLANE_NAMES, fn(**inp).unbind(0)))
