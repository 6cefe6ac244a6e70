"""K5: the v1 visibility raster, plain.

Counterpart of datum_tpu/ops/raster_pallas.py (`raster_pallas`; its
Pallas body `_raster_kernel` becomes csrc/raster_v1.cu).  The frame runs
it with `use_pallas` when material maps are on and the texture filter
is not a 'mip' one: it gives the deferred resolve (`ops/shade.py::
resolve_gbuffer(lam=)`) depth, the winning triangle id and the two
leading barycentrics.

`raster_v1` takes the setup's per-triangle rows (`row16`: [adj*sgn 0-8,
zs 9-11, valid 12, 0, y scissor 14-15]) and the entry table, then runs
the plain PyTorch version (`raster_v1_reference`) on every device.  The 128-lane row
packing of `pack_tile_setup` moves no value and is not carried over.

Per pixel both walk the tile's entries in order — the big list, then
the tile's bin — and keep the depth and id of the last entry that
passes: all three edges e >= 0, s = e0 + e1 + e2 > 0, the valid flag,
the row scissor ylo <= yn < yhi, and the strict reverse-Z test
d > depth and d <= 1.  Every plane a*xn + b*yn + c is fma(a, xn, b*yn)
+ c, as XLA compiles the JAX kernel; l0 = e0 * inv_s, l1 = e1 * inv_s
with inv_s = 1 / where(s == 0, 1, s), taken from the winner after the
walk (the values the Pallas kernel carries are the winner's, so they
are the same bits).  Unlike the scan raster (`ops/raster.py::raster`),
K5 walks the big list first, accepts one winding only (the rows carry
det's sign) and reads the valid flag and the scissor.

The kernel splits each tile's walk over a cluster of 2 or 4 blocks
carrying (depth, walk slot), as K1 does (`raster_cuda.split_walk` with
`raster_v1_walk_step` is that walk in plain PyTorch), maps the winning
slot to its id after the combine, and each warp skips the entries whose
scissor misses its 32 x 16 rectangle or one of whose edges is below 0
on it (`raster_depth_cuda.warp_rect_reject(..., scissor=True)`, K3's
reject).  Neither moves a value (csrc/raster_v1.cu).
"""

from __future__ import annotations


import torch

from .common import TILE_H, TILE_W
from .raster import _untile
from .raster_cuda import _entry_ids, _plane, _tile_ndc

ROW = 16              # floats per triangle row (the setup's row16)
SPLITS = (2, 4, 8)    # the blocks a tile a caller may force


def raster_v1_walk_step(rows, idk, xn, yn, depth, peel_t=None):
    """One slot of the K5 walk for every tile: the entries idk (n,) (-1:
    none, a zero row) at every pixel of their tile.  Returns (passed, d):
    the inside test, the valid flag, the row scissor ylo <= yn < yhi
    (slots 14-15), d > depth and d <= 1.  K5 takes no peel plane: peel_t
    (split_walk's step signature) is None."""
    r = (rows[torch.clamp(idk, min=0).long()]
         * (idk >= 0)[:, None].to(rows.dtype))[:, :, None, None]
    e0 = _plane(r[:, 0], r[:, 1], r[:, 2], xn, yn)
    e1 = _plane(r[:, 3], r[:, 4], r[:, 5], xn, yn)
    e2 = _plane(r[:, 6], r[:, 7], r[:, 8], xn, yn)
    s = e0 + e1 + e2
    inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (s > 0) & (r[:, 12] > 0)
              & (yn >= r[:, 14]) & (yn < r[:, 15]))
    d = _plane(r[:, 9], r[:, 10], r[:, 11], xn, yn)
    return inside & (d > depth) & (d <= 1.0), d


def v1_planes(rows, win, depth, xn, yn):
    """K5's epilogue: the 4 tiled planes (each (n, 32, 128)) depth, visf,
    l0, l1 from each pixel's winning id win (-1: none) and depth, at the
    pixel centres xn, yn."""
    has = win >= 0
    r = rows[torch.clamp(win, min=0).long()]                  # (n, 32, 128, 16)
    e0 = _plane(r[..., 0], r[..., 1], r[..., 2], xn, yn)
    e1 = _plane(r[..., 3], r[..., 4], r[..., 5], xn, yn)
    e2 = _plane(r[..., 6], r[..., 7], r[..., 8], xn, yn)
    s = e0 + e1 + e2
    inv_s = 1.0 / torch.where(s == 0, torch.ones_like(s), s)
    zero = torch.zeros_like(depth)
    return (depth, torch.where(has, win.to(torch.float32), zero - 1.0),
            torch.where(has, e0 * inv_s, zero), torch.where(has, e1 * inv_s, zero))


def raster_v1_reference(rows, bins, counts, big_ids, tiles_x, width, height):
    """Plain PyTorch K5: (4, tiles_y*32, tiles_x*128) f32 planes depth,
    visf (the winner's id as f32, -1 uncovered), l0, l1.  It walks every
    slot in order: empty slots hold -1 and give zero rows, which never
    pass."""
    dev = rows.device
    n_tiles = bins.shape[0]
    ids = _entry_ids(bins, big_ids)
    xn, yn = _tile_ndc(n_tiles, tiles_x, width, height, dev)
    depth = torch.zeros((n_tiles, TILE_H, TILE_W), device=dev)
    win = torch.full((n_tiles, TILE_H, TILE_W), -1, dtype=torch.int32, device=dev)
    for k in range(ids.shape[1]):
        idk = ids[:, k]
        passed, d = raster_v1_walk_step(rows, idk, xn, yn, depth)
        depth = torch.where(passed, d, depth)
        win = torch.where(passed, idk[:, None, None], win)
    tiles_y = n_tiles // tiles_x
    return torch.stack([_untile(p, tiles_x, tiles_y)
                        for p in v1_planes(rows, win, depth, xn, yn)])


def raster_v1_inputs(setup, bins, big_ids, counts, tiles_x, width, height):
    """The K5 arguments both versions take, from the frame's tensors."""
    return dict(rows=setup["row16"].contiguous(),
                bins=bins.to(torch.int32).contiguous(),
                counts=counts.to(torch.int32).contiguous(),
                big_ids=big_ids.to(torch.int32).contiguous(),
                tiles_x=tiles_x, width=width, height=height)


def raster_v1(setup, bins, big_ids, counts, tiles_x, tiles_y, width, height):
    """The v1 raster, raster_pallas's contract: (depth, vis int32, l0,
    l1), each (tiles_y*32, tiles_x*128).  Runs the plain PyTorch version
    on every device."""
    if bins.shape[0] != tiles_x * tiles_y:
        raise ValueError(f"bins has {bins.shape[0]} rows for "
                         f"{tiles_x}x{tiles_y} tiles")
    inp = raster_v1_inputs(setup, bins, big_ids, counts, tiles_x, width, height)
    fn = raster_v1_reference
    depth, visf, l0, l1 = fn(**inp).unbind(0)
    return depth, torch.round(visf).to(torch.int32), l0, l1
