"""K7: the matmul raster + attribute interpolation, plain.

Counterpart of datum_tpu/ops/raster_pallas.py (`raster_shade_mxu`; its
Pallas body `_v3_kernel` / `_v3_half` becomes csrc/raster_mxu.cu).  The
frame runs it for `raster_kernel="mxu"` with material maps off.

The TPU kernel takes a tile as two 16-row halves and walks its entries
in chunks of 128: one (24 x 128)^T x (24 x 6*2048) product gives every
(entry, pixel) pair's three edges e0..e2, its depth d and two scissor
planes e3 = yn - ylo, e4 = yhi - yn; the chunk's largest passing d wins
(ties go to the lowest row), a later chunk must beat it strictly, and a
one-hot product fetches the winner's 32 attribute values.  That is a
sequential walk with a strict depth test: the first entry in walk order
that reaches the largest passing depth wins.  Both versions here walk
each pixel's entries so, and evaluate the six planes of an entry
directly (no product, no library call).  The kernel splits each tile's
walk over a cluster of 2 or 4 blocks carrying (depth, walk slot), as K1
does (`raster_cuda.split_walk` with `mxu_walk_step` is that walk in
plain PyTorch), and each warp skips the entries one of whose edges is
below 0 on its 32 x 16 rectangle, in K7's rounding form
(`raster_depth_cuda.warp_rect_reject(..., scissor=False, form="dot")`).
Neither moves a value (csrc/raster_mxu.cu).

What makes K7 differ from K1, and is kept:
- no valid flag: every big slot (valid or not) and the bin entries are
  walked; empty slots are zero rows, which fail s > 0;
- the scissor as e3 >= 0 and e4 > 0 with pack_v3's default ylim of
  [-8, 8] (the frame's setup carries none);
- the depth plane is `ops/raster.py::depth_plane_coefs` (products, then
  summed), not row16's zs;
- the rounding of the 24-term contraction: XLA:CPU's dot accumulates
  the terms in order with fused multiply-adds from 0, and the zero
  terms add exact zeros, so each plane is fma(b, yn, a*xn) + c (not
  K1's fma(a, xn, b*yn) + c);
- barycentrics l0 = e0 * inv_s, l1 = e1 * inv_s, l2 = (1 - l0) - l1
  with inv_s = 1 / where(s == 0, 1, s), and every attribute as
  WA0*l0 + WA2*l1 + WA4*l2, which XLA contracts to
  fma(WA4, l2, fma(WA0, l0, WA2*l1)) (not K1's numerator planes over s);
- the material values of `materials[...]` as pack_v3 gathers them, the
  albedo id rounded.

The per-triangle rows (ROW floats): [adj*sgn 0-8, depth plane 9-11,
ylo 12, yhi 13, 0 14-15, vertex uv 16-21, vertex normals 22-30, 0 31,
colour rgb 32-34, emissive 35, metalness 36, roughness 37, reflectivity
38, albedo id 39].
"""

from __future__ import annotations


import torch

from .common import TILE_H, TILE_W, fma
from .raster import _untile, depth_plane_coefs
from .raster_cuda import _entry_ids, _tile_ndc

ROW = 40              # floats per triangle row
N_PLANES = 15
PLANE_NAMES = ("depth", "visf", "u", "v", "nx", "ny", "nz", "cr", "cg", "cb",
               "em", "met", "rgh", "rfl", "alb")
YLIM = (-8.0, 8.0)    # pack_v3's scissor when the setup carries none


def mxu_rows(setup, tris, uv, normal, tri_material, materials):
    """(T, 40) per-triangle rows of K7 (pack_v3's coefficient and
    attribute rows, transposed back to one row a triangle)."""
    adj, det = setup["adj"], setup["det"]
    T = adj.shape[0]
    t = tris.long()
    m = tri_material.long()
    f32 = dict(dtype=torch.float32, device=adj.device)
    col = lambda x: x[:, None].to(torch.float32)
    return torch.cat([
        (adj * torch.sign(det)[:, None, None]).reshape(T, 9),
        depth_plane_coefs(setup),
        torch.tensor(YLIM, **f32).expand(T, 2), torch.zeros((T, 2), **f32),
        uv[t].reshape(T, 6), normal[t].reshape(T, 9), torch.zeros((T, 1), **f32),
        materials["color"][m][:, :3], col(materials["emissive"][m]),
        col(materials["metalness"][m]), col(materials["roughness"][m]),
        col(materials["reflectivity"][m]), col(materials["albedomap"][m]),
    ], -1).contiguous()


def _dot_plane(a, b, c, xn, yn):
    """One column of the TPU kernel's coefficient product as XLA:CPU
    computes it: the terms in order with fused multiply-adds from 0
    (the zero terms add exact zeros), fma(b, yn, a*xn) + c."""
    return fma(b, yn, a * xn) + c


def _lerp3(r, o, step, l0, l1, l2):
    """r[o]*l0 + r[o+step]*l1 + r[o+2*step]*l2 as XLA contracts it."""
    return fma(r[..., o + 2 * step], l2, fma(r[..., o], l0, r[..., o + step] * l1))


def mxu_walk_step(rows, idk, xn, yn, depth, peel_t=None):
    """One slot of the K7 walk for every tile: the entries idk (n,) (-1:
    none, a zero row) at every pixel of their tile.  Returns (passed, d):
    the inside test with the scissor planes, d > depth and d <= 1.  K7
    takes no peel plane: peel_t (split_walk's step signature) is None."""
    r = (rows[torch.clamp(idk, min=0).long(), :14]
         * (idk >= 0)[:, None].to(rows.dtype))[:, :, None, None]
    e0 = _dot_plane(r[:, 0], r[:, 1], r[:, 2], xn, yn)
    e1 = _dot_plane(r[:, 3], r[:, 4], r[:, 5], xn, yn)
    e2 = _dot_plane(r[:, 6], r[:, 7], r[:, 8], xn, yn)
    d = _dot_plane(r[:, 9], r[:, 10], r[:, 11], xn, yn)
    s = e0 + e1 + e2
    inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (s > 0)
              & (yn - r[:, 12] >= 0) & (r[:, 13] - yn > 0))
    return inside & (d > depth) & (d <= 1.0), d


def raster_mxu_reference(rows, bins, counts, big_ids, tiles_x, width, height):
    """Plain PyTorch K7: (15, tiles_y*32, tiles_x*128) f32 planes (see
    PLANE_NAMES; visf and alb are the winner's id and albedo id as f32,
    visf -1 where uncovered).  It walks every slot (slots past a tile's
    count hold -1, zero rows)."""
    dev = rows.device
    n_tiles = bins.shape[0]
    ids = _entry_ids(bins, big_ids)
    xn, yn = _tile_ndc(n_tiles, tiles_x, width, height, dev)
    depth = torch.zeros((n_tiles, TILE_H, TILE_W), device=dev)
    win = torch.full((n_tiles, TILE_H, TILE_W), -1, dtype=torch.int32, device=dev)
    for k in range(ids.shape[1]):
        idk = ids[:, k]
        passed, d = mxu_walk_step(rows, idk, xn, yn, depth)
        depth = torch.where(passed, d, depth)
        win = torch.where(passed, idk[:, None, None], win)
    tiles_y = n_tiles // tiles_x
    return torch.stack([_untile(p, tiles_x, tiles_y)
                        for p in mxu_planes(rows, win, depth, xn, yn)])


def mxu_planes(rows, win, depth, xn, yn):
    """K7's epilogue: the 15 tiled planes (each (n, 32, 128)) from each
    pixel's winning id win (-1: none) and depth, at the pixel centres
    xn, yn."""
    has = win >= 0
    r = rows[torch.clamp(win, min=0).long()]                  # (n, 32, 128, 40)
    e0 = _dot_plane(r[..., 0], r[..., 1], r[..., 2], xn, yn)
    e1 = _dot_plane(r[..., 3], r[..., 4], r[..., 5], xn, yn)
    e2 = _dot_plane(r[..., 6], r[..., 7], r[..., 8], xn, yn)
    s = e0 + e1 + e2
    inv_s = 1.0 / torch.where(s == 0.0, torch.ones_like(s), s)
    l0 = e0 * inv_s
    l1 = e1 * inv_s
    l2 = 1.0 - l0 - l1
    zero = torch.zeros_like(depth)
    vals = [depth, win.to(torch.float32),
            _lerp3(r, 16, 2, l0, l1, l2), _lerp3(r, 17, 2, l0, l1, l2),
            _lerp3(r, 22, 3, l0, l1, l2), _lerp3(r, 23, 3, l0, l1, l2),
            _lerp3(r, 24, 3, l0, l1, l2)] + [r[..., 32 + j] for j in range(8)]
    planes = [depth, torch.where(has, vals[1], zero - 1.0)]
    return planes + [torch.where(has, v, zero) for v in vals[2:]]


def raster_mxu_inputs(setup, bins, big_ids, counts, tris, uv, normal,
                      tri_material, materials, tiles_x, width, height):
    """The K7 arguments both versions take, from the frame's tensors."""
    return dict(rows=mxu_rows(setup, tris, uv, normal, tri_material, materials),
                bins=bins.to(torch.int32).contiguous(),
                counts=counts.to(torch.int32).contiguous(),
                big_ids=big_ids.to(torch.int32).contiguous(),
                tiles_x=tiles_x, width=width, height=height)


def raster_shade_mxu(setup, bins, big_ids, counts, tris, uv, normal,
                     tri_material, materials, tiles_x, tiles_y, width, height):
    """The matmul raster, raster_shade_mxu's contract: dict(depth, vis
    int32, uv (H, W, 2), normal (H, W, 3), color (H, W, 3), emissive,
    metalness, roughness, reflectivity, albedo_id int32).  Runs the plain
    PyTorch version on every device."""
    if bins.shape[0] != tiles_x * tiles_y:
        raise ValueError(f"bins has {bins.shape[0]} rows for "
                         f"{tiles_x}x{tiles_y} tiles")
    inp = raster_mxu_inputs(setup, bins, big_ids, counts, tris, uv, normal,
                            tri_material, materials, tiles_x, width, height)
    fn = raster_mxu_reference
    u = fn(**inp).unbind(0)
    return dict(depth=u[0], vis=torch.round(u[1]).to(torch.int32),
                uv=torch.stack([u[2], u[3]], -1),
                normal=torch.stack([u[4], u[5], u[6]], -1),
                color=torch.stack([u[7], u[8], u[9]], -1),
                emissive=u[10], metalness=u[11], roughness=u[12],
                reflectivity=u[13], albedo_id=torch.round(u[14]).to(torch.int32))
