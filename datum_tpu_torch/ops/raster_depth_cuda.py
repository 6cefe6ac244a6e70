"""K3: the depth-only shadow raster on the card.

Counterpart of datum_tpu/ops/raster_pallas.py (`raster_depth_pallas`,
with early_z; its Pallas body `_depth_kernel` becomes
csrc/raster_depth.cu).  It renders the stacked sun-cascade atlases and
the stacked parabolic spot maps (ops/shadow.py).

`raster_depth` runs the CUDA kernel for CUDA tensors
(`raster_depth_cuda`) or the plain PyTorch version for CPU tensors
(`raster_depth_reference`).  Both walk every tile's entries — the big
list, then the bin — and keep per pixel the largest depth d that passes
the inside test, the y scissor and d > depth, d <= 1.  A max under a
strict test does not depend on the walk order.  Each plane a*xn + b*yn
+ c is evaluated as fma(a, xn, b*yn) + c: that is how XLA compiles the
JAX kernel's expression (bit-equal to its interpret runs), the kernel
writes the fma explicitly, and so the kernel is bit-equal to the plain
version.  The TPU lane packing (DEPTH_PACK, DEPTH_TILES_PER_STEP) moves no
value and is not carried over.  With early_z the kernel takes the
early-z bounds `szb` (ops/raster_cuda.early_z_bounds) and ends its walk
early (the same depths); the plain version walks every entry.

The kernel splits each tile's walk over a cluster of 8 blocks (4 on a
stack of at least twice as many tiles as the card has SMs) and combines
their partial maps by a max, and each warp skips the entries
that `warp_rect_reject` (its plain twin here, with the same arithmetic)
finds cannot pass on the warp's 32 x 16 rectangle; neither moves a
value (csrc/raster_depth.cu derives the reject's margin).  K5 takes the
same test with the scissor; K1 and K4 take its edge test without it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _kernels
from .common import TILE_H, TILE_W
from .raster import _untile
from .raster_cuda import _entry_ids, _ndc_scale, _plane, _tile_ndc, early_z_bounds
from .raster_mxu_cuda import _dot_plane

ROW = 16              # floats per triangle row (the setup's row16)
WARP_W, WARP_H = 32, 16          # a K3 warp's rectangle: columns x rows
REJECT_REL = 2.0 ** -21          # the reject margin: fl(S) * 8u + 1e-36
REJECT_ABS = float(np.float32(1e-36))


def raster_depth_reference(rows, bins, counts, big_ids, tiles_x, width, height,
                           szb=None):
    """Plain PyTorch K3: (tiles_y*32, tiles_x*128) f32 reverse-Z depth.
    It walks every bin slot: slots past a tile's count hold -1, whose
    zero rows never pass.  szb (the early-z bounds) is not read."""
    dev = rows.device
    n_tiles = bins.shape[0]
    ids = _entry_ids(bins, big_ids)
    xn, yn = _tile_ndc(n_tiles, tiles_x, width, height, dev)

    depth = torch.zeros((n_tiles, TILE_H, TILE_W), device=dev)
    for k in range(ids.shape[1]):
        idk = ids[:, k]
        r = (rows[torch.clamp(idk, min=0).long()]
             * (idk >= 0)[:, None].to(rows.dtype))[:, :, None, None]
        e0 = _plane(r[:, 0], r[:, 1], r[:, 2], xn, yn)
        e1 = _plane(r[:, 3], r[:, 4], r[:, 5], xn, yn)
        e2 = _plane(r[:, 6], r[:, 7], r[:, 8], xn, yn)
        s = e0 + e1 + e2
        inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (s > 0) & (r[:, 12] > 0)
                  & (yn >= r[:, 14]) & (yn < r[:, 15]))
        d = _plane(r[:, 9], r[:, 10], r[:, 11], xn, yn)
        depth = torch.where(inside & (d > depth) & (d <= 1.0), d, depth)
    return _untile(depth, tiles_x, n_tiles // tiles_x)


def warp_rects(tiles_x, n_tiles, width, height, device="cpu", warp_h=WARP_H):
    """The warps' rectangles of K3 and K1 (32 x 16) or, with warp_h=8,
    K4: (x0, x1, y0, y1), each (n_tiles, 4 * 32 // warp_h) f32, the first
    and last column's xn and the first and last row's yn of warp w = 4 *
    (row band) + (column band) of each tile, computed as the kernels
    compute their pixel centres."""
    tile = torch.arange(n_tiles, device=device)
    w = torch.arange(TILE_H * TILE_W // (WARP_W * warp_h), device=device)
    col0 = ((tile % tiles_x) * TILE_W)[:, None] + (w % 4 * WARP_W)[None, :]
    row0 = ((tile // tiles_x) * TILE_H)[:, None] + (w // 4 * warp_h)[None, :]
    ndc = lambda pix, scale: (pix.to(torch.float32) + 0.5) * scale - 1.0
    cx, cy = _ndc_scale(width), _ndc_scale(height)
    return (ndc(col0, cx), ndc(col0 + WARP_W - 1, cx),
            ndc(row0, cy), ndc(row0 + warp_h - 1, cy))


def warp_rect_reject(r, x0, x1, y0, y1, scissor=True, form="plane"):
    """Plain twin of K3's warp-rectangle reject, with the kernel's
    arithmetic: True where entry row r (..., 16 or more) passes at no
    pixel of the rectangle [x0, x1] x [y0, y1] (f32, broadcast against
    r[..., 0]): its y scissor (slots 14-15) misses the rows, or an edge's
    value at the rectangle's corner where the exact plane is largest, plus
    the margin fl(|a| mx + |b| my + |c|) * 8 * 2^-24 + 1e-36, is below 0.
    scissor=True is K3's and K5's reject; scissor=False is K1's, edges
    only: K1 reads no scissor.  form is the corner value's rounding:
    "plane", fma(a, x, b*y) + c (K3, K1, K5, K6); "dot", fma(b, y, a*x)
    + c (K7, with scissor=False: K7's rows keep the scissor in slots
    12-13, and csrc/raster_mxu.cu derives the margin for that form)."""
    plane = dict(plane=_plane, dot=_dot_plane)[form]
    out = torch.zeros(torch.broadcast_shapes(r[..., 0].shape, x0.shape), dtype=torch.bool,
                      device=r.device)
    if scissor:
        out = (y1 < r[..., 14]) | (y0 >= r[..., 15])
    mx = torch.maximum(x0.abs(), x1.abs())
    my = torch.maximum(y0.abs(), y1.abs())
    for k in range(3):
        a, b, c = r[..., 3 * k], r[..., 3 * k + 1], r[..., 3 * k + 2]
        margin = (a.abs() * mx + b.abs() * my + c.abs()) * REJECT_REL + REJECT_ABS
        corner = plane(a, b, c, torch.where(a > 0, x1, x0), torch.where(b > 0, y1, y0))
        out = out | (corner + margin < 0)
    return out


@_kernels.enroll
def raster_depth_cuda(rows, bins, counts, big_ids, tiles_x, width, height,
                      szb=None):
    """K3 on the card: the same contract as raster_depth_reference; with
    szb (n_tiles, n_big + capacity) it ends its walk early."""
    dev = rows.device
    n_tiles, cap = bins.shape
    if dev.type != "cuda":
        raise ValueError(f"raster_depth_cuda needs CUDA tensors, got {dev}")
    checks = [("rows", rows, torch.float32, (rows.shape[0], ROW)),
              ("bins", bins, torch.int32, (n_tiles, cap)),
              ("counts", counts, torch.int32, (n_tiles,)),
              ("big_ids", big_ids, torch.int32, (big_ids.shape[0],))]
    if szb is not None:
        checks.append(("szb", szb, torch.float32, (n_tiles, big_ids.shape[0] + cap)))
    _kernels.check_tensors("raster_depth_cuda", dev, checks)
    if n_tiles % tiles_x:
        raise ValueError(f"{n_tiles} tiles is not whole rows of {tiles_x}")
    out_h, out_w = (n_tiles // tiles_x) * TILE_H, tiles_x * TILE_W
    out = torch.empty((out_h, out_w), dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    code = _kernels.library().lib.raster_depth_launch(
        vp(rows.data_ptr()), vp(bins.data_ptr()), vp(counts.data_ptr()),
        vp(big_ids.data_ptr()), vp(None if szb is None else szb.data_ptr()),
        big_ids.shape[0], cap, tiles_x, n_tiles,
        _ndc_scale(width), _ndc_scale(height), out_w, vp(out.data_ptr()),
        vp(_kernels.stream_ptr(dev)))
    _kernels.check(code, "raster_depth")
    return out


def depth_inputs(setup, bins, big_ids, counts, tiles_x, width, height,
                 early_z=False):
    """The K3 arguments both versions take, from a stack's setup and bins
    (szb, the early-z bounds, with early_z)."""
    rows = setup["row16"].contiguous()
    return dict(rows=rows,
                bins=bins.to(torch.int32).contiguous(),
                counts=counts.to(torch.int32).contiguous(),
                big_ids=big_ids.to(torch.int32).contiguous(),
                tiles_x=tiles_x, width=width, height=height,
                szb=(early_z_bounds(rows, bins, big_ids, tiles_x, width, height)
                     if early_z else None))


def raster_depth(setup, bins, big_ids, counts, tiles_x, tiles_y, width, height,
                 early_z=False):
    """Depth-only raster (shadow maps).  Returns (tiles_y*32, tiles_x*128)
    f32 reverse-Z depth, 0 where nothing covers a texel.  early_z lets the
    kernel end its walk early (the same map).  CUDA tensors run the K3
    kernel (it raises if it cannot launch); CPU tensors run the plain
    PyTorch version."""
    if bins.shape[0] != tiles_x * tiles_y:
        raise ValueError(f"bins has {bins.shape[0]} rows for "
                         f"{tiles_x}x{tiles_y} tiles")
    inp = depth_inputs(setup, bins, big_ids, counts, tiles_x, width, height,
                       early_z)
    fn = raster_depth_cuda if inp["rows"].is_cuda else raster_depth_reference
    return fn(**inp)
