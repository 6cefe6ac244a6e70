"""K4: the weighted-blend OIT raster, plain.

Counterpart of datum_tpu/ops/raster_pallas.py (`raster_blend_pallas`
with planes=True; its Pallas body `_blend_kernel` becomes
csrc/raster_blend.cu).  It accumulates the frame's merged translucent
stream: the particle billboards (soft, radial falloff) and the
translucent triangles that lie behind the last lit layer (peeled).

`raster_blend` builds the per-triangle 36-float rows (the slots of the
JAX package's `pack_tile_blend`: [adj*sgn 0-8, zs 9-11, valid 12, uv
16-21, rgba 22-33, soft flag 34, peel flag 35]; its 2-per-row lane
packing moves no value and is not carried over), then runs the plain
PyTorch version (`raster_blend_reference`) on every device.

Per pixel both walk the big list, then the tile's bin entries, in
order, and carry five accumulators: ar, ag, ab, aw (start 0) and rv
(start 1).  Per entry: edges and depth at the pixel centre as
fma(a, xn, b*yn) + c (as XLA compiles the JAX kernel's a*xn + b*yn + c);
visible = inside & d > opaque depth & d <= 1 (& d < peel, or in per_tri
mode (d < peel) | peel flag <= 0); barycentrics l0 = e0/s, l1 = e1/s,
l2 = 1 - l0 - l1; rgba interpolated (alpha times the radial falloff of
the uv disc where soft); wgt = clip(10 / (1e-5 + b^3), 0.01, 300) *
alpha with b = (1 - d) * 5; ar += r*wgt, ..., aw += wgt, rv *= 1 - alpha.
The sums and the product are taken in walk order, so the kernel walks
each pixel's entries sequentially, never split (two blocks a tile, one
over each row half).  Each warp skips the entries that `blend_reject`
(its plain twin here, with the same arithmetic) finds to be exact no-ops
on its 32 x 8 rectangle: an edge below 0 on the whole rectangle, s bounded
away from 0 and the coefficients bounded, so that no invisible pixel's
cr * 0 is NaN (csrc/raster_blend.cu derives the bounds).

Rounding: both versions fuse a multiply and an add exactly where XLA's
contraction of the JAX kernel does — the planes, the interpolations
(fma(c, l2, fma(a, l0, b*l1))), the squared radius, 1e-5 + b^3, the
four sums (ar = fma(r, wgt, ar), aw = fma(w, alpha, aw)) and, where
soft, 1 - ca*falloff — and divide 10 / x as a true division; so the
plain version is bit-equal to the JAX kernel in interpret mode in all
three modes (tests/test_torch_translucent.py), and the kernel, which
writes the same fmas with __fmaf_rn, to the plain version.

Band mode (the tile-sharded frame): `tile0`, as K1's (ops/raster_cuda.py):
the bins, counts, opaque depth and peel hold the band's tile rows from
the frame tile tile0 on, the pixel centres are the frame's and the
planes the band's.
"""

from __future__ import annotations


import torch

from .common import TILE_H, TILE_W, fma
from .raster import _untile, check_band, tile_image
from .raster_cuda import _entry_ids, _plane, _tile_ndc
from .raster_depth_cuda import REJECT_ABS, warp_rect_reject

ROW = 36              # floats per triangle row
SOFT_MODES = {False: 0, True: 1, "per_tri": 2}
WARP_H = 8                       # a K4 warp's rectangle: 32 columns x 8 rows
# the reject's bounds on s and the coefficients (csrc/raster_blend.cu)
S_REL = 2.0 ** -20               # s's lower bound: corner - (fl(T) * 16u + 1e-36)
S_MIN = 2.0 ** -100
S_RATIO = 2.0 ** 60
COEF_MAX = 2.0 ** 60
BOUNDED_SLOTS = (9, 10, 11, 22, 23, 24, 26, 27, 28, 30, 31, 32)   # depth; r, g, b


def blend_rows(setup, tris, uv, color, soft_flag=None, peel_flag=None):
    """(T, 36) per-triangle rows (pack_tile_blend's slots).  soft_flag /
    peel_flag: optional (T,) 0/1 flags of a merged stream (slots 34/35)."""
    row16 = setup["row16"]
    T = row16.shape[0]
    t = tris.long()
    zero = torch.zeros((T, 1), dtype=row16.dtype, device=row16.device)
    flag = lambda f: zero if f is None else f[:, None].to(row16.dtype)
    return torch.cat([row16, uv[t].reshape(T, 6), color[t].reshape(T, 12),
                      flag(soft_flag), flag(peel_flag)], -1).contiguous()


def _lerp3(r, o, step, l0, l1, l2):
    """r[o]*l0 + r[o+step]*l1 + r[o+2*step]*l2 as XLA contracts it:
    fma(c, l2, fma(a, l0, b*l1))."""
    return fma(r[..., o + 2 * step], l2,
               fma(r[..., o], l0, r[..., o + step] * l1))


def blend_reject(r, x0, x1, y0, y1):
    """Plain twin of K4's warp-rectangle reject, with the kernel's
    arithmetic: True where entry row r (..., 36) adds an exact no-op at
    every pixel of the rectangle [x0, x1] x [y0, y1] (f32, broadcast
    against r[..., 0]): K3's edge test rejects it there
    (`warp_rect_reject` without the scissor), the summed edge plane's
    lower bound s_lo over the rectangle is at least 2^-100 and at least
    fl(T) / 2^60, and the depth and r, g, b coefficients are at most 2^60
    in magnitude."""
    mx = torch.maximum(x0.abs(), x1.abs())
    my = torch.maximum(y0.abs(), y1.abs())
    t = [r[..., 3 * k].abs() * mx + r[..., 3 * k + 1].abs() * my + r[..., 3 * k + 2].abs()
         for k in range(3)]
    T = t[0] + t[1] + t[2]
    A, B, C = (r[..., j] + r[..., j + 3] + r[..., j + 6] for j in range(3))
    s_lo = (_plane(A, B, C, torch.where(A > 0, x0, x1), torch.where(B > 0, y0, y1))
            - (T * S_REL + REJECT_ABS))
    bounded = (r[..., list(BOUNDED_SLOTS)].abs() <= COEF_MAX).all(-1)
    return (warp_rect_reject(r, x0, x1, y0, y1, scissor=False) & (s_lo >= S_MIN)
            & (T <= S_RATIO * s_lo) & bounded)


def raster_blend_reference(rows, bins, counts, big_ids, opaque_depth, tiles_x,
                           width, height, soft, peel=None, tile0=0):
    """Plain PyTorch K4: (5, tiles_y*32, tiles_x*128) f32 planes ar, ag,
    ab, aw, rv.  It walks every bin slot: slots past a tile's count hold
    -1, whose zero rows add exact zeros.  soft: False, True or "per_tri";
    peel: optional (tiles_y*32, tiles_x*128) f32 depth; tile0: the frame
    tile of the bins' first row (band mode)."""
    mode = SOFT_MODES[soft]
    dev = rows.device
    n_tiles = bins.shape[0]
    tiles_y = n_tiles // tiles_x
    ids = _entry_ids(bins, big_ids)
    xn, yn = _tile_ndc(n_tiles, tiles_x, width, height, dev, tile0)
    od = tile_image(opaque_depth, tiles_x, tiles_y)
    pl = None if peel is None else tile_image(peel, tiles_x, tiles_y)

    zero = torch.zeros((n_tiles, TILE_H, TILE_W), device=dev)
    ar, ag, ab, aw, rv = zero, zero, zero, zero, zero + 1.0
    for k in range(ids.shape[1]):
        idk = ids[:, k]
        r = (rows[torch.clamp(idk, min=0).long()]
             * (idk >= 0)[:, None].to(rows.dtype))[:, None, None, :]
        e0 = _plane(r[..., 0], r[..., 1], r[..., 2], xn, yn)
        e1 = _plane(r[..., 3], r[..., 4], r[..., 5], xn, yn)
        e2 = _plane(r[..., 6], r[..., 7], r[..., 8], xn, yn)
        s = e0 + e1 + e2
        inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (s > 0) & (r[..., 12] > 0)
        d = _plane(r[..., 9], r[..., 10], r[..., 11], xn, yn)
        visible = inside & (d > od) & (d <= 1.0)
        if pl is not None:
            visible = visible & ((d < pl) | (r[..., 35] <= 0) if mode == 2
                                 else d < pl)
        inv = 1.0 / torch.where(s == 0, torch.ones_like(s), s)
        l0 = e0 * inv
        l1 = e1 * inv
        l2 = 1.0 - l0 - l1
        cr = _lerp3(r, 22, 4, l0, l1, l2)
        cg = _lerp3(r, 23, 4, l0, l1, l2)
        cb = _lerp3(r, 24, 4, l0, l1, l2)
        ca = _lerp3(r, 25, 4, l0, l1, l2)
        if mode:
            u = _lerp3(r, 16, 2, l0, l1, l2)
            v = _lerp3(r, 17, 2, l0, l1, l2)
            du, dv = 2 * u - 1, 2 * v - 1
            falloff = torch.clamp(1.0 - fma(du, du, dv * dv), 0.0, 1.0)
            if mode == 2:
                falloff = torch.where(r[..., 34] > 0, falloff,
                                      torch.ones_like(falloff))
            # 1 - ca*falloff is one fma, as XLA contracts it
            one_m = fma(-ca, falloff, torch.ones_like(ca))
            ca = ca * falloff
        else:
            one_m = 1.0 - ca
        alpha = torch.where(visible, ca, zero)
        b_ = (1.0 - d) * 5.0
        den = fma(b_ * b_, b_, torch.full_like(b_, 1e-5))
        # a true division (a Python number over a tensor is reciprocal * number)
        wk = torch.clamp(torch.full_like(den, 10.0) / den, 0.01, 300.0)
        wgt = wk * alpha
        ar = fma(cr, wgt, ar)
        ag = fma(cg, wgt, ag)
        ab = fma(cb, wgt, ab)
        aw = fma(wk, alpha, aw)
        rv = rv * torch.where(visible, one_m, zero + 1.0)
    return torch.stack([_untile(p, tiles_x, tiles_y) for p in (ar, ag, ab, aw, rv)])


def blend_inputs(setup, bins, big_ids, counts, tris, uv, color, opaque_depth,
                 tiles_x, width, height, soft=True, peel_depth=None,
                 soft_flag=None, peel_flag=None, tile0=0):
    """The K4 arguments both versions take, from the stream's tensors."""
    return dict(rows=blend_rows(setup, tris, uv, color, soft_flag, peel_flag),
                bins=bins.to(torch.int32).contiguous(),
                counts=counts.to(torch.int32).contiguous(),
                big_ids=big_ids.to(torch.int32).contiguous(),
                opaque_depth=opaque_depth.contiguous(), tiles_x=tiles_x,
                width=width, height=height, soft=soft,
                peel=None if peel_depth is None else peel_depth.contiguous(),
                tile0=tile0)


def raster_blend(setup, bins, big_ids, counts, tris, uv, color, opaque_depth,
                 tiles_x, tiles_y, width, height, *, soft=True, peel_depth=None,
                 soft_flag=None, peel_flag=None, tile0=0):
    """Weighted-blend OIT accumulation: the five (tiles_y*32, tiles_x*128)
    f32 planes (ar, ag, ab, aw, reveal) of raster_blend_pallas(planes=
    True).  Band mode: bins, opaque_depth and peel_depth hold the tile rows
    from the frame tile tile0 on.  Runs the plain PyTorch version on
    every device."""
    check_band(bins.shape[0], tiles_x, tile0, tiles_y)
    inp = blend_inputs(setup, bins, big_ids, counts, tris, uv, color,
                       opaque_depth, tiles_x, width, height, soft, peel_depth,
                       soft_flag, peel_flag, tile0)
    fn = raster_blend_reference
    return tuple(fn(**inp).unbind(0))
