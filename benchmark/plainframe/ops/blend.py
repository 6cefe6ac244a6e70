"""Weighted-blended OIT of the deferred (XLA) path (counterpart of
datum_tpu/ops/blend.py): the accumulation raster of translucents and
particles, and the resolve over the opaque hdr image.

`raster_blend` is the JAX package's XLA raster for `use_pallas=False`:
plain PyTorch on every device, the card included (the reference's own
algorithm for that flag, not a fallback).  Like the scan raster it walks
the tile's bins first, then the big list, one slot a step over all
tiles at once.  Each fragment inside the triangle (one winding, the
setup's sign-fixed adjugate), strictly nearer than the opaque depth and
at depth <= 1, adds (w*a*rgb, w*a) and multiplies the revealage by
(1 - a); with `soft`, the alpha falls off radially over the billboard's
uv.  K4 (ops/raster_blend_cuda.py) is the `use_pallas` counterpart.
"""

from __future__ import annotations

import torch

from .common import TILE_H, TILE_W, fma
from .raster import _tile_ndc, _untile, depth_plane_coefs, tile_image


def oit_weight(depth):
    """The WBOIT depth weight (near fragments weigh more); depth is
    reverse-Z in (0, 1]."""
    return torch.clamp(10.0 / (1e-5 + torch.pow((1.0 - depth) * 5.0, 3.0)), 0.01, 300.0)


def raster_blend(setup, bins, big_ids, vert_uv, vert_color, tris, opaque_depth,
                 tiles_x, tiles_y, width, height, soft=True):
    """Accumulate translucent coverage over all tiles: setup, bins and
    big_ids of the translucent stream; vert_uv (V, 2), vert_color (V, 4);
    opaque_depth (H, W) rejects hidden fragments.  Returns (accum (H, W,
    4) = [sum w*a*rgb, sum w*a], revealage (H, W))."""
    dev = bins.device
    n_tiles = tiles_x * tiles_y
    adj_s = setup["adj"] * torch.sign(setup["det"])[:, None, None]
    zs = depth_plane_coefs(setup)
    xn, yn = _tile_ndc(torch.arange(n_tiles, device=dev), tiles_x, width, height)
    od = tile_image(opaque_depth, tiles_x, tiles_y)
    t3 = tris.long()
    uv_tri = vert_uv[t3]                          # (T, 3, 2)
    col_tri = vert_color[t3]                      # (T, 3, 4)
    acc = torch.zeros((n_tiles, TILE_H, TILE_W, 4), dtype=torch.float32, device=dev)
    reveal = torch.ones((n_tiles, TILE_H, TILE_W), dtype=torch.float32, device=dev)
    ids = torch.cat([bins, big_ids[None, :].expand(n_tiles, big_ids.shape[0])], 1)

    def plane(c, k):
        return fma(c[:, k, 0, None, None], xn, c[:, k, 1, None, None] * yn) \
            + c[:, k, 2, None, None]

    for k in range(ids.shape[1]):
        tri = ids[:, k]
        t = torch.clamp(tri, min=0).long()
        a = adj_s[t]
        e0, e1, e2 = plane(a, 0), plane(a, 1), plane(a, 2)
        s = e0 + e1 + e2
        inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (s > 0)
                  & (tri >= 0)[:, None, None])
        d = plane(zs[t][:, None, :], 0)
        visible = inside & (d > od) & (d <= 1.0)
        inv = 1.0 / torch.where(s == 0, torch.ones_like(s), s)
        l0 = e0 * inv
        l1 = e1 * inv
        l2 = 1.0 - l0 - l1
        uvt, ct = uv_tri[t], col_tri[t]
        u = (uvt[:, 0, 0, None, None] * l0 + uvt[:, 1, 0, None, None] * l1
             + uvt[:, 2, 0, None, None] * l2)
        v = (uvt[:, 0, 1, None, None] * l0 + uvt[:, 1, 1, None, None] * l1
             + uvt[:, 2, 1, None, None] * l2)
        col = (ct[:, 0, None, None, :] * l0[..., None] + ct[:, 1, None, None, :] * l1[..., None]
               + ct[:, 2, None, None, :] * l2[..., None])
        alpha = col[..., 3]
        if soft:
            r2 = (2 * u - 1) ** 2 + (2 * v - 1) ** 2
            alpha = alpha * torch.clamp(1.0 - r2, 0.0, 1.0)
        alpha = torch.where(visible, alpha, torch.zeros_like(alpha))
        wgt = oit_weight(d) * alpha
        acc = acc + torch.cat([col[..., :3] * wgt[..., None], wgt[..., None]], -1)
        reveal = reveal * (1.0 - alpha)
    return _untile(acc, tiles_x, tiles_y), _untile(reveal, tiles_x, tiles_y)


def resolve_oit(hdr, accum, revealage, exposure=1.0):
    """WBOIT over the opaque hdr image: the weighted average colour
    (times exposure, as the forward shaders expose before blending)
    over hdr by 1 - revealage."""
    avg = accum[..., :3] / torch.clamp(accum[..., 3:4], min=1e-5) * exposure
    return hdr * revealage[..., None] + avg * (1.0 - revealage)[..., None]
