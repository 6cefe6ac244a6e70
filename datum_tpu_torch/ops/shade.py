"""Material-map sampling (counterpart of
datum_tpu/ops/shade.py::sample_matmaps, channel-first form).

The integer bit math — `>>` for the mip size, `&` for the REPEAT wrap
and the exact `(4*(S^2 - s^2))//3` mip offset — runs on int32 tensors,
as in the JAX package."""

from __future__ import annotations

import torch


def _bdiff(a, axis):
    """Edge-clamped backward difference |a - a_prev| along axis."""
    first = a.narrow(axis, 0, 1)
    prev = torch.cat([first, a.narrow(axis, 0, a.shape[axis] - 1)], dim=axis)
    return torch.abs(a - prev)


def sample_matmaps(table, base, size, uv, pool=1):
    """One-gather trilinear-ready material sample from the combined mip
    table.

    table: (R, 48) u8 quad rows (render/texturepool.py layout); base,
    size: per-pixel (H, W) int32; uv: (H, W, 2).  The mip level comes
    from screen-space uv derivatives; `pool` notes the resolution divisor
    so derivatives stay calibrated at reduced resolution.

    Returns (12, H, W) f32 in [0, 1]: albedo rgba, surface rgba, normal
    rgba, channel-first."""
    u, v = uv[..., 0], uv[..., 1]
    sf = size.to(torch.float32)
    du = _bdiff(u, 1) + _bdiff(u, 0)
    dv = _bdiff(v, 1) + _bdiff(v, 0)
    span = torch.maximum(du, dv) * sf * (1.0 / max(pool, 1))
    lod = torch.log2(torch.clamp(span, min=1.0))
    max_lod = torch.log2(torch.clamp(sf, min=1.0))          # exact for pow2
    level = torch.minimum(torch.clamp(torch.round(lod), min=0.0),
                          max_lod).to(torch.int32)
    s_l = size >> level
    slf = s_l.to(torch.float32)
    # mip row offset: 4*(S^2 - (S>>l)^2)/3, exact for pow2 sizes
    mip_base = base + torch.div(4 * (size * size - s_l * s_l), 3,
                                rounding_mode="floor")

    x = u * slf - 0.5
    y = v * slf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).reshape(-1, 1)
    fy = (y - y0).reshape(-1, 1)
    # REPEAT wrap via bitwise AND: s_l is pow2 and two's-complement AND
    # wraps negatives correctly
    xi = x0.to(torch.int32) & (s_l - 1)
    yi = y0.to(torch.int32) & (s_l - 1)
    idx = mip_base + yi * s_l + xi
    hh, ww = idx.shape
    rows = table[idx.reshape(-1).long()].to(torch.float32) * (1.0 / 255.0)
    t00, t01 = rows[:, 0:12], rows[:, 12:24]
    t10, t11 = rows[:, 24:36], rows[:, 36:48]
    top = t00 + (t01 - t00) * fx
    bot = t10 + (t11 - t10) * fx
    out = top + (bot - top) * fy
    return out.T.reshape(12, hh, ww)
