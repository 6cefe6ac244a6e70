"""Screen-space reconstruction helpers (counterpart of the part of
datum_tpu/ops/lighting_pass.py the megakernel path calls: the view-ray
grid and depth -> position reconstruction).  The XLA fallback shade of
that module is not ported (ROADMAP Queue 1, off-main-path device code).
"""

from __future__ import annotations

import torch


def view_ray_grid(invproj, width, height):
    """Per-pixel view ray (x, y, -1) through each pixel centre: returns
    the (height, width) x and y components."""
    dev = invproj.device
    yn = ((torch.arange(height, dtype=torch.float32, device=dev) + 0.5)
          / height * 2.0 - 1.0)[:, None]
    xn = ((torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
          / width * 2.0 - 1.0)[None, :]
    rx = invproj[0, 0] * xn
    ry = invproj[1, 1] * yn
    return rx.expand(height, width), ry.expand(height, width)


def reconstruct_positions(depth, proj, invview, width, height):
    """Reverse-Z depth (H, W) -> (view-space, world-space) positions
    (H, W, 3).  view_z = proj[2][3] / (d + proj[2][2]) is the positive
    distance along -Z.  The denominator is clamped away from 0 (depth 0
    is the background under the infinite projection), so positions stay
    finite and reduced-res pooling never mixes NaN into covered pixels."""
    rx, ry = view_ray_grid(_inv_proj(proj), width, height)
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
