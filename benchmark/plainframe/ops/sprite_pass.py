"""The device sprite and text pass (counterpart of
datum_tpu/ops/sprite_pass.py `composite_sprites`).

The render list's overlay quads (RenderList.sprite_arrays: icons, glyphs,
region-sized chunks of larger panels) alpha-blend into the display-space
image in draw order.  Each sprite i < count blends an R x R window of the
image: the window is centred on the sprite rect's bounding box and
clamped into [0, w - R] x [0, h - R]; each window pixel centre maps to
sprite-local (u, v) through the inverse of the rect's 2x2 edge basis
(inv_det = 0 where |det| < 1e-8, and such a sprite paints nothing); a
pixel with (u, v) in [0, 1)^2 takes the 4-tap bilinear atlas sample at
uv0 + (u, v) * (uv1 - uv0) (taps clamped to the atlas edge) times the
tint, and blends as reg * (1 - a) + src * a.

`composite_sprites` runs the plain PyTorch version
(`composite_sprites_reference`) on every device.  The JAX function is one `fori_loop`
over the capacity S whose inactive steps blend nothing; the plain version
loops over the live count instead, in the JAX function's arithmetic
order, and is the port's kernel's bit-exact reference.
"""

from __future__ import annotations

import torch



def sprite_window(origin, axis_x, axis_y, region, width, height):
    """The window's top-left (sx, sy) of one sprite: round(centre - R / 2)
    of the rect's bounding box (half to even), clamped into the image."""
    ax, ay = axis_x, axis_y
    zero = torch.zeros((), dtype=ax.dtype, device=ax.device)
    bx0 = torch.minimum(torch.minimum(zero, ax[0]), torch.minimum(ay[0], ax[0] + ay[0]))
    bx1 = torch.maximum(torch.maximum(zero, ax[0]), torch.maximum(ay[0], ax[0] + ay[0]))
    by0 = torch.minimum(torch.minimum(zero, ax[1]), torch.minimum(ay[1], ax[1] + ay[1]))
    by1 = torch.maximum(torch.maximum(zero, ax[1]), torch.maximum(ay[1], ax[1] + ay[1]))
    cx = origin[0] + 0.5 * (bx0 + bx1)
    cy = origin[1] + 0.5 * (by0 + by1)
    sx = torch.clamp(torch.round(cx - region * 0.5).to(torch.int32), 0, width - region)
    sy = torch.clamp(torch.round(cy - region * 0.5).to(torch.int32), 0, height - region)
    return int(sx), int(sy)


def bilinear_atlas(atlas_flat, aw, ah, px, py):
    """4-tap bilinear sample of a flattened (AH * AW, 4) atlas at float
    pixel coordinates (px, py); the taps clamp to the atlas edge."""
    x0 = torch.floor(px - 0.5)
    y0 = torch.floor(py - 0.5)
    fx = ((px - 0.5) - x0)[..., None]
    fy = ((py - 0.5) - y0)[..., None]

    def tap(xi, yi):
        xc = torch.clamp(xi.to(torch.int32), 0, aw - 1)
        yc = torch.clamp(yi.to(torch.int32), 0, ah - 1)
        return atlas_flat[(yc * aw + xc).long()]

    t00 = tap(x0, y0)
    t10 = tap(x0 + 1, y0)
    t01 = tap(x0, y0 + 1)
    t11 = tap(x0 + 1, y0 + 1)
    return ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
            + (t01 * (1 - fx) + t11 * fx) * fy)


def composite_sprites_reference(rgb, inst, atlas, region=128):
    """Plain PyTorch: rgb (H, W, 3) f32 display colour, inst the
    instance arrays (origin, axis_x, axis_y, uv0, uv1 (S, 2) f32 in
    pixels, tint (S, 4) f32, count () int32) on rgb's device, atlas
    (AH, AW, 4) f32 in [0, 1]; returns the blended (H, W, 3) image."""
    h, w = rgb.shape[:2]
    R = int(region)
    if not 1 <= R <= min(h, w):
        raise ValueError(f"composite_sprites: overlay region {R} exceeds image {h}x{w}")
    ah, aw = atlas.shape[:2]
    atlas_flat = atlas.reshape(-1, atlas.shape[-1])
    img = rgb.clone()
    grid = torch.arange(R, dtype=torch.float32, device=rgb.device)
    ys, xs = torch.meshgrid(grid, grid, indexing="ij")
    for i in range(max(min(int(inst["count"]), inst["origin"].shape[0]), 0)):
        origin, ax, ay = inst["origin"][i], inst["axis_x"][i], inst["axis_y"][i]
        uv0, uv1, tint = inst["uv0"][i], inst["uv1"][i], inst["tint"][i]
        sx, sy = sprite_window(origin, ax, ay, R, w, h)
        reg = img[sy:sy + R, sx:sx + R]
        # pixel-centre coordinates relative to the sprite origin
        dx = xs + ((sx + 0.5) - origin[0])
        dy = ys + ((sy + 0.5) - origin[1])
        det = ax[0] * ay[1] - ax[1] * ay[0]
        inv_det = torch.where(torch.abs(det) < 1e-8, 0.0, 1.0 / det)
        u = (dx * ay[1] - dy * ay[0]) * inv_det
        v = (dy * ax[0] - dx * ax[1]) * inv_det
        inside = ((u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
                  & (torch.abs(det) >= 1e-8))
        px = uv0[0] + u * (uv1[0] - uv0[0])
        py = uv0[1] + v * (uv1[1] - uv0[1])
        texel = bilinear_atlas(atlas_flat, aw, ah, px, py)
        a = (texel[..., 3] * tint[3] * inside.to(torch.float32))[..., None]
        src = texel[..., :3] * tint[:3]
        img[sy:sy + R, sx:sx + R] = reg * (1.0 - a) + src * a
    return img


def composite_sprites(rgb, inst, atlas, region=128):
    """Blend the live sprites of inst into rgb (the contract of
    composite_sprites_reference), on every device."""
    return composite_sprites_reference(rgb, inst, atlas, region)
