"""Cubemap sampling (counterpart of the part of datum_tpu/ops/sampling.py
the environment path calls).

Cubemaps are (6, S, S, C) f32 with faces ordered +X -X +Y -Y +Z -Z.
The mip-pair table of `flatten_cube_mips_pair` keeps plain f32 rows:
the JAX package bitcasts them to u8 only to make the TPU's row gather
cheaper (`pack_rows_u8`), which moves no value; convert.to_torch views
such a u8 table as f32 again.
"""

from __future__ import annotations

import torch


def _bilerp(t00, t01, t10, t11, fx, fy):
    top = t00 + (t01 - t00) * fx
    bot = t10 + (t11 - t10) * fx
    return top + (bot - top) * fy


def cubemap_face_uv(d):
    """Direction (..., 3) -> (face id (...,) int32, uv (..., 2) in [0, 1])."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5))).to(torch.int32)
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)), min=1e-20)
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z), -y))
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    return face, torch.stack([u, v], dim=-1)


def cubemap_texel_dir(face, u, v):
    """Inverse of cubemap_face_uv: face id (int or tensor) + uv -> unit
    direction (..., 3)."""
    sc = 2.0 * u - 1.0
    tc = 2.0 * v - 1.0
    one = torch.ones_like(sc)
    dirs = [
        torch.stack([one, -tc, -sc], -1),    # +X
        torch.stack([-one, -tc, sc], -1),    # -X
        torch.stack([sc, one, tc], -1),      # +Y
        torch.stack([sc, -one, -tc], -1),    # -Y
        torch.stack([sc, -tc, one], -1),     # +Z
        torch.stack([-sc, -tc, -one], -1),   # -Z
    ]
    face = torch.as_tensor(face, device=sc.device)
    d = dirs[0]
    for i in range(1, 6):
        d = torch.where((face == i)[..., None], dirs[i], d)
    n = torch.sqrt((d * d).sum(-1, keepdim=True))
    return d / n


def sample_cubemap(cube, d):
    """Bilinear cubemap sample, edges clamped within the face (no seam
    filtering).  cube: (6, S, S, C); d: (..., 3).  Returns (..., C)."""
    face, uv = cubemap_face_uv(d)
    s = cube.shape[1]
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    f = face.long()
    x0c, x1c = torch.clamp(x0, 0, s - 1), torch.clamp(x0 + 1, 0, s - 1)
    y0c, y1c = torch.clamp(y0, 0, s - 1), torch.clamp(y0 + 1, 0, s - 1)
    return _bilerp(cube[f, y0c, x0c], cube[f, y0c, x1c],
                   cube[f, y1c, x0c], cube[f, y1c, x1c], fx, fy)


def quad_pack(img):
    """(..., H, W, C) -> (..., H*W, 4C) rows [t(y,x), t(y,x+1), t(y+1,x),
    t(y+1,x+1)] with edge clamp (within each image of a leading batch)."""
    h, w, c = img.shape[-3:]
    xr = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    yd = torch.cat([img[..., 1:, :, :], img[..., -1:, :, :]], dim=-3)
    xyd = torch.cat([yd[..., 1:, :], yd[..., -1:, :]], dim=-2)
    return torch.cat([img, xr, yd, xyd], dim=-1).reshape(*img.shape[:-3], h * w, 4 * c)


def flatten_cube_mips_pair(cube_mips):
    """Mip-pair quad-packed cubemap chain: (table (N, 8C) f32, bases (n,)
    int32, sizes (n,) int32).  Each mip-l texel row holds its own 2x2
    quad and the 2x2 quad of mip l+1 resampled (bilinear) onto mip l's
    texel grid, so one row gather serves a trilinear sample; the last
    mip pairs with itself."""
    flats, bases, sizes = [], [], []
    off = 0
    n = len(cube_mips)
    for li, m in enumerate(cube_mips):
        m = torch.as_tensor(m, dtype=torch.float32)
        s = int(m.shape[1])
        nxt = torch.as_tensor(cube_mips[min(li + 1, n - 1)], dtype=torch.float32,
                              device=m.device)
        if nxt.shape[1] != s:
            sn = nxt.shape[1]
            x = (torch.arange(s, dtype=torch.float32, device=m.device) + 0.5) \
                * (sn / s) - 0.5
            x0 = torch.clamp(torch.floor(x).long(), 0, sn - 1)
            x1 = torch.clamp(x0 + 1, max=sn - 1)
            fx = torch.clamp(x - x0, 0.0, 1.0)
            a = nxt[:, x0][:, :, x0]
            b = nxt[:, x0][:, :, x1]
            c_ = nxt[:, x1][:, :, x0]
            d_ = nxt[:, x1][:, :, x1]
            top = a + (b - a) * fx[None, None, :, None]
            bot = c_ + (d_ - c_) * fx[None, None, :, None]
            nxt = top + (bot - top) * fx[None, :, None, None]
        flats.append(torch.cat([torch.cat([quad_pack(m[f]), quad_pack(nxt[f])],
                                          dim=-1) for f in range(6)], dim=0))
        bases.append(off)
        sizes.append(s)
        off += 6 * s * s
    dev = flats[0].device
    return (torch.cat(flats, dim=0),
            torch.tensor(bases, dtype=torch.int32, device=dev),
            torch.tensor(sizes, dtype=torch.int32, device=dev))


def sample_cubemap_lod_pair(flatp, d, lod):
    """Trilinear cubemap sample from a mip-pair table: one row gather per
    output texel.  d: (..., 3); lod: (...,) continuous mip."""
    table, bases, sizes = flatp
    c = table.shape[-1] // 8
    n = bases.shape[0]
    lod = torch.clamp(lod, 0.0, n - 1)
    l0 = torch.floor(lod)
    f = (lod - l0)[..., None]
    l0 = l0.long()
    face, uv = cubemap_face_uv(d)
    base, s = bases[l0].long(), sizes[l0].long()
    sf = s.to(torch.float32)
    x = uv[..., 0] * sf - 0.5
    y = uv[..., 1] * sf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.where(x0 < 0, torch.zeros_like(x), x - x0)[..., None]
    fy = torch.where(y0 < 0, torch.zeros_like(y), y - y0)[..., None]
    x0c = torch.minimum(torch.clamp(x0.long(), min=0), s - 1)
    y0c = torch.minimum(torch.clamp(y0.long(), min=0), s - 1)
    row = table[base + (face.long() * s + y0c) * s + x0c]          # (..., 8C)
    s0 = _bilerp(row[..., 0:c], row[..., c:2 * c],
                 row[..., 2 * c:3 * c], row[..., 3 * c:4 * c], fx, fy)
    s1 = _bilerp(row[..., 4 * c:5 * c], row[..., 5 * c:6 * c],
                 row[..., 6 * c:7 * c], row[..., 7 * c:8 * c], fx, fy)
    return s0 + (s1 - s0) * f
