"""Texture and cubemap sampling (counterpart of datum_tpu/ops/sampling.py).

Cubemaps are (6, S, S, C) f32 with faces ordered +X -X +Y -Y +Z -Z.
The environment's flat, quad-packed and mip-pair tables
(`flatten_cube_mips`, `_quad`, `_pair`) keep plain f32 rows: the JAX
package bitcasts the last two to u8 only to make the TPU's row gather
cheaper (`pack_rows_u8`), which moves no value; convert.to_torch views
such a u8 table as f32 again.  The legacy 256^2 texture pool is tapped by
`sample_bilinear` (REPEAT or CLAMP wrap).
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


# ---------------------------------------------------------------------------
# The deferred (XLA) path's samplers: the legacy texture pool, the flat
# and quad-packed cubemap chains.
# ---------------------------------------------------------------------------

WRAP_REPEAT = 0
WRAP_CLAMP = 1


def _to_f32(v):
    """u8 textures normalise to [0, 1]; everything else passes through."""
    if v.dtype == torch.uint8:
        return v.to(torch.float32) * (1.0 / 255.0)
    return v.to(torch.float32)


def take_rows_f32(table, idx):
    """Row gather of f32 rows (the JAX package gathers u8-bitcast rows
    there, `pack_rows_u8`, a TPU layout; convert.to_torch views such a
    table as f32 again)."""
    return table[idx]


def _wrap_uv(u, size, mode):
    if mode == WRAP_REPEAT:
        return torch.remainder(u, size)
    return torch.clamp(u, 0, size - 1)


def sample_bilinear(tex, tex_ids, uv, mode=WRAP_REPEAT):
    """Bilinear sample of a texture pool.  tex: (N, S, S, C) float or u8;
    tex_ids: (...,) int; uv: (..., 2), repeating beyond [0, 1].  Returns
    (..., C) f32."""
    s = tex.shape[1]
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x0w, x1w = _wrap_uv(x0, s, mode), _wrap_uv(x0 + 1, s, mode)
    y0w, y1w = _wrap_uv(y0, s, mode), _wrap_uv(y0 + 1, s, mode)
    ids = tex_ids.long()

    def fetch(yy, xx):
        return _to_f32(tex[ids, yy, xx])

    return _bilerp(fetch(y0w, x0w), fetch(y0w, x1w), fetch(y1w, x0w),
                   fetch(y1w, x1w), fx, fy)


def sample_image_bilinear(img, uv, mode=WRAP_CLAMP):
    """Bilinear sample of one (H, W, C) image at uv in [0, 1]."""
    h, w = img.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    xs = (_wrap_uv(x0, w, mode), _wrap_uv(x0 + 1, w, mode))
    ys = (_wrap_uv(y0, h, mode), _wrap_uv(y0 + 1, h, mode))
    return _bilerp(_to_f32(img[ys[0], xs[0]]), _to_f32(img[ys[0], xs[1]]),
                   _to_f32(img[ys[1], xs[0]]), _to_f32(img[ys[1], xs[1]]), fx, fy)


def sample_cubemap_lod(cube_mips, d, lod):
    """Trilinear-across-mips cubemap sample: a linear blend of the
    bilinear taps of mips floor(lod) and floor(lod) + 1.  cube_mips: a
    list of (6, S_i, S_i, C); lod (...,) continuous."""
    n = len(cube_mips)
    lod = torch.clamp(lod, 0.0, n - 1)
    l0f = torch.floor(lod)
    f = (lod - l0f)[..., None]
    l0 = l0f.long()
    out0 = out1 = None
    for i in range(n):
        s_i = _to_f32(sample_cubemap(cube_mips[i], d))
        if out0 is None:
            out0 = torch.zeros_like(s_i)
            out1 = torch.zeros_like(s_i)
        out0 = torch.where((l0 == i)[..., None], s_i, out0)
        out1 = torch.where((torch.clamp(l0 + 1, max=n - 1) == i)[..., None], s_i, out1)
    return out0 + (out1 - out0) * f


def flatten_cube_mips(cube_mips):
    """A power-of-two mip chain as one flat texel table: (table (N, C)
    f32, bases (n,) int32, sizes (n,) int32)."""
    flats, bases, sizes = [], [], []
    off = 0
    for m in cube_mips:
        m = _to_f32(torch.as_tensor(m))
        s = int(m.shape[1])
        flats.append(m.reshape(-1, m.shape[-1]))
        bases.append(off)
        sizes.append(s)
        off += 6 * s * s
    dev = flats[0].device
    return (torch.cat(flats, 0), torch.tensor(bases, dtype=torch.int32, device=dev),
            torch.tensor(sizes, dtype=torch.int32, device=dev))


def _flat_bilinear(table, base, s, face, uv):
    sf = s.to(torch.float32)
    x = uv[..., 0] * sf - 0.5
    y = uv[..., 1] * sf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x0c = torch.minimum(torch.clamp(x0, min=0), s - 1)
    x1c = torch.minimum(torch.clamp(x0 + 1, min=0), s - 1)
    y0c = torch.minimum(torch.clamp(y0, min=0), s - 1)
    y1c = torch.minimum(torch.clamp(y0 + 1, min=0), s - 1)
    row = base + (face * s + y0c) * s
    row1 = base + (face * s + y1c) * s
    return _bilerp(table[row + x0c], table[row + x1c], table[row1 + x0c],
                   table[row1 + x1c], fx, fy)


def sample_cubemap_lod_flat(flat, d, lod):
    """Trilinear cubemap sample from flatten_cube_mips' table: 8 texel
    gathers per sample whatever the chain length."""
    table, bases, sizes = flat
    n = bases.shape[0]
    lod = torch.clamp(lod, 0.0, n - 1)
    l0f = torch.floor(lod)
    f = (lod - l0f)[..., None]
    l0 = l0f.long()
    l1 = torch.clamp(l0 + 1, max=n - 1)
    face, uv = cubemap_face_uv(d)
    face = face.long()
    s0 = _flat_bilinear(table, bases[l0].long(), sizes[l0].long(), face, uv)
    s1 = _flat_bilinear(table, bases[l1].long(), sizes[l1].long(), face, uv)
    return s0 + (s1 - s0) * f


def flatten_cube_mips_quad(cube_mips):
    """Quad-packed flat cubemap chain: (table (N, 4C) f32, bases, sizes);
    each texel row holds its 2x2 bilinear footprint, edges clamped within
    the face.  The JAX package bitcasts the table to u8 for the TPU's
    gathers (`pack_rows_u8`), which moves no value; the port keeps f32."""
    flats, bases, sizes = [], [], []
    off = 0
    for m in cube_mips:
        m = _to_f32(torch.as_tensor(m))
        s = int(m.shape[1])
        flats.append(torch.cat([quad_pack(m[f]) for f in range(6)], 0))
        bases.append(off)
        sizes.append(s)
        off += 6 * s * s
    dev = flats[0].device
    return (torch.cat(flats, 0), torch.tensor(bases, dtype=torch.int32, device=dev),
            torch.tensor(sizes, dtype=torch.int32, device=dev))


def _quad_bilinear(table, base, s, face, uv, channels):
    sf = s.to(torch.float32)
    x = uv[..., 0] * sf - 0.5
    y = uv[..., 1] * sf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    # a floor clamped at the low edge takes texel 0 (fraction 0)
    fx = torch.where(x0 < 0, torch.zeros_like(x), x - x0)[..., None]
    fy = torch.where(y0 < 0, torch.zeros_like(y), y - y0)[..., None]
    x0c = torch.minimum(torch.clamp(x0.long(), min=0), s - 1)
    y0c = torch.minimum(torch.clamp(y0.long(), min=0), s - 1)
    row = take_rows_f32(table, base + (face * s + y0c) * s + x0c)   # (..., 4C)
    c = channels
    return _bilerp(row[..., 0:c], row[..., c:2 * c], row[..., 2 * c:3 * c],
                   row[..., 3 * c:4 * c], fx, fy)


def sample_cubemap_lod_quad(flatq, d, lod):
    """Trilinear cubemap sample from a quad-packed chain: one row gather
    per adjacent mip."""
    table, bases, sizes = flatq
    c = table.shape[-1] // 4
    n = bases.shape[0]
    lod = torch.clamp(lod, 0.0, n - 1)
    l0f = torch.floor(lod)
    f = (lod - l0f)[..., None]
    l0 = l0f.long()
    l1 = torch.clamp(l0 + 1, max=n - 1)
    face, uv = cubemap_face_uv(d)
    face = face.long()
    s0 = _quad_bilinear(table, bases[l0].long(), sizes[l0].long(), face, uv, c)
    s1 = _quad_bilinear(table, bases[l1].long(), sizes[l1].long(), face, uv, c)
    return s0 + (s1 - s0) * f


def sample_cubemap_quad(flatq, d, level=0):
    """Bilinear cubemap sample of one mip of a quad-packed chain: one row
    gather per output texel.  d: (..., 3); level: the mip index."""
    table, bases, sizes = flatq
    face, uv = cubemap_face_uv(d)
    return _quad_bilinear(table, bases[level].long(), sizes[level].long(),
                          face.long(), uv, table.shape[-1] // 4)
