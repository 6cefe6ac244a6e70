"""BC3 (DXT5) texture block codec, vectorised numpy (counterpart of
datum_tpu/tools/bc.py; exact against it).

decode_bc3 decodes whole images (Model.load reads BC3 maps through it);
encode_bc3 is a min-max endpoint fit, the pack tools' encoder.
"""

from __future__ import annotations

import numpy as np


def _unpack_565(c):
    r = ((c >> 11) & 0x1F).astype(np.float32) * (255.0 / 31.0)
    g = ((c >> 5) & 0x3F).astype(np.float32) * (255.0 / 63.0)
    b = (c & 0x1F).astype(np.float32) * (255.0 / 31.0)
    return np.stack([r, g, b], -1)


def decode_bc3(blocks: np.ndarray, width: int, height: int) -> np.ndarray:
    """blocks: flat uint8 array of 16-byte BC3 blocks (row-major 4x4
    blocks).  Returns (height, width, 4) uint8."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    b = np.frombuffer(np.ascontiguousarray(blocks), np.uint8)[:bw * bh * 16]
    b = b.reshape(bw * bh, 16)

    # alpha: 2 endpoints + 48-bit 3-bit indices
    a0 = b[:, 0].astype(np.float32)
    a1 = b[:, 1].astype(np.float32)
    abits = np.zeros(len(b), np.uint64)
    for i in range(6):
        abits |= b[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    aidx = np.stack([(abits >> np.uint64(3 * i)) & np.uint64(7)
                     for i in range(16)], -1).astype(np.int32)   # (N, 16)
    # alpha palette
    apal = np.zeros((len(b), 8), np.float32)
    apal[:, 0] = a0
    apal[:, 1] = a1
    gt = a0 > a1
    for i in range(1, 7):
        apal[gt, i + 1] = ((7 - i) * a0[gt] + i * a1[gt]) / 7.0
    for i in range(1, 5):
        apal[~gt, i + 1] = ((5 - i) * a0[~gt] + i * a1[~gt]) / 5.0
    apal[~gt, 6] = 0
    apal[~gt, 7] = 255
    alpha = np.take_along_axis(apal, aidx, axis=1)               # (N, 16)

    # color: BC1 block at bytes 8..15
    c0 = b[:, 8].astype(np.uint16) | (b[:, 9].astype(np.uint16) << 8)
    c1 = b[:, 10].astype(np.uint16) | (b[:, 11].astype(np.uint16) << 8)
    cbits = (b[:, 12].astype(np.uint32) | (b[:, 13].astype(np.uint32) << 8)
             | (b[:, 14].astype(np.uint32) << 16) | (b[:, 15].astype(np.uint32) << 24))
    cidx = np.stack([(cbits >> np.uint32(2 * i)) & np.uint32(3)
                     for i in range(16)], -1).astype(np.int32)
    p0 = _unpack_565(c0)
    p1 = _unpack_565(c1)
    cpal = np.stack([p0, p1, (2 * p0 + p1) / 3.0, (p0 + 2 * p1) / 3.0], 1)  # (N,4,3)
    color = np.take_along_axis(cpal, cidx[..., None], axis=1)    # (N, 16, 3)

    out = np.zeros((bh * 4, bw * 4, 4), np.uint8)
    texels = np.concatenate([color, alpha[..., None]], -1)       # (N, 16, 4)
    texels = texels.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    out[:bh * 4, :bw * 4] = np.clip(texels.reshape(bh * 4, bw * 4, 4) + 0.5,
                                    0, 255).astype(np.uint8)
    return out[:height, :width]


def encode_bc3(image: np.ndarray) -> np.ndarray:
    """image: (H, W, 4) uint8, H/W multiples of 4.  Returns flat uint8
    16-byte blocks.  Min-max endpoint fit."""
    h, w = image.shape[:2]
    bh, bw = h // 4, w // 4
    img = image.astype(np.float32)
    blocks = img.reshape(bh, 4, bw, 4, 4).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 4)
    n = len(blocks)
    out = np.zeros((n, 16), np.uint8)

    # --- alpha (BC4) ---
    a = blocks[..., 3]
    amax = a.max(1)
    amin = a.min(1)
    out[:, 0] = amax.astype(np.uint8)
    out[:, 1] = amin.astype(np.uint8)
    arange = np.maximum(amax - amin, 1e-5)
    t = (a - amin[:, None]) / arange[:, None]        # 0..1, 0 = a1 end
    # palette order for a0>a1: idx0=a0(max),1=a1(min),2..7 interp from a0
    steps = np.clip(np.round((1 - t) * 7), 0, 7).astype(np.uint64)
    # map step s (0 = a0 .. 7 = a1) to index
    index_of_step = np.array([0, 2, 3, 4, 5, 6, 7, 1], np.uint64)
    aidx = index_of_step[steps]
    abits = np.zeros(n, np.uint64)
    for i in range(16):
        abits |= aidx[:, i] << np.uint64(3 * i)
    for i in range(6):
        out[:, 2 + i] = ((abits >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8)

    # --- color (BC1) ---
    rgb = blocks[..., :3]
    cmax = rgb.max(1)
    cmin = rgb.min(1)

    def pack565(c):
        r = np.round(c[:, 0] * 31 / 255).astype(np.uint16)
        g = np.round(c[:, 1] * 63 / 255).astype(np.uint16)
        bl = np.round(c[:, 2] * 31 / 255).astype(np.uint16)
        return (r << 11) | (g << 5) | bl

    c0v, c1v = pack565(cmax), pack565(cmin)
    # ensure c0 > c1 for 4-color mode; swap if needed
    swap = c0v <= c1v
    c0 = np.where(swap, c1v, c0v)
    c1 = np.where(swap, c0v, c1v)
    e0 = np.where(swap[:, None], cmin, cmax)
    e1 = np.where(swap[:, None], cmax, cmin)
    axis = e0 - e1
    denom = np.maximum((axis * axis).sum(1), 1e-5)
    t = ((rgb - e1[:, None]) * axis[:, None]).sum(-1) / denom[:, None]  # 1 at e0
    step = np.clip(np.round(t * 3), 0, 3).astype(np.uint32)
    # palette: 0=e0, 1=e1, 2=2/3 e0, 3=1/3 e0 ; step s in [0(e1)..3(e0)]
    index_of = np.array([1, 3, 2, 0], np.uint32)
    cidx = index_of[step]
    degenerate = (c0 == c1)
    cidx[degenerate] = 0
    cbits = np.zeros(n, np.uint32)
    for i in range(16):
        cbits |= cidx[:, i] << np.uint32(2 * i)
    out[:, 8] = (c0 & 0xFF).astype(np.uint8)
    out[:, 9] = (c0 >> 8).astype(np.uint8)
    out[:, 10] = (c1 & 0xFF).astype(np.uint8)
    out[:, 11] = (c1 >> 8).astype(np.uint8)
    out[:, 12] = (cbits & 0xFF).astype(np.uint8)
    out[:, 13] = ((cbits >> 8) & 0xFF).astype(np.uint8)
    out[:, 14] = ((cbits >> 16) & 0xFF).astype(np.uint8)
    out[:, 15] = ((cbits >> 24) & 0xFF).astype(np.uint8)
    return out.reshape(-1)
