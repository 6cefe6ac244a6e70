"""Colour codecs: gamma, packed RGBA/sRGBA, RGBM, RGBE (9-9-9-5) and HSV
(counterpart of datum_tpu/math/color.py, numpy host code).

Packed formats are uint32 arrays; float images are (..., 3/4) float32.
These are the wire formats of .pack image assets (asset/pack.py); the
port's results equal the JAX package's bit for bit (u32 codes and float
decodes alike).
"""

from __future__ import annotations

import numpy as np

GAMMA = 2.2


def gamma_encode(linear):
    return np.power(np.clip(linear, 0.0, None), 1.0 / GAMMA)


def gamma_decode(encoded):
    return np.power(np.clip(encoded, 0.0, None), GAMMA)


def pack_rgba(color):
    """(..., 4) float -> uint32, layout 0xAARRGGBB (B in low byte)."""
    c = (np.clip(np.asarray(color, np.float32), 0, 1) * 255).astype(np.uint32)
    return (c[..., 2] << 0) | (c[..., 1] << 8) | (c[..., 0] << 16) | (c[..., 3] << 24)


def unpack_rgba(packed):
    p = np.asarray(packed, np.uint32)
    return np.stack(
        [((p >> 16) & 0xFF), ((p >> 8) & 0xFF), ((p >> 0) & 0xFF), ((p >> 24) & 0xFF)],
        axis=-1,
    ).astype(np.float32) / 255.0


def pack_srgba(color):
    c = np.asarray(color, np.float32).copy()
    c[..., :3] = gamma_encode(c[..., :3])
    return pack_rgba(c)


def unpack_srgba(packed):
    c = unpack_rgba(packed)
    c[..., :3] = gamma_decode(c[..., :3])
    return c


_RGBM_RANGE = 8.0


def pack_rgbm(color):
    c = np.clip(np.asarray(color, np.float32)[..., :3], 0, None) / _RGBM_RANGE
    m = np.ceil(np.clip(np.maximum(c.max(axis=-1), 1e-6), 0, 1) * 255.0) / 255.0
    cm = np.clip(c / m[..., None], 0, 1)
    q = (cm * 255).astype(np.uint32)
    mq = (m * 255).astype(np.uint32)
    return (q[..., 2] << 0) | (q[..., 1] << 8) | (q[..., 0] << 16) | (mq << 24)


def unpack_rgbm(packed):
    p = np.asarray(packed, np.uint32)
    m = ((p >> 24) & 0xFF).astype(np.float32) / 255.0
    rgb = np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, (p >> 0) & 0xFF], -1).astype(np.float32) / 255.0
    return _RGBM_RANGE * rgb * m[..., None]


def pack_rgbe(color):
    """Shared-exponent HDR: 9-bit mantissas + 5-bit exponent."""
    c = np.clip(np.asarray(color, np.float32)[..., :3], 0.0, 65408.0)
    mx = c.max(axis=-1)
    e = np.maximum(-16.0, np.floor(np.log2(np.maximum(mx, 1e-30)))) + 1
    scale = np.exp2(e)[..., None]
    q = np.round(c / scale * 511.0).astype(np.uint32)
    eq = (e + 15).astype(np.uint32)
    return (q[..., 0] << 0) | (q[..., 1] << 9) | (q[..., 2] << 18) | (eq << 27)


def unpack_rgbe(packed):
    p = np.asarray(packed, np.uint32)
    r = ((p >> 0) & 0x1FF).astype(np.float32) / 511.0
    g = ((p >> 9) & 0x1FF).astype(np.float32) / 511.0
    b = ((p >> 18) & 0x1FF).astype(np.float32) / 511.0
    e = ((p >> 27) & 0x1F).astype(np.float32) - 15.0
    return np.stack([r, g, b], -1) * np.exp2(e)[..., None]


def hsv_to_rgb(h, s, v):
    h = np.asarray(h, np.float32) % 1.0
    i = np.floor(h * 6).astype(np.int32)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    tables = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1), np.stack([p, v, t], -1),
        np.stack([p, q, v], -1), np.stack([t, p, v], -1), np.stack([v, p, q], -1),
    ])
    return tables[i % 6]
