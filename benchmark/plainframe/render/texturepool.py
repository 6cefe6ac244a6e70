"""Material-map texel table: mips + native sizes + one-gather sampling.

Host numpy, copied from datum_tpu/render/texturepool.py (that package
cannot be imported where jax is absent).

Texture system v2 (reference: src/renderer/texture.cpp layered+mipped
textures, material.cpp albedo/surface/normal map binding).  The three
maps of a material share UVs, so they are combined into ONE flat texel
table whose rows hold [albedo rgba | surface rgba | normal rgba] for
the 2x2 bilinear footprint (48 u8) — TPU gather cost is per-LOOKUP, not
per-byte (profiling/prof_micro.py), so a full trilinear-ready material
sample costs a single gather per pixel.

Layout per material entry (size S = pow2 <= MAX_SIZE, full mip chain to
1x1): rows [base, base + S^2) are mip 0 quad rows in y-major order,
then mip 1, ...  mip l starts at base + 4*(S^2 - (S>>l)^2)//3 (exact
for pow2).  Wrap mode is REPEAT (quad neighbors wrap), matching the
reference's repeat samplers.
"""

from __future__ import annotations

import numpy as np

MAX_SIZE = 1024
# f32 carries row indices exactly below 2^24 in the raster kernel planes
MAX_ROWS = 1 << 24


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _resize_bilinear_np(img: np.ndarray, size: int) -> np.ndarray:
    """Host-side bilinear resample of (H, W, C) u8 to (size, size, C).

    Neighbors wrap (REPEAT) to match the table's declared wrap mode —
    edge-clamped resampling would seam tiling textures at u/v = 0."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img
    y = (np.arange(size) + 0.5) * h / size - 0.5
    x = (np.arange(size) + 0.5) * w / size - 0.5
    fy = np.clip(y - np.floor(y), 0, 1)[:, None, None]
    fx = np.clip(x - np.floor(x), 0, 1)[None, :, None]
    y0 = np.floor(y).astype(np.int64) % h
    x0 = np.floor(x).astype(np.int64) % w
    y1 = (y0 + 1) % h
    x1 = (x0 + 1) % w
    a = img[y0][:, x0].astype(np.float32)
    b = img[y0][:, x1].astype(np.float32)
    c = img[y1][:, x0].astype(np.float32)
    d = img[y1][:, x1].astype(np.float32)
    out = (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def _mip_chain(img: np.ndarray) -> list[np.ndarray]:
    """Box-filtered pow2 mip chain down to 1x1 (reference:
    tools/assetpacker mip builders)."""
    mips = [img]
    cur = img
    while cur.shape[0] > 1:
        s = cur.shape[0] // 2
        cur = cur.reshape(s, 2, s, 2, cur.shape[-1]).astype(np.float32).mean((1, 3))
        cur = np.clip(cur + 0.5, 0, 255).astype(np.uint8)
        mips.append(cur)
    return mips


def _quad_pack_wrap(img: np.ndarray) -> np.ndarray:
    """(S, S, C) -> (S*S, 4C) rows with REPEAT-wrapped +1 neighbors."""
    s = img.shape[0]
    xr = np.roll(img, -1, axis=1)
    yd = np.roll(img, -1, axis=0)
    xyd = np.roll(yd, -1, axis=1)
    return np.concatenate([img, xr, yd, xyd], axis=-1).reshape(s * s, -1)


def mip_base_offset(size: int, level: int) -> int:
    """Row offset of mip `level` within an entry (exact pow2 formula)."""
    return 4 * (size * size - (size >> level) ** 2) // 3


def entry_rows(size: int) -> int:
    """Total rows of one entry: sum of squares of the full mip chain."""
    return (4 * size * size - 1) // 3


def build_matmap_pool(materials, tex_images, max_size=256):
    """Build the combined material-map table.

    materials: list of (albedomap, surfacemap, normalmap) texture-id
    triples per material; tex_images: dict id -> native (H, W, 4) u8.
    max_size caps entry resolution (a FrameConfig quality/memory dial).
    Returns (table (R, 48) u8, base (M,) i32, size (M,) i32).
    Identical triples share one entry.
    """
    cache: dict[tuple, tuple[int, int]] = {}
    chunks: list[np.ndarray] = []
    bases = np.zeros(len(materials), np.int32)
    sizes = np.ones(len(materials), np.int32)
    off = 0
    for mi, triple in enumerate(materials):
        if triple in cache:
            bases[mi], sizes[mi] = cache[triple]
            continue
        imgs = [tex_images[t] for t in triple]
        native = max(_pow2_ceil(max(i.shape[0], i.shape[1])) for i in imgs)
        native = max(native, 1)
        # cap must be a power of two (the mip offset formula and the
        # chain reshape are pow2-exact) — floor a stray value like 300
        cap = min(max_size, MAX_SIZE)
        cap = 1 << max(cap.bit_length() - 1, 0)
        size = min(native, cap)
        # build the chain from the NATIVE pow2 size and drop the levels
        # above the cap: downscaling to the cap with one bilinear tap
        # (2x2 footprint) aliases mip 0 and the whole chain inherits it;
        # the box chain is a proper area average at every level
        drop = native.bit_length() - size.bit_length()
        mips = [_mip_chain(_resize_bilinear_np(i, native))[drop:]
                for i in imgs]
        n_mips = len(mips[0])
        rows = []
        for l in range(n_mips):
            combined = np.concatenate([m[l] for m in mips], axis=-1)  # (s,s,12)
            rows.append(_quad_pack_wrap(combined))                     # (s*s,48)
        entry = np.concatenate(rows, axis=0)
        chunks.append(entry)
        bases[mi] = off
        sizes[mi] = size
        cache[triple] = (off, size)
        off += entry.shape[0]
    if not chunks:
        chunks = [np.zeros((1, 48), np.uint8)]
        off = 1
    if off >= MAX_ROWS:   # not an assert: stripped under python -O
        raise ValueError(
            f"material-map table {off} rows exceeds the f32-exact plane "
            f"range ({MAX_ROWS}) — lower matmap_max_size or dedupe maps")
    return np.concatenate(chunks, axis=0), bases, sizes
