"""Radiance .hdr (RGBE) image IO (counterpart of datum_tpu/tools/hdr.py):
reads flat and RLE scanlines into (H, W, 3) float32, writes flat ones.
"""

from __future__ import annotations

import numpy as np


def load_hdr(path) -> np.ndarray:
    """Returns (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a radiance file")
        while True:
            line = f.readline().strip()
            if not line:
                break
        dims = f.readline().split()
        if dims[0] != b"-Y":
            raise ValueError("unsupported orientation")
        h, w = int(dims[1]), int(dims[3])
        data = np.zeros((h, w, 4), np.uint8)
        for y in range(h):
            head = f.read(4)
            if len(head) < 4:
                raise ValueError("truncated file")
            if head[0] == 2 and head[1] == 2 and (head[2] << 8 | head[3]) == w:
                # new-style RLE per channel
                for c in range(4):
                    x = 0
                    while x < w:
                        n = f.read(1)[0]
                        if n > 128:
                            data[y, x:x + n - 128, c] = f.read(1)[0]
                            x += n - 128
                        else:
                            chunk = np.frombuffer(f.read(n), np.uint8)
                            data[y, x:x + n, c] = chunk
                            x += n
            else:
                # flat scanline
                row = head + f.read(4 * (w - 1))
                data[y] = np.frombuffer(row, np.uint8).reshape(w, 4)
    rgbe = data.astype(np.float32)
    e = np.exp2(rgbe[..., 3] - 136.0)[..., None]   # 128 bias + 8 mantissa
    out = rgbe[..., :3] * e
    out[data[..., 3] == 0] = 0
    return out.astype(np.float32)


def save_hdr(path, image: np.ndarray):
    """Writes (H, W, 3) float32 as flat (non-RLE) radiance."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    mx = img.max(-1)
    e = np.where(mx > 1e-32, np.ceil(np.log2(np.maximum(mx, 1e-32))) + 1, 0)
    scale = np.exp2(e - 8)[..., None]
    mant = np.clip(img / np.maximum(scale, 1e-38), 0, 255).astype(np.uint8)
    eb = np.where(mx > 1e-32, e + 128, 0).astype(np.uint8)
    rgbe = np.concatenate([mant, eb[..., None]], -1).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
