"""Shared example-app harness (counterpart of examples/common.py): each
example defines init/update/render and runs headless for N frames at a
fixed 1/60 s step, then saves the last frame as a PNG (written with zlib:
the card's machine has no PIL)."""

from __future__ import annotations

import argparse
import os
import struct
import tempfile
import time
import zlib

import numpy as np
import torch


def write_png(path, image):
    """Write an (H, W, 3) or (H, W, 4) uint8 image as an 8-bit PNG."""
    img = np.ascontiguousarray(image, np.uint8)
    h, w, c = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], 1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             {3: 2, 4: 6}[c], 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def read_png(path):
    """An 8-bit RGB or RGBA PNG (no interlace) as an (h, w, 3) or (h, w, 4)
    uint8 numpy array, decoded with zlib: the card's machine has no PIL.
    A byte's filter predictor reads its left, upper and upper-left
    neighbours, all on earlier anti-diagonals x + y of the pixel grid, so
    the rows are unfiltered one anti-diagonal at a time, every pixel of it
    at once."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, w, h, c = 8, b"", None, None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or ctype not in (2, 6) or interlace != 0:
                raise ValueError(f"{path}: not 8-bit RGB or RGBA without interlace")
            c = 3 if ctype == 2 else 4
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + c * w)
    filt = raw[:, 0].astype(np.int32)
    if (filt > 4).any():
        raise ValueError(f"{path}: unknown PNG filter {int(filt.max())}")
    line = raw[:, 1:].reshape(h, w, c).astype(np.int32)
    out = np.zeros((h + 1, w + 1, c), np.int32)     # a zero row above, a zero column left
    for diag in range(h + w - 1):
        y = np.arange(max(0, diag - w + 1), min(h, diag + 1))
        x = diag - y
        a, b, cc = out[y + 1, x], out[y, x + 1], out[y, x]   # left, up, up-left
        p_ = a + b - cc
        pa, pb, pc = np.abs(p_ - a), np.abs(p_ - b), np.abs(p_ - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        f = filt[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) // 2, paeth], 0)
        out[y + 1, x + 1] = (line[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def run_example(name, init, update, render, frames=8, width=640, height=352,
                out=None, argv=None, options=()):
    """Parse --frames --width --height --out --overlay --cpu (and the
    example's own options: (flag, argparse keywords) pairs) from argv
    (default sys.argv), then init(args) (args.device: "cuda", or "cpu"
    under --cpu), and per frame a frame marker, update(state, 1/60) and
    render(state) under the debug ring's timed blocks "update" and
    "render"; the last frame, with the debug overlay under --overlay,
    goes to --out.  Returns the state."""
    from ..debug import frame_marker, render_debug_overlay, timed_block

    parser = argparse.ArgumentParser(name)
    parser.add_argument("--frames", type=int, default=frames)
    parser.add_argument("--width", type=int, default=width)
    parser.add_argument("--height", type=int, default=height)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--out", default=out or os.path.join(tempfile.gettempdir(),
                                                             f"{name}.png"))
    parser.add_argument("--overlay", action="store_true")
    for flag, kw in options:
        parser.add_argument(flag, **kw)
    args = parser.parse_args(argv)
    args.device = "cpu" if args.cpu else "cuda"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{name}: no CUDA device (pass --cpu for the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    state = init(args)
    dt = 1 / 60
    img = None
    t_last = time.perf_counter()
    fps = 0.0
    for _ in range(args.frames):
        frame_marker()
        with timed_block("update"):
            update(state, dt)
        with timed_block("render"):
            img = render(state)
        now = time.perf_counter()
        fps = 1.0 / max(now - t_last, 1e-6)
        t_last = now
    if img is not None:
        img = img.copy()
        if args.overlay:
            render_debug_overlay(img, fps=fps)
        write_png(args.out, img)
        print(f"{name}: {args.frames} frames, saved {args.out}")
    return state
