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
