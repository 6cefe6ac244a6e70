"""Render the golden frames of the example apps, the megakernel frame and
the stress frame through the port (counterpart of
datum_tpu/tools/update_goldens.py): each example headless through its
harness at the goldens' config (3 frames of 1/60 s at 320x160), the last
frame saved.

    python -m datum_tpu_torch.tools.update_goldens OUT_DIR [NAME ...] [--cpu]
        [--teapot-pack PACK] [--character-pack PACK]

writes OUT_DIR/<name>.png with the port's zlib PNG writer.  It never
writes into tests/golden/ unless given that directory: the PNGs there are
the JAX package's frames, and they gate the port.  The teapot and
character apps read a pack (--pack); without its path an app is left out
and named.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

# the pack-free apps, then those that read a pack
EXAMPLES = ("triangle", "material", "skybox", "ocean", "stardust", "asteroids",
            "datumtest", "city")
PACK_EXAMPLES = ("teapot", "character")
COMMON = ["--frames", "3", "--width", "320", "--height", "160"]


def render_example(name, out_path, device="cuda", pack=None):
    """Run example `name` through its harness at the goldens' config, its
    last frame saved to out_path; pack: the pack path of a pack app.
    Returns the example's state."""
    mod = importlib.import_module(f"..examples.{name}", __package__)
    argv = COMMON + ["--out", out_path] + (["--cpu"] if device == "cpu" else [])
    if name in PACK_EXAMPLES:
        if pack is None:
            raise ValueError(f"{name} reads a pack: give its path")
        argv += ["--pack", pack]
    return mod.main(argv)


def main(argv=None):
    from ..examples.common import write_png
    from . import megakernel_golden, stress_golden

    ap = argparse.ArgumentParser("datum_tpu_torch.tools.update_goldens")
    ap.add_argument("out_dir")
    ap.add_argument("names", nargs="*")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--teapot-pack")
    ap.add_argument("--character-pack")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    packs = dict(teapot=args.teapot_pack, character=args.character_pack)
    names = args.names or (list(EXAMPLES) + [n for n in PACK_EXAMPLES if packs[n]]
                           + ["megakernel", "stress"])
    left_out = [n for n in PACK_EXAMPLES if n not in names]
    os.makedirs(args.out_dir, exist_ok=True)
    for name in names:
        out = os.path.join(args.out_dir, f"{name}.png")
        print(f"rendering golden: {name} -> {out}", flush=True)
        if name == "megakernel":
            write_png(out, megakernel_golden.render_megakernel_frame(device))
        elif name == "stress":
            write_png(out, stress_golden.render(device)[0])
        else:
            render_example(name, out, device, packs.get(name))
    if left_out:
        print(f"left out (no --<name>-pack given): {', '.join(left_out)}")
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
