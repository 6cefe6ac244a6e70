"""Render the dense-mesh, many-light stress golden frame through the
port (counterpart of datum_tpu/tools/stress_golden.py): ~30k triangles
of geomorphed terrain, a sphere wall and 64 clustered point lights at a
fixed 320x160 config on the deferred path (use_pallas off: the scan
raster and the XLA lighting, plain PyTorch on any device).

    python -m datum_tpu_torch.tools.stress_golden OUT_DIR [--cpu]

writes OUT_DIR/stress.png with the port's zlib PNG writer; never into
tests/golden/ unless given that directory (those PNGs are the JAX
package's frames and gate the port).
"""

from __future__ import annotations

import argparse
import os
import sys

CONFIG = dict(width=320, height=160, terrain_n=96, sphere_detail=20, grid=(6, 3),
              n_point_lights=64, skybox_size=16, max_vertices=1 << 16,
              max_triangles=1 << 16, big_capacity=32)


def render(device="cuda"):
    """Render CONFIG on device: (u8 numpy image, the frame's out dict)."""
    from ..render import frame as F
    from ..render.types import make_sceneset
    from ..scenes import stress_scene

    ctx, camera, params, make_rl = stress_scene(device=device, **CONFIG)
    rl = make_rl(0.0)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights)
    out = F.render_frame(ctx.config, ctx.host_state(), ctx.frame_draws(rl, camera), ss,
                         device=device)
    return out["image"].cpu().numpy(), out


def main(argv=None):
    from ..examples.common import write_png

    ap = argparse.ArgumentParser("datum_tpu_torch.tools.stress_golden")
    ap.add_argument("out_dir")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "stress.png")
    img, out = render("cpu" if args.cpu else "cuda")
    if int(out["bin_overflow"]) != 0:
        raise RuntimeError(f"stress golden: bin_overflow {int(out['bin_overflow'])}")
    write_png(path, img)
    print(f"stress golden -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
