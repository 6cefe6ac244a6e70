"""Render the megakernel-path golden frame through the port (counterpart
of datum_tpu/tools/megakernel_golden.py): the fast path (K1, K2 and its
epilogue, K3, K4) with the bench's feature set at 256x128: clustered
lights, a shadowed spot, SSAO, the froxel fog, SSR, particles, the lit
glass and water at half resolution, decals.

    python -m datum_tpu_torch.tools.megakernel_golden OUT_DIR [--cpu]

writes OUT_DIR/megakernel.png with the port's zlib PNG writer.  It never
writes into tests/golden/ unless given that directory: the PNGs there
are the JAX package's frames, and they gate the port.
"""

from __future__ import annotations

import argparse
import os
import sys

CONFIG = dict(width=256, height=128, sphere_detail=8, grid=(3, 2), n_point_lights=4,
              skybox=True, skybox_size=16, max_vertices=4096, max_triangles=4096,
              max_instances=16, bin_capacity=128, big_capacity=32, use_pallas=True,
              enable_material_maps=True, texture_filter="mip_half", enable_ssao=True,
              enable_fog=True, enable_ssr=True, enable_shadows=True, shadow_res=128,
              shadow_bin_capacity=128, max_spot_shadows=1, spot_shadow_res=128,
              max_particle_quads=64, max_translucent_draws=2, max_translucent_tris=1024,
              max_decals_active=2, use_light_clusters=True, translucent_lit_scale=2)


def render_megakernel_frame(device="cuda"):
    """The (128, 256, 3) u8 numpy frame of CONFIG on device."""
    from ..render import frame as F
    from ..render.types import make_sceneset
    from ..scenes import datumtest_scene

    ctx, camera, params, make_rl = datumtest_scene(device=device, **CONFIG)
    rl = make_rl(0.0)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights)
    out = F.render_frame(ctx.config, ctx.host_state(), ctx.frame_draws(rl, camera), ss,
                         device=device)
    if int(out["bin_overflow"]) != 0:
        raise RuntimeError(f"megakernel golden: bin_overflow {int(out['bin_overflow'])}")
    return out["image"].cpu().numpy()


def main(argv=None):
    from ..examples.common import write_png

    ap = argparse.ArgumentParser("datum_tpu_torch.tools.megakernel_golden")
    ap.add_argument("out_dir")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "megakernel.png")
    img = render_megakernel_frame("cpu" if args.cpu else "cuda")
    write_png(path, img)
    print(f"saved {path} {img.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
