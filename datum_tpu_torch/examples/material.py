"""example-material on the port (counterpart of examples/material.py): a
4x6 PBR sphere grid sweeping metalness and roughness, with depth of
field and a warm colour-grading LUT.

    python -m datum_tpu_torch.examples.material [--cpu] [--width 640 --height 352]
"""

import numpy as np

from .common import run_example


def init(args):
    from ..ops.common import FrameConfig
    from ..render import primitives
    from ..render.camera import Camera
    from ..render.context import RenderContext
    from ..render.types import RenderParams

    cfg = FrameConfig(width=args.width, height=args.height,
                      max_vertices=1 << 15, max_triangles=1 << 15,
                      max_instances=32, bin_capacity=512, big_capacity=16,
                      enable_shadows=False, enable_depth_of_field=True,
                      enable_color_grading=True)
    ctx = RenderContext(cfg, device=args.device)
    # warm grading LUT
    g = np.linspace(0, 1, 16)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")
    lut = np.stack([np.clip(r * 1.08, 0, 1), gg, b * 0.92], -1).astype(np.float32)
    ctx.set_colorlut(lut)

    sv, si = primitives.unit_sphere(20, 10)
    sphere = ctx.add_mesh(sv, si)
    mats = []
    for j in range(4):
        for i in range(6):
            mats.append(ctx.add_material(
                color=(0.85, 0.45, 0.2, 1), metalness=j / 3,
                roughness=max(i / 5, 0.05)))
    cam = Camera()
    cam.set_projection(np.radians(55), args.width / args.height)
    cam.lookat(np.array([0.0, 1.0, 12.0]), np.array([0.0, 0.0, 0.0]),
               np.array([0.0, 1.0, 0.0]))
    cam.set_depth_of_field(4.0, 12.0)
    params = RenderParams(width=args.width, height=args.height)
    params.sundirection = np.array([-0.4, -0.7, -0.6], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    params.sunintensity = np.array([3.5, 3.4, 3.2], np.float32)
    params.ambientintensity = 0.6
    return dict(ctx=ctx, sphere=sphere, mats=mats, cam=cam, params=params, t=0.0)


def update(state, dt):
    state["t"] += dt


def render(state):
    from ..math import Transform
    from ..render.renderlist import RenderList

    rl = RenderList()
    k = 0
    for j in range(4):
        for i in range(6):
            rl.push_mesh(state["sphere"],
                         Transform.translation([(i - 2.5) * 2.2, (j - 1.5) * 2.2, 0]),
                         state["mats"][k])
            k += 1
    return state["ctx"].render(state["cam"], rl, state["params"])


def main(argv=None):
    return run_example("material", init, update, render, argv=argv)


if __name__ == "__main__":
    main()
