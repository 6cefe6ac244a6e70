"""example-triangle on the port (counterpart of examples/triangle.py): the
minimum end-to-end slice, an in-code triangle mesh, one draw, a full
frame.

    python -m datum_tpu_torch.examples.triangle [--cpu] [--width 640 --height 352]
"""

import numpy as np

from .common import run_example


def init(args):
    from ..ops.common import FrameConfig
    from ..render.camera import Camera
    from ..render.context import RenderContext
    from ..render.types import RenderParams

    cfg = FrameConfig(width=args.width, height=args.height, max_vertices=256,
                      max_triangles=256, max_instances=4, bin_capacity=64,
                      big_capacity=8, enable_shadows=False)
    ctx = RenderContext(cfg, device=args.device)
    mesh = ctx.add_mesh(
        dict(position=np.array([[-1.5, -1, 0], [1.5, -1, 0], [0, 1.5, 0]], np.float32),
             normal=np.tile([0, 0, 1.0], (3, 1))),
        np.array([0, 1, 2]))
    mat = ctx.add_material(color=(1.0, 0.3, 0.1, 1), roughness=0.6)

    cam = Camera()
    cam.set_projection(np.radians(60), args.width / args.height)
    cam.lookat(np.array([0.0, 0.5, 4.0]), np.array([0.0, 0.0, 0.0]),
               np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=args.width, height=args.height)
    params.sundirection = np.array([0.2, -0.5, -1.0], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    return dict(ctx=ctx, mesh=mesh, mat=mat, cam=cam, params=params, t=0.0)


def update(state, dt):
    state["t"] += dt


def render(state):
    from ..math import Transform
    from ..render.renderlist import RenderList

    rl = RenderList()
    rl.push_mesh(state["mesh"], Transform.rotation([0, 1, 0], state["t"]),
                 state["mat"])
    return state["ctx"].render(state["cam"], rl, state["params"])


def main(argv=None):
    return run_example("triangle", init, update, render, argv=argv)


if __name__ == "__main__":
    main()
