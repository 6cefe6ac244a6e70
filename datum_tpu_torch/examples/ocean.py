"""example-ocean on the port (counterpart of examples/ocean.py): the FFT
water surface through the dynamic-vertex slab, with bloom.

    python -m datum_tpu_torch.examples.ocean [--cpu] [--width 640 --height 352]
"""

import numpy as np

from .common import run_example


def init(args):
    from ..ops.common import FrameConfig
    from ..render.camera import Camera
    from ..render.context import RenderContext
    from ..render.ocean import Ocean, OceanParams
    from ..render.types import RenderParams

    cfg = FrameConfig(width=args.width, height=args.height,
                      max_vertices=1 << 14, max_triangles=1 << 15,
                      max_instances=4, big_capacity=64,
                      enable_shadows=False, max_dynamic_vertices=1 << 14,
                      enable_bloom=True)
    ctx = RenderContext(cfg, device=args.device)
    ocean = Ocean(ctx, grid=96, patch_size=64.0,
                  params=OceanParams(wind=(9.0, 3.0), choppiness=1.6,
                                     swellamplitude=0.4))
    water = ctx.add_material(color=(0.07, 0.22, 0.36, 1), metalness=0.0,
                             roughness=0.1, reflectivity=0.9)
    cam = Camera()
    cam.set_projection(np.radians(60), args.width / args.height)
    cam.lookat(np.array([32.0, 16.0, 78.0]), np.array([32.0, 0.0, 32.0]),
               np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=args.width, height=args.height)
    params.sundirection = np.array([-0.4, -0.5, -0.75], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    params.sunintensity = np.array([5.0, 4.7, 4.2], np.float32)
    params.ambientintensity = 0.5
    return dict(ctx=ctx, ocean=ocean, water=water, cam=cam, params=params)


def update(state, dt):
    state["ocean"].update(dt)


def render(state):
    from ..math import Transform
    from ..render.ocean import render_ocean_surface
    from ..render.renderlist import RenderList

    rl = RenderList()
    render_ocean_surface(state["ocean"], rl, Transform.identity(), state["water"])
    return state["ctx"].render(state["cam"], rl, state["params"])


def main(argv=None):
    return run_example("ocean", init, update, render, argv=argv)


if __name__ == "__main__":
    main()
