"""example-skybox on the port (counterpart of examples/skybox.py): the
procedural sky re-baked as the sun swings (render_skybox on the
context's device every 8th step), lighting a chrome sphere and a
reflective floor through the IBL environment.

    python -m datum_tpu_torch.examples.skybox [--cpu] [--width 640 --height 352]
"""

import numpy as np

from .common import run_example


def init(args):
    from ..ops.common import FrameConfig
    from ..render import primitives
    from ..render.camera import Camera
    from ..render.context import RenderContext
    from ..render.skybox import SkyBox
    from ..render.types import RenderParams

    cfg = FrameConfig(width=args.width, height=args.height,
                      max_vertices=4096, max_triangles=4096, max_instances=8,
                      bin_capacity=256, big_capacity=16, enable_shadows=False)
    ctx = RenderContext(cfg, device=args.device)
    skybox = SkyBox(size=64, convolve_samples=16, device=ctx.device)
    ctx.set_skybox(skybox)
    sv, si = primitives.unit_sphere(24, 12)
    sphere = ctx.add_mesh(sv, si)
    pv, pi = primitives.plane(20.0, 4.0)
    floor = ctx.add_mesh(pv, pi)
    chrome = ctx.add_material(color=(0.95, 0.95, 0.95, 1), metalness=1.0,
                              roughness=0.08)
    ground = ctx.add_material(color=(0.4, 0.38, 0.35, 1), roughness=0.5,
                              reflectivity=0.7)

    cam = Camera()
    cam.set_projection(np.radians(60), args.width / args.height)
    cam.lookat(np.array([0.0, 2.0, 7.0]), np.array([0.0, 1.0, 0.0]),
               np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=args.width, height=args.height)
    return dict(ctx=ctx, skybox=skybox, sphere=sphere, floor=floor,
                chrome=chrome, ground=ground, cam=cam, params=params, t=0.0)


def update(state, dt):
    # t is a Python float: the steps that re-bake are the reference's
    state["t"] += dt
    if int(state["t"] * 60) % 8 == 0:
        from ..render.skybox import render_skybox

        ang = 0.6 + 0.1 * np.sin(state["t"])
        sd = np.array([-np.cos(ang), -np.sin(ang), -0.5], np.float32)
        sd /= np.linalg.norm(sd)
        p = state["skybox"].params
        p.sundirection = tuple(sd)
        ctx = state["ctx"]
        render_skybox(state["skybox"], p, device=ctx.device)
        ctx.set_skybox(state["skybox"])
        state["params"].sundirection = sd
        state["params"].sunintensity = np.array([6.0, 5.7, 5.2], np.float32)


def render(state):
    from ..math import Transform
    from ..render.renderlist import RenderList

    rl = RenderList()
    rl.push_mesh(state["floor"], Transform.identity(), state["ground"])
    rl.push_mesh(state["sphere"], Transform.translation([0, 1.2, 0]),
                 state["chrome"])
    return state["ctx"].render(state["cam"], rl, state["params"])


def main(argv=None):
    return run_example("skybox", init, update, render, argv=argv)


if __name__ == "__main__":
    main()
