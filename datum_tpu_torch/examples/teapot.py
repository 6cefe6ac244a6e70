"""example-teapot on the port (counterpart of examples/teapot.py): a mesh
read from a pack (its asset 0), a PBR material, a floor and sun shadows.

    python -m datum_tpu_torch.examples.teapot --pack PATH [--cpu]

--pack is required: any pack whose asset 0 is a mesh will do (the
reference engine's bin/teapot.pack, which the JAX example reads, or one
that tools/objparser.py writes from an OBJ).
"""

import numpy as np

from .common import run_example


def init(args):
    from ..asset import PackReader
    from ..ops.common import FrameConfig
    from ..render import primitives
    from ..render.camera import Camera
    from ..render.context import RenderContext
    from ..render.types import RenderParams

    cfg = FrameConfig(width=args.width, height=args.height,
                      max_vertices=1 << 14, max_triangles=1 << 14,
                      max_instances=8, bin_capacity=1024, big_capacity=16,
                      shadow_res=512, shadow_bin_capacity=256)
    ctx = RenderContext(cfg, device=args.device)
    pack = PackReader(args.pack)
    m = pack.mesh(0)
    teapot = ctx.add_mesh(m["vertices"], m["indices"],
                          mincorner=m["mincorner"], maxcorner=m["maxcorner"])
    pv, pi = primitives.plane(12.0, 6.0)
    floor = ctx.add_mesh(pv, pi)
    mat = ctx.add_material(color=(0.7, 0.2, 0.15, 1), metalness=0.2, roughness=0.35)
    fmat = ctx.add_material(color=(0.6, 0.6, 0.62, 1), roughness=0.8)

    centre = 0.5 * (m["mincorner"] + m["maxcorner"])
    size = float(np.linalg.norm(m["maxcorner"] - m["mincorner"]))
    cam = Camera()
    cam.set_projection(np.radians(60), args.width / args.height)
    cam.lookat(centre + np.array([0.6 * size, 0.5 * size, size], np.float32),
               centre, np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=args.width, height=args.height)
    params.sundirection = np.array([-0.5, -0.8, -0.3], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    params.sunintensity = np.array([4.0, 3.9, 3.6], np.float32)
    params.ambientintensity = 0.35
    return dict(ctx=ctx, teapot=teapot, floor=floor, mat=mat, fmat=fmat,
                cam=cam, params=params, t=0.0,
                floor_y=float(m["mincorner"][1]))


def update(state, dt):
    state["t"] += dt


def render(state):
    from ..math import Transform
    from ..render.renderlist import RenderList

    rl = RenderList()
    rl.push_mesh(state["floor"], Transform.translation([0, state["floor_y"], 0]),
                 state["fmat"])
    rl.push_mesh(state["teapot"], Transform.rotation([0, 1, 0], 0.5 * state["t"]),
                 state["mat"])
    return state["ctx"].render(state["cam"], rl, state["params"])


def main(argv=None):
    return run_example("teapot", init, update, render, argv=argv,
                       options=[("--pack", dict(required=True,
                                                help="the pack to read (asset 0: a mesh)"))])


if __name__ == "__main__":
    main()
