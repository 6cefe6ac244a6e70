"""example-character on the port (counterpart of examples/character.py):
a rigged mesh read from a pack (its asset 1, with its bone table) under
an Animator playing the pack's clips 2, 3 and 4, crossfading the first
two over time.

    python -m datum_tpu_torch.examples.character --pack PATH [--cpu]

--pack is required: the reference engine's bin/character.pack, which the
JAX example reads, or a pack laid out the same way (packscene.py's
write_character writes one).
"""

import numpy as np

from .common import run_example


def init(args):
    from ..asset import PackReader
    from ..ops.common import FrameConfig
    from ..render import primitives
    from ..render.animation import Animation, Animator
    from ..render.camera import Camera
    from ..render.context import RenderContext
    from ..render.types import RenderParams

    cfg = FrameConfig(width=args.width, height=args.height,
                      max_vertices=1 << 14, max_triangles=1 << 14,
                      max_instances=4, bin_capacity=4096, big_capacity=16,
                      enable_shadows=False, enable_skinning=True,
                      max_palettes=4, max_bones=128)
    ctx = RenderContext(cfg, device=args.device)
    pack = PackReader(args.pack)
    md = pack.mesh(1)
    mesh = ctx.add_mesh(md["vertices"], md["indices"],
                        mincorner=md["mincorner"], maxcorner=md["maxcorner"],
                        rig=md["rig"])
    pv, pi = primitives.plane(8.0, 4.0)
    floor = ctx.add_mesh(pv, pi)
    mat = ctx.add_material(color=(0.75, 0.6, 0.5, 1), roughness=0.6)
    fmat = ctx.add_material(color=(0.45, 0.45, 0.48, 1), roughness=0.8)

    animator = Animator(md["bones"])
    channels = []
    for aid in (2, 3, 4):   # the idle / walk / run clips of the pack
        anim = Animation.from_asset(pack.animation(aid))
        channels.append(animator.play(anim, weight=0.0, rate=1.0))
    channels[0].weight = 1.0

    centre = 0.5 * (md["mincorner"] + md["maxcorner"])
    size = float(np.linalg.norm(md["maxcorner"] - md["mincorner"]))
    cam = Camera()
    cam.set_projection(np.radians(55), args.width / args.height)
    cam.lookat(centre + np.array([0.3 * size, 0.25 * size, 1.1 * size], np.float32),
               centre, np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=args.width, height=args.height)
    params.sundirection = np.array([-0.4, -0.8, -0.45], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    params.sunintensity = np.array([3.6, 3.5, 3.3], np.float32)
    params.ambientintensity = 0.4
    return dict(ctx=ctx, mesh=mesh, floor=floor, mat=mat, fmat=fmat,
                animator=animator, channels=channels, cam=cam, params=params,
                t=0.0)


def update(state, dt):
    state["t"] += dt
    # crossfade idle -> walk over time
    blend = min(max(np.sin(state["t"] * 0.5) + 0.5, 0.0), 1.0)
    state["channels"][0].weight = 1.0 - blend
    state["channels"][1].weight = blend
    state["animator"].update(dt)


def render(state):
    from ..math import Transform
    from ..render.renderlist import RenderList

    rl = RenderList()
    rl.push_mesh(state["floor"], Transform.identity(), state["fmat"])
    rl.push_actor(state["mesh"], Transform.identity(), state["mat"],
                  state["animator"].palette())
    return state["ctx"].render(state["cam"], rl, state["params"])


def main(argv=None):
    return run_example("character", init, update, render, width=384, height=384,
                       argv=argv, options=[("--pack", dict(
                           required=True, help="the pack to read (asset 1: a "
                           "rigged mesh; assets 2-4: its clips)"))])


if __name__ == "__main__":
    main()
