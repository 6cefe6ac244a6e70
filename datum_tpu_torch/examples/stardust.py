"""example-stardust on the port (counterpart of examples/stardust.py): four
1024-particle systems, each stepped on the platform's worker pool (one
work item a system, joined before the frame), drawn as emissive
billboards through the weighted-blend OIT pass, with bloom.

    python -m datum_tpu_torch.examples.stardust [--cpu] [--width 640 --height 352]
"""

import numpy as np

from .common import run_example


def init(args):
    from ..math import Transform
    from ..ops.common import FrameConfig
    from ..platform import Platform
    from ..render.camera import Camera
    from ..render.context import RenderContext
    from ..render.particlesystem import Distribution, ParticleEmitter, ParticleSystem
    from ..render.types import RenderParams

    cfg = FrameConfig(width=args.width, height=args.height,
                      max_vertices=256, max_triangles=256, max_instances=4,
                      bin_capacity=2048, big_capacity=64,
                      enable_shadows=False, max_particle_quads=4096,
                      enable_bloom=True)
    ctx = RenderContext(cfg, device=args.device)
    platform = Platform(workers=4)

    systems = []
    for k in range(4):       # 4 systems updated on worker threads
        ps = ParticleSystem(maxparticles=1024, emitters=[ParticleEmitter(
            rate=400.0, life=Distribution.uniform(2.0, 5.0),
            velocity=Distribution.uniform(0.2, 1.2), shape="sphere",
            shape_radius=6.0,
            size=Distribution.uniform(0.03, 0.10),
            color=Distribution.uniform([1.0, 0.7, 0.2, 0.3], [4.0, 2.5, 1.0, 0.8]),
            acceleration=np.array([0, 0.05, 0], np.float32),
            rotate_over_life=Distribution.constant(1.0))])
        systems.append((ps, ps.create(seed=k), Transform.translation(
            [(k % 2) * 6 - 3.0, 0.0, (k // 2) * 6 - 3.0])))

    cam = Camera()
    cam.set_projection(np.radians(60), args.width / args.height)
    cam.lookat(np.array([0.0, 3.0, 14.0]), np.array([0.0, 0.5, 0.0]),
               np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=args.width, height=args.height)
    params.sunintensity = np.zeros(3, np.float32)
    params.ambientintensity = 0.0
    return dict(ctx=ctx, platform=platform, systems=systems, cam=cam,
                params=params)


def update(state, dt):
    # fan the particle updates out to the worker pool, then join; each
    # system owns its instance and generator, so thread order moves no value
    plat = state["platform"]
    for ps, inst, tf in state["systems"]:
        plat.submit_work(ps.update, inst, dt, tf)
    plat.workqueue.wait(len(state["systems"]))


def render(state):
    from ..render.renderlist import RenderList

    rl = RenderList()
    for ps, inst, tf in state["systems"]:
        rl.push_particles(inst)
    return state["ctx"].render(state["cam"], rl, state["params"])


def main(argv=None):
    return run_example("stardust", init, update, render, argv=argv)


if __name__ == "__main__":
    main()
