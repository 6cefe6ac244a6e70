"""datumtest on the port (counterpart of examples/datumtest.py): the
kitchen-sink scene (scenes.datumtest_scene: the roughness x metalness
sphere grid, the floor, point lights, the glass, water and decal set,
the particle cloud) with a live cone-emitter particle system, a
shadowed spot light and auto-exposure from the last frame's luminance.

    python -m datum_tpu_torch.examples.datumtest [--cpu] [--width 640 --height 352]
"""

from .common import run_example

# the example's scene arguments (scenes.datumtest_scene at the frame size)
SCENE = dict(
    sphere_detail=20, n_point_lights=8, max_vertices=1 << 15,
    max_triangles=1 << 15, big_capacity=32,
    # mip-filtered material maps
    enable_material_maps=True, texture_filter="mip",
    max_particle_quads=512, max_spot_shadows=1, spot_shadow_res=256,
    # the forward content: glass and water blend as WBOIT, decals apply
    # in the deferred resolve
    max_translucent_draws=2, max_translucent_tris=2048, max_decals_active=2)
# where the live particle system's emitter stands
EMITTER = (6.0, 0.2, 2.0)


def particle_system():
    """The example's live system: a 400-particle cone emitter at 120 a
    second."""
    from ..render.particlesystem import Distribution, ParticleEmitter, ParticleSystem

    return ParticleSystem(maxparticles=400, emitters=[ParticleEmitter(
        rate=120.0, life=Distribution.uniform(1.0, 2.5),
        velocity=Distribution.uniform(1.0, 3.0), shape="cone", shape_angle=0.4,
        size=Distribution.uniform(0.05, 0.15),
        color=Distribution.uniform([2.0, 1.0, 0.2, 0.4], [5.0, 2.0, 0.5, 0.8]))])


def init(args):
    from ..math import Transform
    from ..scenes import datumtest_scene

    ctx, camera, params, make_rl = datumtest_scene(
        width=args.width, height=args.height, device=args.device, **SCENE)
    ps = particle_system()
    inst = ps.create(seed=2)
    return dict(ctx=ctx, camera=camera, params=params, make_rl=make_rl,
                ps=ps, inst=inst, t=0.0,
                emitter_tf=Transform.translation(EMITTER))


def update(state, dt):
    from ..render.camera import adapt

    state["t"] += dt
    state["ps"].update(state["inst"], dt, state["emitter_tf"])
    # auto-exposure from the last frame's luminance
    adapt(state["camera"], state["ctx"].luminance, targetluminance=0.4)


def render(state):
    rl = state["make_rl"](state["t"])
    rl.push_particles(state["inst"])
    rl.push_spotlight([4.0, 6.0, 4.0], [-0.4, -1.0, -0.4], [120.0, 110.0, 90.0],
                      cutoff=0.75, attenuation=(1.0, 0.0, 1.0), range_=25.0)
    return state["ctx"].render(state["camera"], rl, state["params"])


def main(argv=None):
    return run_example("datumtest", init, update, render, width=640, height=352,
                       argv=argv)


if __name__ == "__main__":
    main()
