"""example-city on the port (counterpart of examples/city.py): an ECS
scene with software occlusion culling.

A street of tall occluder buildings with props scattered behind and
between them.  Each frame fills the software OcclusionBuffer from the
occluder-flagged buildings and lets update_meshes() skip props that are
entirely hidden: the host never pushes them into the renderlist.  Two
axis gizmos are drawn over the frame, depth-tested against the scene.

    python -m datum_tpu_torch.examples.city [--cpu] [--width 640 --height 352]
"""

import numpy as np

from .common import run_example


def init(args):
    from ..math import Transform
    from ..ops.common import FrameConfig
    from ..render import primitives
    from ..render.camera import Camera
    from ..render.context import RenderContext
    from ..render.occlusion import OcclusionBuffer
    from ..render.types import RenderParams
    from ..scene import MESH_FLAG_OCCLUDER, MeshComponent, Scene, TransformComponent

    cfg = FrameConfig(width=args.width, height=args.height,
                      max_vertices=1 << 14, max_triangles=1 << 14,
                      max_instances=128, bin_capacity=2048, big_capacity=32,
                      enable_shadows=True, shadow_res=512,
                      shadow_bin_capacity=256)
    ctx = RenderContext(cfg, device=args.device)

    # transforms are rigid dual-quats (no scale): sizes are baked into the
    # mesh vertices
    bv, bi = primitives.unit_cube()
    bv = dict(bv, position=bv["position"]
              * np.array([3.0, 5.0, 3.5], np.float32))
    box = ctx.add_mesh(bv, bi)       # cube faces stay axis-aligned
    sv, si = primitives.unit_sphere(12, 6)
    sv = dict(sv, position=sv["position"] * 0.8)
    ball = ctx.add_mesh(sv, si)
    pv, pi = primitives.plane(120.0)
    ground = ctx.add_mesh(pv, pi)

    m_bldg = ctx.add_material(color=(0.55, 0.53, 0.5, 1), roughness=0.85)
    m_prop = ctx.add_material(color=(0.8, 0.25, 0.15, 1), roughness=0.4,
                              metalness=0.2)
    m_gnd = ctx.add_material(color=(0.35, 0.36, 0.38, 1), roughness=0.9)

    scene = Scene()

    def spawn(mesh, mat, pos, flags=0):
        e = scene.create_entity()
        scene.add_component(e, TransformComponent, Transform.translation(pos))
        scene.add_component(e, MeshComponent, mesh=mesh, material=mat,
                            flags=flags)
        return e

    # ground
    g = scene.create_entity()
    scene.add_component(g, TransformComponent, Transform.identity())
    scene.add_component(g, MeshComponent, mesh=ground, material=m_gnd)

    rng = np.random.RandomState(7)
    # two rows of buildings flanking a street down -Z; each is a
    # stretched cube and a registered occluder
    for side in (-1, 1):
        for k in range(6):
            z = -6.0 - 9.0 * k
            spawn(box, m_bldg, [side * 7.0, 5.0, z],
                  flags=MESH_FLAG_OCCLUDER)
    # props: spheres scattered across the block — most end up behind a
    # building from the street camera and get occlusion-culled
    for k in range(60):
        x = rng.uniform(-16, 16)
        z = rng.uniform(-60, 2)
        spawn(ball, m_prop, [x, 0.8, z])

    cam = Camera()
    cam.set_projection(np.radians(62), args.width / args.height)
    cam.lookat(np.array([0.0, 2.2, 6.0], np.float32),
               np.array([0.0, 2.0, -20.0], np.float32),
               np.array([0.0, 1.0, 0.0], np.float32))

    params = RenderParams(width=args.width, height=args.height)
    params.sundirection = np.array([-0.35, -0.75, -0.55], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    params.sunintensity = np.array([4.2, 4.0, 3.7], np.float32)
    params.skyintensity = np.array([0.5, 0.6, 0.8], np.float32)
    params.ambientintensity = 0.35

    return dict(ctx=ctx, scene=scene, cam=cam, params=params,
                occ=OcclusionBuffer(), t=0.0, stats=None)


def update(state, dt):
    state["t"] += dt


def render(state):
    from ..debug import timed_block
    from ..math import Transform
    from ..render import overlay
    from ..render.renderlist import RenderList
    from ..scene import MeshComponent, fill_occlusion, update_meshes

    scene, cam, ctx = state["scene"], state["cam"], state["ctx"]
    with timed_block("cull"):          # the host culling, in the debug ring
        fill_occlusion(scene, cam, ctx.pool, state["occ"])
        rl = RenderList()
        visible = update_meshes(scene, cam, renderlist=rl,
                                occlusion=state["occ"])
    if state["stats"] is None:
        total = len(list(scene.storage(MeshComponent).rows()))
        state["stats"] = (len(visible), total)
        print(f"city: {len(visible)}/{total} meshes after frustum + "
              "occlusion culling")
    img = ctx.render(cam, rl, state["params"]).copy()
    # depth-tested debug overlays: one gizmo in the open street (visible)
    # and one behind the first left building (its axes occlude where the
    # facade covers them)
    depth = None if ctx.last_depth is None else ctx.last_depth.cpu().numpy()
    vp = np.asarray(cam.viewproj(), np.float32)
    overlay.draw_gizmo(img, Transform.translation([0.0, 1.0, -3.0]), vp,
                       size=1.2, depth=depth)
    # this one sits behind the first left building: its +x axis pokes
    # past the facade edge while the rest stays hidden
    overlay.draw_gizmo(img, Transform.translation([-6.0, 1.5, -10.5]), vp,
                       size=3.5, depth=depth)
    return img


def main(argv=None):
    return run_example("city", init, update, render, width=640, height=352,
                       argv=argv)


if __name__ == "__main__":
    main()
