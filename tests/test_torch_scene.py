"""The port's scene systems against the JAX package's (CPU): bounds and
frusta, the camera, the ECS, the software occlusion buffer and the
culling systems (the city example: tests/test_torch_city.py).

Host code is numpy in both packages and is held exactly: the bound and
frustum tests, the camera's matrices and controls, entity ids with their
generations, the occlusion buffer (the port's numpy fill against both
of the JAX package's fills: its native scanline fill and its numpy
fill), the visible sets of update_meshes / update_actors and the draws
they push.
"""

import types

import numpy as np
import pytest
import torch

from datum_tpu.math import bound as jbound
from datum_tpu.math import transform as jtf
from datum_tpu.math.quaternion import quat_axis_angle
from datum_tpu.ops.common import FrameConfig as JaxFrameConfig
from datum_tpu.render import RenderContext as JaxRenderContext
from datum_tpu.render import camera as jcamera
from datum_tpu.render import occlusion as joccl
from datum_tpu.render import primitives as jprim
from datum_tpu.render.animation import Animation as JAnimation
from datum_tpu.render.animation import Animator as JAnimator
from datum_tpu.render.renderlist import RenderList as JRenderList
from datum_tpu import scene as jscene

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)
from test_torch_vertex_modes import _chain_animation

from datum_tpu_torch.math import bound
from datum_tpu_torch.math import transform as tf
from datum_tpu_torch.ops.common import FrameConfig
from datum_tpu_torch.render import camera
from datum_tpu_torch.render import occlusion
from datum_tpu_torch.render import primitives
from datum_tpu_torch.render.animation import Animation, Animator
from datum_tpu_torch.render.context import RenderContext
from datum_tpu_torch.render.renderlist import RenderList
from datum_tpu_torch import scene

# the two packages' modules, side by side
JAX = types.SimpleNamespace(bound=jbound, tf=jtf, camera=jcamera, occl=joccl,
                            prim=jprim, scene=jscene, RL=JRenderList,
                            Ctx=lambda cfg: JaxRenderContext(JaxFrameConfig(**cfg)),
                            Animator=JAnimator, Animation=JAnimation)
PORT = types.SimpleNamespace(bound=bound, tf=tf, camera=camera, occl=occlusion,
                             prim=primitives, scene=scene, RL=RenderList,
                             Ctx=lambda cfg: RenderContext(FrameConfig(**cfg), device="cpu"),
                             Animator=Animator, Animation=Animation)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# ---------------------------------------------------------------- bounds

def _boxes(rng, n=64):
    c = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    h = rng.uniform(0.1, 6, (n, 3)).astype(np.float32)
    return c - h, c + h


def test_bound_and_plane_equal_jax(rng):
    mins, maxs = _boxes(rng, 16)
    t = jtf.Transform.translation(rng.randn(3)) * jtf.Transform.rotation(
        rng.randn(3), 0.7)
    pt = tf.Transform.from_flat(t.flat())
    for i in range(16):
        a, b = jbound.Bound3(mins[i], maxs[i]), bound.Bound3(mins[i], maxs[i])
        _eq(a.centre, b.centre)
        _eq(a.halfdim, b.halfdim)
        assert a.radius == b.radius
        ta, tb = a.transformed(t), b.transformed(pt)
        _eq(ta.min, tb.min)
        _eq(ta.max, tb.max)
        a2, b2 = jbound.Bound3(mins[i - 1], maxs[i - 1]), bound.Bound3(mins[i - 1],
                                                                       maxs[i - 1])
        assert a.intersects(a2) == b.intersects(b2)
        assert a.contains(mins[i - 1]) == b.contains(mins[i - 1])
        for fa, fb in ((jbound.bound_union, bound.bound_union),):
            _eq(fa(a, a2).min, fb(b, b2).min)
            _eq(fa(a, a2).max, fb(b, b2).max)
        _eq(jbound.bound_expand(a, 0.25 * a.radius).max,
            bound.bound_expand(b, 0.25 * b.radius).max)
        sa, sb = jbound.Sphere(mins[i], 3.0), bound.Sphere(mins[i], 3.0)
        assert sa.intersects(jbound.Sphere(maxs[i - 1], 2.0)) == sb.intersects(
            bound.Sphere(maxs[i - 1], 2.0))
        p = rng.randn(3, 3).astype(np.float32)
        pa, pb = jbound.Plane.from_points(*p), bound.Plane.from_points(*p)
        _eq(pa.normal, pb.normal)
        assert pa.distance == pb.distance
        assert pa.signed_distance(maxs[i]) == pb.signed_distance(maxs[i])


def _cameras():
    cams = []
    for m in (jcamera, camera):
        c = m.Camera()
        c.set_projection(np.radians(62), 2.0, 0.1, 200.0)
        c.lookat(np.array([0.0, 2.2, 6.0], np.float32), np.array([3.0, 2.0, -20.0],
                                                                 np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
        cams.append(c)
    return cams


def test_frustum_equals_jax(rng):
    jc, tc = _cameras()
    fa, fb = jc.frustum(), tc.frustum()
    _eq(fa.planes, fb.planes)
    _eq(jc.frustum(1.0, 50.0).planes, tc.frustum(1.0, 50.0).planes)
    mins, maxs = _boxes(rng, 256)
    va, vb = fa.intersects_bounds(mins, maxs), fb.intersects_bounds(mins, maxs)
    _eq(va, vb)
    assert 0 < vb.sum() < len(vb)
    for i in range(64):
        ba, bb = jbound.Bound3(mins[i], maxs[i]), bound.Bound3(mins[i], maxs[i])
        assert fa.intersects_bound(ba) == fb.intersects_bound(bb) == va[i]
        assert fa.contains_point(mins[i]) == fb.contains_point(mins[i])
        assert fa.intersects_sphere(maxs[i], 2.5) == fb.intersects_sphere(maxs[i], 2.5)


def test_camera_matrices_and_controls_equal_jax():
    """proj (infinite and with zfar), view, viewproj, the frame vectors,
    and a run of the controls: move, offset, rotate, roll, pitch, yaw
    (own and world up), pan, dolly, orbit; set_exposure and adapt."""
    jc, tc = _cameras()

    def same():
        _eq(jc.position, tc.position)
        _eq(jc.rotation, tc.rotation)
        for m in ("view", "viewproj", "right", "up", "forward"):
            _eq(getattr(jc, m)(), getattr(tc, m)())
        _eq(jc.proj(), tc.proj())
        _eq(jc.proj(infinite=False), tc.proj(infinite=False))

    same()
    target = np.array([1.0, 0.5, -4.0], np.float32)
    q = quat_axis_angle([0.3, 1.0, 0.2], 0.4)
    steps = [("move", ([0.5, -0.2, 1.0],)), ("offset", ([0.2, 0.1, -0.7],)),
             ("rotate", (q,)), ("roll", (0.1,)), ("pitch", (-0.2,)), ("yaw", (0.3,)),
             ("yaw", (0.25, np.array([0, 1.0, 0], np.float32))),
             ("pan", (target, 0.4, -0.3)), ("dolly", (target, 1.5)),
             ("orbit", (target, quat_axis_angle([0, 1.0, 0], 0.8)))]
    for name, args in steps:
        ra = getattr(jc, name)(*args)
        rb = getattr(tc, name)(*args)
        if ra is not None:
            _eq(ra, rb)
        same()
    for lum in (0.05, 0.18, 2.0, 40.0):
        jcamera.adapt(jc, lum)
        camera.adapt(tc, lum)
        assert jc.exposure == tc.exposure
    jc.set_exposure(2.5)
    tc.set_exposure(2.5)
    assert jc.exposure == tc.exposure == 2.5


# ------------------------------------------------------------------- ECS

def _ecs_script(m):
    """One run of entity and component operations; returns what it saw."""
    S, sc = m.scene.Scene, m.scene
    s = S()
    seen = []
    ents = [s.create_entity() for _ in range(6)]
    tcs = [s.add_component(e, sc.TransformComponent,
                           m.tf.Transform.translation([i, 2.0 * i, -i]))
           for i, e in enumerate(ents)]
    s.add_component(ents[1], sc.TransformComponent, m.tf.Transform.rotation(
        [0, 1.0, 0], 0.3), parent=tcs[0])
    tcs[1] = s.get_component(ents[1], sc.TransformComponent)
    tcs[2].set_parent(tcs[1])
    tcs[3].set_parent(tcs[2])
    for i, e in enumerate(ents):
        s.add_component(e, sc.NameComponent, f"e{i}")
        if i % 2 == 0:
            s.add_component(e, sc.PointLightComponent, intensity=(i, 1, 1),
                            attenuation=(0.1 * (i + 1), 0.2, 1.0))
    s.add_component(ents[5], sc.SpotLightComponent, intensity=(2, 2, 2),
                    attenuation=(0.05, 0.1, 1.0, 0.0), cutoff=0.8, range_=12.0)
    seen.append([tc.world.flat().tolist() for tc in tcs])
    tcs[0].set_local(m.tf.Transform.translation([5.0, 0, 0]))      # invalidates down
    seen.append([tc.world.flat().tolist() for tc in tcs])
    s.destroy_entity(ents[2])                 # children re-root at their world pose
    seen.append([(e.index, e.generation, s.valid(e)) for e in ents])
    seen.append(tcs[3].parent is None)
    seen.append(tcs[3].world.flat().tolist())
    s.destroy_entity(ents[2])                 # a stale id: nothing happens
    e6, e7 = s.create_entity(), s.create_entity()     # reuses slot 2
    seen.append([(e.index, e.generation) for e in (e6, e7)])
    seen.append(s.valid(ents[2]))
    s.remove_component(ents[0], sc.NameComponent)
    seen.append([(e.index, e.generation) for e in s.entities_with(sc.NameComponent)])
    seen.append([c.name for c in s.storage(sc.NameComponent).rows()])
    seen.append([(e.index, e.generation) for e in s.entities_with(sc.PointLightComponent)])
    seen.append(s.storage(sc.PointLightComponent).column("attenuation").tolist())
    seen.append(s.has_component(e6, sc.NameComponent))
    rl = m.RL()
    sc.systems.gather_lights(s, rl)
    seen.append(repr([(np.asarray(p["position"]).tolist(), np.asarray(
        p["attenuation"]).tolist()) for p in rl.point_lights]))
    seen.append(repr([np.asarray(p["direction"]).tolist() for p in rl.spot_lights]))
    return seen


def test_ecs_equals_jax():
    """Create, parent, invalidate, destroy (re-rooting the children,
    bumping the generation), reuse a slot, swap-remove a component,
    query storages and gather the lights: the same in both packages."""
    a, b = _ecs_script(JAX), _ecs_script(PORT)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y


def test_add_component_to_a_dead_entity_raises():
    s = scene.Scene()
    e = s.create_entity()
    s.destroy_entity(e)
    with pytest.raises(ValueError, match="not a live entity"):
        s.add_component(e, scene.NameComponent, "x")


# --------------------------------------------------------- occlusion

def _viewproj():
    return np.asarray(_cameras()[1].viewproj(), np.float32)


@pytest.mark.parametrize("jax_fill", ["native", "numpy"])
def test_occlusion_buffer_equals_jax(rng, monkeypatch, jax_fill):
    """Seeded occluder triangles (some crossing the camera plane or off
    screen) filled by the port's numpy fill and by the JAX package's
    native or numpy fill: the same buffer; then visible() on seeded
    boxes."""
    if jax_fill == "numpy":
        monkeypatch.setattr(joccl, "_native_lib", None)
    else:
        assert joccl._native_occlusion() is not None, "the native library is not built"
    vp = _viewproj()
    a, b = joccl.OcclusionBuffer(), occlusion.OcclusionBuffer()
    for k in range(6):
        pos = (rng.uniform(-20, 20, (30, 3)) + [0, 0, -15 - 5 * k]).astype(np.float32)
        tris = rng.randint(0, 30, (20, 3))
        a.fill_elements(vp, pos, tris)
        b.fill_elements(vp, pos, tris.reshape(-1))
    assert (b.depth > 0).mean() > 0.2
    _eq(a.depth, b.depth)
    mins, maxs = _boxes(rng, 128)
    va = [a.visible(mins[i], maxs[i], vp) for i in range(128)]
    vb = [b.visible(mins[i], maxs[i], vp) for i in range(128)]
    assert va == vb and 0 < sum(vb) < 128
    b.clear()
    assert not b.depth.any()


def _wall_scene(m):
    """tests/test_scene.py's occlusion scene: an occluder wall facing the
    camera, a ball behind it, a ball in front, one off to the side."""
    ctx = m.Ctx(dict(width=128, height=64, max_vertices=4096, max_triangles=4096,
                     max_instances=8, bin_capacity=32, big_capacity=8))
    pv, pi = m.prim.plane(20.0)
    wall = ctx.add_mesh(pv, pi)
    sv, si = m.prim.unit_sphere(8, 4)
    ball = ctx.add_mesh(sv, si)
    s = m.scene.Scene()
    cam = m.camera.Camera()
    cam.set_projection(np.radians(60), 16 / 9)
    cam.lookat(np.array([0.0, 0, 10]), np.array([0.0, 0, 0]), np.array([0.0, 1, 0]))

    def make(mesh, pos, flags=0, rot=None):
        e = s.create_entity()
        t = m.tf.Transform.translation(pos)
        if rot is not None:
            t = t * rot
        s.add_component(e, m.scene.TransformComponent, t)
        return s.add_component(e, m.scene.MeshComponent, mesh=mesh, material=1, flags=flags)

    face = m.tf.Transform.rotation([1.0, 0.0, 0.0], np.radians(90))
    make(wall, [0, 0, 0], flags=m.scene.MESH_FLAG_OCCLUDER, rot=face)
    for p in ([0, 0, -6], [0, 0, 5], [9, 1, -3], [40, 0, -5], [-4, 3, -2]):
        make(ball, p)
    e = s.create_entity()                    # a placeholder without a mesh
    s.add_component(e, m.scene.TransformComponent, m.tf.Transform.identity())
    s.add_component(e, m.scene.MeshComponent)
    return ctx, s, cam


@pytest.mark.parametrize("occluded", [False, True])
def test_update_meshes_equals_jax(occluded):
    out = []
    for m in (JAX, PORT):
        ctx, s, cam = _wall_scene(m)
        buf = None
        if occluded:
            buf = m.occl.OcclusionBuffer()
            m.scene.fill_occlusion(s, cam, ctx.pool, buf)
        rl = m.RL()
        vis = m.scene.update_meshes(s, cam, renderlist=rl, occlusion=buf)
        out.append((buf, [c.entity.index for c in vis],
                    [(c.world_bound.min, c.world_bound.max) for c in vis],
                    rl.draw_arrays(8, 0)))
    (ba, va, wa, da), (bb, vb, wb, db) = out
    assert va == vb
    assert 0 in vb and 2 in vb and 4 not in vb and 6 not in vb
    assert (1 not in vb) if occluded else (1 in vb)     # behind the wall
    for (a0, a1), (b0, b1) in zip(wa, wb):
        _eq(a0, b0)
        _eq(a1, b1)
    for k in da:
        _eq(da[k], db[k])
    if occluded:
        _eq(ba.depth, bb.depth)
        assert bb.depth.max() > 0


def test_update_actors_equals_jax():
    """An animated actor in view, one behind the camera and one without
    an animator: the visible set (its bound inflated by 25% of its
    radius), the animators advanced only when visible, and the pushed
    draws with their palettes."""
    rng = np.random.RandomState(11)
    joints = [("root", 0), ("mid", 0), ("tip", 1)]
    clip = _chain_animation(rng, joints, 5, 1.0, [0, 0, 1.0])
    bones = [(n, jtf.Transform.translation(rng.randn(3)).flat()) for n, _ in joints]
    out = []
    for m in (JAX, PORT):
        ctx = m.Ctx(dict(max_vertices=4096, max_triangles=4096))
        sv, si = m.prim.unit_sphere(8, 4)
        mesh = ctx.add_mesh(sv, si)
        s = m.scene.Scene()
        cam = m.camera.Camera()
        cam.lookat(np.array([0.0, 1, 8]), np.array([0.0, 0, 0]), np.array([0.0, 1, 0]))
        comps = []
        for pos, animated in (([0, 0, 0], True), ([0, 0, 30], True), ([2, 0, -3], False)):
            e = s.create_entity()
            s.add_component(e, m.scene.TransformComponent, m.tf.Transform.translation(pos))
            an = None
            if animated:
                an = m.Animator(bones)
                an.play(m.Animation(*clip), weight=1.0, rate=1.0, looping=True)
            comps.append(s.add_component(e, m.scene.ActorComponent, mesh=mesh,
                                         material=1, animator=an))
        rl = m.RL()
        vis = None
        for _ in range(3):
            rl = m.RL()
            vis = m.scene.update_actors(s, cam, 0.1, renderlist=rl)
        out.append(([c.entity.index for c in vis], rl.draw_arrays(4, 0, max_palettes=4,
                                                                 max_bones=8),
                    [c.animator.palette() for c in comps if c.animator is not None]))
    (va, da, pa), (vb, db, pb) = out
    assert va == vb == [0, 2]
    for k in da:
        _eq(da[k], db[k])
    for x, y in zip(pa, pb):
        _eq(x, y)
    assert not np.allclose(pb[0], pb[1])          # only the visible one advanced
