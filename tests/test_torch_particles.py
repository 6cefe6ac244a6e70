"""The port's particle system against the JAX package (CPU, numpy on both
sides).

- Distribution.sample and evaluate, for each kind: exact (the same
  RandomState draws, the same float32 arithmetic).
- ParticleSystem.update over 30 steps of 1/60 s from one seed, array for
  array, in each configuration below and in both of the JAX package's
  integration routes (its native fused pass when the helper library
  loads, its numpy masked updates with
  datum_tpu.render.particlesystem._native_lib forced to None): exact.
- update_particlesystems with one component in the frustum and one
  culled: the same components visible, the same instances, exactly.
- RenderList.forward_arrays for an 8000-particle burst (above the 4096
  quads where the JAX package switches to its native billboard helper),
  against both JAX routes: positions within atol 1e-5 (cos/sin of two
  libraries), quad_count, uv and colour exact.
"""

import numpy as np
import pytest

import datum_tpu.render.particlesystem as JPS
from datum_tpu.math import Transform as JTransform
from datum_tpu.render import Camera as JCamera
from datum_tpu.render import RenderList as JRenderList

import datum_tpu_torch.render.particlesystem as TPS
from datum_tpu_torch.math import Transform
from datum_tpu_torch.render.camera import Camera
from datum_tpu_torch.render.renderlist import RenderList

STATE = ("position", "velocity", "rotation", "basesize", "size", "basecolor", "color",
         "layer", "life", "maxlife", "alive", "emitter", "emit_accum")


def _dist(pkg, kind, *a):
    return getattr(pkg.Distribution, kind)(*a)


DISTS = [("constant", (0.5,)), ("constant", ([1, 0.5, 0.25, 1],)),
         ("uniform", (0.2, 1.2)), ("uniform", ([1, 0.7, 0.2, 0.3], [4, 2.5, 1, 0.8])),
         ("table", ([0.0, 1.0, 0.25, 2.0],)),
         ("table", ([[1, 1, 1, 1], [1, 0.5, 0.2, 0.6], [0.3, 0.1, 0.0, 0.0]],))]


@pytest.mark.parametrize("kind,args", DISTS,
                         ids=[f"{k}-{np.ndim(a[0])}d" for k, a in DISTS])
def test_distribution_matches(kind, args):
    """sample (n = 37 from RandomState(5)) and evaluate (t01 over
    [-0.5, 1.5], past both ends) equal the JAX package's, exactly."""
    j, t = _dist(JPS, kind, *args), _dist(TPS, kind, *args)
    a = j.sample(37, np.random.RandomState(5))
    b = t.sample(37, np.random.RandomState(5))
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    t01 = np.linspace(-0.5, 1.5, 41).astype(np.float32)
    a, b = np.asarray(j.evaluate(t01)), np.asarray(t.evaluate(t01))
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _emitter(pkg, **kw):
    """ParticleEmitter of pkg with Distributions given as (kind, args)."""
    kw = {k: _dist(pkg, *v) if isinstance(v, tuple) and isinstance(v[0], str) else v
          for k, v in kw.items()}
    return pkg.ParticleEmitter(**kw)


OVER_LIFE = dict(scale_over_life=("table", [0.5, 1.5, 0.25]),
                 color_over_life=("table", [[1, 1, 1, 1], [1, 0.4, 0.1, 0.5],
                                            [0.2, 0.1, 0.0, 0.0]]),
                 rotate_over_life=("uniform", 0.5, 3.0),
                 layer_over_life=("table", [0.0, 7.0]))
CONFIGS = {
    "point": [dict(rate=90.0)],
    "sphere": [dict(rate=120.0, shape="sphere", shape_radius=1.5,
                    size=("uniform", 0.05, 0.2), rotation=("uniform", 0.0, 3.0),
                    color=("uniform", [1, 0.5, 0.2, 0.3], [3, 2, 1, 0.9]))],
    "hemisphere": [dict(rate=75.0, shape="hemisphere", shape_radius=0.8,
                        velocity=("constant", 2.0), life=("table", [0.2, 0.3, 0.45]))],
    "cone": [dict(rate=120.0, shape="cone", shape_angle=0.4,
                  life=("uniform", 0.1, 0.4), size=("uniform", 0.05, 0.15))],
    # a 0.25 s loop with bursts at its start, inside it and just before
    # its end (the windows that wrap the loop period)
    "bursts-looping-wrap": [dict(rate=0.0, duration=0.25, looping=True,
                                 bursts=[(0.0, 12), (0.1, 5), (0.245, 9)],
                                 life=("uniform", 0.05, 0.3))],
    # emits for 0.2 s, then expires (its burst fires once)
    "non-looping-expired": [dict(rate=80.0, duration=0.2, looping=False,
                                 bursts=[(0.1, 7)], life=("constant", 0.15))],
    "two-emitters": [dict(rate=60.0, shape="sphere", shape_radius=0.5,
                          acceleration=np.array([0, -9.81, 0], np.float32),
                          life=("uniform", 0.1, 0.3)),
                     dict(rate=45.0, shape="cone", shape_angle=0.7,
                          acceleration=np.array([1.5, 0.5, -2.0], np.float32),
                          bursts=[(0.05, 6)], life=("uniform", 0.2, 0.6), **OVER_LIFE)],
    "over-life": [dict(rate=100.0, shape="sphere", shape_radius=1.0,
                       life=("uniform", 0.1, 0.35), **OVER_LIFE)],
    "vector-scale-over-life": [dict(rate=100.0, life=("uniform", 0.1, 0.35),
                                    scale_over_life=("uniform", [1, 0.5], [0.2, 2]),
                                    rotate_over_life=("constant", 1.0))],
}


def _system(pkg, cfg, maxparticles=64):
    ems = [_emitter(pkg, **e) for e in cfg]
    return pkg.ParticleSystem(maxparticles=maxparticles, emitters=ems)


def _world(pkg_tf):
    return (pkg_tf.translation([1.0, 0.5, -2.0])
            * pkg_tf.rotation([0.3, 1.0, 0.2], 0.7))


def _assert_same(ja, ta, where):
    assert ta.time == ja.time, where
    for k in STATE:
        a, b = getattr(ja, k), getattr(ta, k)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k)
        np.testing.assert_array_equal(b, a, err_msg=f"{where}: {k}")


@pytest.fixture(params=["native", "numpy"])
def jax_route(request, monkeypatch):
    """The JAX package's integration route: its native fused pass (the
    helper library must load) or its numpy masked updates."""
    if request.param == "native":
        assert JPS._native_particles() is not None
    else:
        monkeypatch.setattr(JPS, "_native_lib", None)
    return request.param


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_update_matches_jax(name, jax_route):
    """30 steps of 1/60 s under a rotated, translated emitter transform
    from seed 7: every state array equal after every step."""
    cfg = CONFIGS[name]
    js, ts = _system(JPS, cfg), _system(TPS, cfg)
    ja, ta = js.create(seed=7), ts.create(seed=7)
    jw, tw = _world(JTransform), _world(Transform)
    emitted = 0
    for step in range(30):
        js.update(ja, 1 / 60, jw)
        ts.update(ta, 1 / 60, tw)
        _assert_same(ja, ta, f"{name}, step {step}, {jax_route}")
        emitted = max(emitted, ta.count)
    assert emitted > 0
    if name == "non-looping-expired":
        assert ta.count == 0              # expired, and every particle dead
    if name == "two-emitters":
        assert set(ta.emitter[ta.alive]) == {0, 1}


def _scene(pkg_scene, pkg_tf, ps_mod, cam_cls):
    scene = pkg_scene.Scene()
    cam = cam_cls()
    cam.set_projection(np.radians(60), 2.0)
    cam.lookat(np.array([0.0, 1.0, 8.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]))
    comps = []
    for pos in ([0.0, 0.0, 0.0], [0.0, 0.0, 40.0]):     # in view; behind the camera
        e = scene.create_entity()
        scene.add_component(e, pkg_scene.TransformComponent, pkg_tf.translation(pos))
        system = _system(ps_mod, CONFIGS["sphere"])
        system.bound = type(system.bound)([-1, -1, -1], [1, 1, 1])
        comps.append(scene.add_component(e, pkg_scene.ParticleSystemComponent,
                                         system=system))
    return scene, cam, comps


def test_update_particlesystems_matches_jax():
    """Two ParticleSystemComponents, one in the frustum and one behind
    the camera, over 5 frames: the same one is visible and stepped, its
    instance and its billboards equal the JAX scene's; the culled one's
    instance is created and never stepped."""
    import datum_tpu.scene as jscene

    import datum_tpu_torch.scene as tscene

    jsc, jcam, jcomps = _scene(jscene, JTransform, JPS, JCamera)
    tsc, tcam, tcomps = _scene(tscene, Transform, TPS, Camera)
    for frame in range(5):
        jrl, trl = JRenderList(), RenderList()
        jv = jscene.update_particlesystems(jsc, jcam, 1 / 60, jrl)
        tv = tscene.update_particlesystems(tsc, tcam, 1 / 60, trl)
        assert [jcomps.index(c) for c in jv] == [tcomps.index(c) for c in tv] == [0]
        for jc, tc in zip(jcomps, tcomps):
            _assert_same(jc.instance, tc.instance, f"frame {frame}")
        assert tcomps[1].instance.time == 0.0
        a, b = jrl.forward_arrays(256, jcam), trl.forward_arrays(256, tcam)
        assert int(a["quad_count"]) == int(b["quad_count"]) > 0
        np.testing.assert_allclose(b["positions"], a["positions"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(b["uv"], a["uv"])
        np.testing.assert_array_equal(b["color"], a["color"])


def _burst(pkg):
    """tests/test_particles_render.py's 8000-particle burst system."""
    ps = pkg.ParticleSystem(maxparticles=9000, emitters=[pkg.ParticleEmitter(
        rate=0.0, bursts=[(0.0, 8000)], life=pkg.Distribution.constant(10.0),
        velocity=pkg.Distribution.uniform(0.2, 1.0), shape="sphere",
        shape_radius=2.0, size=pkg.Distribution.uniform(0.05, 0.3),
        rotation=pkg.Distribution.uniform(0.0, 3.0),
        color=pkg.Distribution.constant([1, 1, 1, 1]),
        acceleration=np.zeros(3, np.float32))])
    return ps


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_billboards_past_4096_match_jax(route, monkeypatch):
    """The repair: 8000 live particles of one system give 8000 quads
    (max_particle_quads 8192), equal to the JAX package's native helper
    and its numpy route."""
    js, ts = _burst(JPS), _burst(TPS)
    ja, ta = js.create(seed=3), ts.create(seed=3)
    js.update(ja, 0.02, JTransform.identity())
    ts.update(ta, 0.02, Transform.identity())
    assert ta.count == ja.count == 8000
    if route == "native":
        assert JPS._native_particles() is not None
    else:
        monkeypatch.setattr(JPS, "_native_lib", None)
    jcam, tcam = JCamera(), Camera()
    for c in (jcam, tcam):
        c.lookat(np.array([0, 1.0, 5.0]), np.zeros(3), np.array([0, 1.0, 0]))
    jrl, trl = JRenderList(), RenderList()
    jrl.push_particles(ja)
    trl.push_particles(ta)
    a, b = jrl.forward_arrays(8192, jcam), trl.forward_arrays(8192, tcam)
    assert int(b["quad_count"]) == int(a["quad_count"]) == 8000
    np.testing.assert_allclose(b["positions"], a["positions"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b["uv"], a["uv"])
    np.testing.assert_array_equal(b["color"], a["color"])
