"""The animated vertex stage of the port against the JAX package (CPU):
dual-quaternion skinning, the foliage wind bends, the dynamic-vertex
slab, the Animator, the Transform additions and the host arrays that
feed them.

Inputs are made with numpy from a seed; one JAX state goes through both
packages via convert.to_torch.  Tolerances:
- skin_vertices / transform_vertices_skinned: atol 1e-5, rtol 1e-5;
- wind_bend / wind_detail_bend and the vertex stage (clip, world
  positions, normals, tangents): atol 1e-5, rtol 1e-5 (f32 in another
  order; the standalone bends take XLA's fma-contracted dot, without
  which the detail bend's floor-mod of phases up to ~100 turns an ulp
  of phase into ~1e-4 of displacement);
- the patched pool, the Transform additions, the primitives, the pool's
  rig rows and the RenderList arrays: exact;
- the Animator's palettes: atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fastpath_vertexmodes import _cfg, _scene
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)
from datum_tpu.math import transform as jtf
from datum_tpu.ops import geometry as jgeom
from datum_tpu.render import frame as jframe
from datum_tpu.render import primitives as jprim
from datum_tpu.render.animation import Animation as JAnimation
from datum_tpu.render.animation import Animator as JAnimator
from datum_tpu.render.renderlist import RenderList as JRenderList
from datum_tpu.render.types import make_sceneset as jax_make_sceneset

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.math import transform as tf
from datum_tpu_torch.ops import geometry
from datum_tpu_torch.render import frame as frame_mod
from datum_tpu_torch.render import primitives
from datum_tpu_torch.render.animation import Animation, Animator
from datum_tpu_torch.render.context import GeometryPool
from datum_tpu_torch.render.renderlist import RenderList


TOL = dict(atol=1e-5, rtol=1e-5)
jnp_ = lambda *a: [jnp.asarray(x) for x in a]
th = lambda *a: [torch.from_numpy(np.asarray(x)) for x in a]


def _rig(seed, V=4096, P=4, B=8):
    """Seeded skinning inputs: unit and unnormalised dual-quats, antipodal
    pairs of rows, zero and unnormalised weights, bone ids across the
    palette (and a few past its end)."""
    rng = np.random.RandomState(seed)
    pos = rng.randn(V, 3).astype(np.float32) * 2
    nrm = rng.randn(V, 3).astype(np.float32)
    tan = np.concatenate([rng.randn(V, 3), rng.choice([-1.0, 1.0], (V, 1))],
                         -1).astype(np.float32)
    real = rng.randn(P * B, 4).astype(np.float32)
    real[::3] /= np.linalg.norm(real[::3], axis=-1, keepdims=True)
    dual = rng.randn(P * B, 4).astype(np.float32) * 0.5
    pal = np.concatenate([real, dual], -1)
    pal[1::2] = -pal[0::2]                     # antipodal: the same rotation
    bone_idx = rng.randint(0, B, (V, 4)).astype(np.int32)
    bone_wt = rng.uniform(0, 1, (V, 4)).astype(np.float32)
    bone_wt[::5, 1:] = 0.0                     # one bone at weight 1
    bone_wt[1::5] = 0.0                        # all zero: the norm floor
    bone_wt[2::5] *= 3.0                       # unnormalised
    pal_of_v = rng.randint(0, P, V).astype(np.int32)
    return pos, nrm, tan, bone_idx, bone_wt, pal, pal_of_v, P, B


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skin_vertices_matches_jax(seed):
    pos, nrm, tan, bi, bw, pal, pv, P, B = _rig(seed)
    a = jgeom.skin_vertices(*jnp_(pos, nrm, tan, bi, bw, pal, pv), B)
    b = geometry.skin_vertices(*th(pos, nrm, tan, bi, bw, pal, pv), B)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL)


def test_skin_vertices_clamps_rows_past_the_table_as_jax():
    """A palette row index outside [0, P*B) reads the clamped row, as the
    JAX package's gather clamps (a palette id past the table, a bone id
    past max_bones, a negative bone id)."""
    pos, nrm, tan, bi, bw, pal, pv, P, B = _rig(3, V=64)
    bi[:8, 0] = B + 5
    bi[8:16, 1] = -3
    pv[16:24] = P + 2
    a = jgeom.skin_vertices(*jnp_(pos, nrm, tan, bi, bw, pal, pv), B)
    b = geometry.skin_vertices(*th(pos, nrm, tan, bi, bw, pal, pv), B)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL)


def test_transform_vertices_skinned_matches_jax():
    pos, nrm, tan, bi, bw, pal, pv, P, B = _rig(4)
    rng = np.random.RandomState(4)
    world = np.concatenate([np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
                            + rng.randn(P, 3, 3).astype(np.float32) * 0.1,
                            rng.randn(P, 3, 1).astype(np.float32)], -1)
    vp = rng.randn(4, 4).astype(np.float32)
    pals = pal.reshape(P, B, 8)
    a = jgeom.transform_vertices_skinned(*jnp_(pos, nrm, tan, pv, bi, bw, pals, world, vp))
    b = geometry.transform_vertices_skinned(*th(pos, nrm, tan, pv, bi, bw, pals, world, vp))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL)


@pytest.mark.parametrize("case", ["plain", "negative-phase", "anchor-sum-0"])
def test_wind_bends_match_jax(case):
    """wind_bend and wind_detail_bend (the standalone forms) against the
    JAX functions: positions below the pivot and negative times give
    negative wave phases (the floor-mod); an anchor whose components sum
    to 0 gives one phase for every vertex."""
    rng = np.random.RandomState(7)
    pos = rng.randn(2048, 3).astype(np.float32) * 1.5
    anchor = rng.randn(3).astype(np.float32) * 4
    time_ = 2.3
    if case == "negative-phase":
        pos[:, 1] -= 3.0
        time_ = -5.7
    if case == "anchor-sum-0":
        anchor = np.float32([2.5, -1.0, -1.5])
    wind = np.float32([0.7, 0.1, -0.4])
    scale = np.float32([0.0, 0.3, 0.05])
    a = jgeom.wind_detail_bend(jnp.asarray(pos), anchor, time_, wind, scale)
    b = geometry.wind_detail_bend(torch.from_numpy(pos), anchor, time_, wind, scale)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    assert np.abs(b.numpy() - pos).max() > 0.1          # the flutter moves vertices
    a = jgeom.wind_bend(jnp.asarray(pos), wind, scale)
    b = geometry.wind_bend(torch.from_numpy(pos), wind, scale)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def _inputs(cfg, bent=False, t=0.0, slab=None):
    """The JAX package's host build of the vertex-modes scene: (ctx,
    numpy state, draws, sceneset), draws as its RenderContext.render
    builds them.  slab: (offset, count) to force on the ocean's slab."""
    ctx, cam, params, rl = _scene(cfg, bent, t)
    ss = jax_make_sceneset(cam, params, point_lights=rl.point_lights,
                           spot_lights=rl.spot_lights, probes=rl.probes)
    draws = rl.draw_arrays(cfg.max_instances, ctx.default_material,
                           max_palettes=cfg.max_palettes if cfg.enable_skinning else 0,
                           max_bones=cfg.max_bones)
    ctx.expand_host(draws)
    if cfg.max_dynamic_vertices > 0:
        draws["dyn"] = rl.oceans[0].vertex_data(cfg.max_dynamic_vertices, cam.position)
        if slab is not None:
            draws["dyn"] = dict(draws["dyn"], offset=np.int32(slab[0]),
                                count=np.int32(slab[1]))
    draws = jax.tree.map(np.asarray, draws)
    return ctx, jax.tree.map(np.asarray, ctx.device_state()), draws, ss


def _port_draws(ctx, cfg, draws):
    d = dict(draws)
    frame_mod.attach_host_expansion(ctx.pool, d, cfg.max_vertices, cfg.max_triangles,
                                    cfg.max_translucent_tris)
    return d


MODES = dict(all={}, foliage=dict(enable_skinning=False, max_dynamic_vertices=0),
             skinning=dict(enable_foliage=False, max_dynamic_vertices=0),
             slab=dict(enable_skinning=False, enable_foliage=False))


@pytest.mark.parametrize("bent,t", [(False, 0.0), (True, 2.0)], ids=["rest", "bent"])
@pytest.mark.parametrize("mode", list(MODES))
def test_vertex_stage_matches_jax(mode, bent, t):
    """The port's _vertex_stage on the patched pool (the foliage bends in
    the frame's inline form, skinning, the slab) against the JAX
    package's _vertex_stage on tests/test_fastpath_vertexmodes.py's
    scene: clip, world positions, normals and tangents at atol/rtol
    1e-5, the streams exact."""
    import dataclasses

    cfg = dataclasses.replace(_cfg(False), **MODES[mode])
    ctx, state, draws, ss = _inputs(cfg, bent, t)
    jg, jex, juv, jclip, jwn, jwt, jwp, _ = jframe._vertex_stage(cfg, state, draws, ss)
    d, s = to_torch(_port_draws(ctx, cfg, draws), "cpu"), to_torch(ss, "cpu")
    st = frame_mod.patch_dynamic(cfg, to_torch(state, "cpu"), d)
    ex, uv, clip, wn, wt, wp = frame_mod._vertex_stage(cfg, st, d, s)
    np.testing.assert_array_equal(ex["tris"].numpy(), np.asarray(jex["tris"]))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))
    for a, b in ((jclip, clip), (jwp, wp), (jwn, wn), (jwt, wt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    if bent and mode != "slab":        # the bent pose moves the mode's vertices
        cfg0 = dataclasses.replace(cfg, enable_skinning=False, enable_foliage=False)
        wp0 = frame_mod._vertex_stage(cfg0, st, d, s)[5]
        assert (wp - wp0).abs().max() > 0.1


@pytest.mark.parametrize("slab", [None, (40, 289), (7000, 289), (1 << 13, 289)],
                         ids=["ocean", "in-range", "clamped", "past-the-end"])
def test_patched_pool_equals_jax(slab):
    """patch_dynamic's attr12 columns equal the JAX package's patched
    positions (0:3), texcoords (3:5) and normals (5:8) bit for bit: in
    range, and where the JAX package clamps the start to V - md (a slab
    past the pool's end writes over the rows before it); the other
    columns and the state itself are unchanged."""
    cfg = _cfg(False)
    ctx, state, draws, ss = _inputs(cfg, slab=slab)
    jg = jframe._vertex_stage(cfg, state, draws, ss)[0]
    d = to_torch(_port_draws(ctx, cfg, draws), "cpu")
    st = to_torch(state, "cpu")
    a12 = st["geometry"]["attr12"].clone()
    got = frame_mod.patch_dynamic(cfg, st, d)["geometry"]["attr12"].numpy()
    for cols, k in (((0, 3), "positions"), ((3, 5), "texcoords"), ((5, 8), "normals")):
        np.testing.assert_array_equal(got[:, cols[0]:cols[1]], np.asarray(jg[k]))
    np.testing.assert_array_equal(got[:, 8:], a12[:, 8:].numpy())
    assert torch.equal(st["geometry"]["attr12"], a12)
    if slab is not None and slab[0] + cfg.max_dynamic_vertices > a12.shape[0]:
        start = a12.shape[0] - cfg.max_dynamic_vertices
        assert not np.array_equal(got[start:start + 8], a12[start:start + 8].numpy())


def test_count_0_after_a_nonzero_frame_reads_the_pool():
    """A frame with a slab, then one with count 0 on the same state: the
    second reads the pool's own rows (the cached state is never written),
    as the JAX package's functional update does."""
    cfg = _cfg(False)
    ctx, state, draws, ss = _inputs(cfg)
    st = to_torch(state, "cpu")
    a12 = st["geometry"]["attr12"].clone()
    d = to_torch(_port_draws(ctx, cfg, draws), "cpu")
    first = frame_mod.patch_dynamic(cfg, st, d)["geometry"]["attr12"]
    assert not torch.equal(first, a12)
    d0 = dict(d, dyn=dict(d["dyn"], count=torch.tensor(0, dtype=torch.int32)))
    second = frame_mod.patch_dynamic(cfg, st, d0)["geometry"]["attr12"]
    assert torch.equal(second, a12) and torch.equal(st["geometry"]["attr12"], a12)
    draws0 = dict(draws, dyn=dict(draws["dyn"], count=np.int32(0)))
    jg = jframe._vertex_stage(cfg, state, draws0, ss)[0]
    np.testing.assert_array_equal(second[:, 0:3].numpy(), np.asarray(jg["positions"]))


def _chain_animation(rng, joints, n_keys, duration, axis):
    times, transforms, table = [], [], []
    for j, (name, parent) in enumerate(joints):
        table.append(dict(name=name, parent=parent, index=len(times), count=n_keys))
        ts = np.sort(rng.uniform(0, duration, n_keys)).astype(np.float32)
        ts[0], ts[-1] = 0.0, duration
        for k in range(n_keys):
            times.append(ts[k])
            tr = (jtf.Transform.translation(rng.randn(3) * 0.5)
                  * jtf.Transform.rotation(axis, float(rng.uniform(-1, 1))))
            transforms.append(tr.flat())
    return duration, table, np.float32(times), np.float32(transforms)


@pytest.mark.parametrize("looping", [True, False], ids=["looping", "one-shot"])
def test_animator_palettes_match_jax(looping):
    """Two blended channels over a 4-joint chain, one of whose joints
    ("ghost") is absent from the skeleton, and a skeleton bone no clip
    keys: the palettes over 10 updates (past the one-shot clip's end)
    equal the JAX Animator's to atol 1e-6."""
    rng = np.random.RandomState(11)
    joints = [("root", 0), ("mid", 0), ("tip", 1), ("ghost", 2)]
    clips = [_chain_animation(rng, joints, 5, 1.0, [0, 0, 1.0]),
             _chain_animation(rng, joints[:3], 4, 0.7, [1.0, 0, 0])]
    bones = [(n, jtf.Transform.translation(rng.randn(3)).flat())
             for n in ("root", "mid", "tip", "spare")]
    anims = []
    for A, An, Tr in ((JAnimator, JAnimation, jtf), (Animator, Animation, tf)):
        an = A([(n, Tr.Transform.from_flat(b).flat()) for n, b in bones])
        an.play(An(*clips[0]), weight=0.7, rate=1.0, looping=looping)
        an.play(An(*clips[1]), weight=0.3, rate=1.7, looping=looping,
                scale=(1.0, 0.5, 1.0))
        anims.append(an)
    for _ in range(10):
        for an in anims:
            an.update(0.13)
        np.testing.assert_allclose(anims[1].palette(), anims[0].palette(), atol=1e-6)
    assert not np.allclose(anims[1].palette()[:3], np.tile(
        tf.Transform.identity().flat(), (3, 1)))


def test_transform_additions_match_jax():
    """from_flat, flat, conjugate, normalized, tf_lerp, tf_slerp and
    tf_blend equal the JAX package's (exact: the same numpy)."""
    rng = np.random.RandomState(3)
    for _ in range(8):
        f1, f2 = rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32)
        alpha = float(rng.uniform())
        for fn in ("tf_lerp", "tf_slerp", "tf_blend"):
            a = getattr(jtf, fn)(jtf.Transform.from_flat(f1), jtf.Transform.from_flat(f2),
                                 alpha)
            b = getattr(tf, fn)(tf.Transform.from_flat(f1), tf.Transform.from_flat(f2),
                                alpha)
            np.testing.assert_array_equal(b.flat(), a.flat())
        for m in ("conjugate", "normalized"):
            np.testing.assert_array_equal(getattr(tf.Transform.from_flat(f1), m)().flat(),
                                          getattr(jtf.Transform.from_flat(f1), m)().flat())


@pytest.mark.parametrize("name", ["unit_quad", "unit_cube"])
def test_primitives_match_jax(name):
    (jv, ji), (pv, pi) = getattr(jprim, name)(), getattr(primitives, name)()
    np.testing.assert_array_equal(pi, ji)
    for k in jv:
        np.testing.assert_array_equal(pv[k], jv[k])


def test_pool_rig_and_renderlist_arrays_match_jax():
    """GeometryPool.add_mesh(rig=, mincorner=, maxcorner=) writes the JAX
    package's bone rows; RenderList's draw arrays (foliage, terrain and
    actor draws; 5 actors at max_palettes 3: palette 0 is the identity,
    actors past the table take it), caster arrays (caster=False kept
    out, push_caster in) and the ocean list equal the JAX package's."""
    from datum_tpu.render.context import GeometryPool as JPool

    rng = np.random.RandomState(5)
    sv, si = jprim.unit_sphere(6, 3)
    rig = np.zeros(len(sv["position"]), dtype=[("bone", np.int32, 4),
                                               ("weight", np.float32, 4)])
    rig["bone"] = rng.randint(0, 4, rig["bone"].shape)
    rig["weight"] = rng.uniform(0, 1, rig["weight"].shape)
    handles = []
    pools = (JPool(512, 512), GeometryPool(512, 512))
    for pool in pools:
        pool.add_mesh(*jprim.unit_quad())
        handles.append(pool.add_mesh(sv, si, mincorner=[-2, -2, -2], maxcorner=[2, 2, 2],
                                     rig=rig))
    for k in ("bone_idx", "bone_wt", "positions", "normals"):
        np.testing.assert_array_equal(getattr(pools[1], k), getattr(pools[0], k))
    np.testing.assert_array_equal(handles[1].maxcorner, handles[0].maxcorner)

    pals = [rng.randn(6, 8).astype(np.float32) for _ in range(5)]
    lists = (JRenderList(), RenderList())
    for rl, Tr in zip(lists, (jtf, tf)):
        h = handles[0]
        rl.push_mesh(h, Tr.Transform.translation([1, 2, 3]), 1)
        rl.push_geometry(h, Tr.Transform.identity(), 2, caster=False)
        rl.push_foliage(h, [Tr.Transform.translation([0, 0, i]) for i in range(3)], 3,
                        wind=(0.5, 0, 0.2, 1.5), bendscale=(0, 0.3, 0), caster=False)
        rl.push_terrain(h, Tr.Transform.identity(), 4, morph=(5.0, 9.0))
        for i in range(5):
            rl.push_actor(h, Tr.Transform.translation([i, 0, 0]), 5, pals[i])
        rl.push_caster(h, Tr.Transform.translation([0, 1, 0]), 6)
    for kw in (dict(), dict(max_palettes=3, max_bones=4), dict(max_palettes=8, max_bones=8)):
        a = lists[0].draw_arrays(16, 0, **kw)
        b = lists[1].draw_arrays(16, 0, **kw)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    a, b = lists[0].caster_arrays(16), lists[1].caster_arrays(16)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert int(b["count"]) == 8 and lists[1].oceans == []    # mesh, terrain, 5 actors, 1
