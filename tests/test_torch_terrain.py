"""The stress scene's host side and the terrain geomorph against the
JAX package (CPU).

The port's own copies — PerlinEngine, grid_morph_targets,
primitives.terrain, the pool's morph deltas, RenderList.push_terrain and
stress_scene — give the JAX package's numpy output exactly for the same
arguments; ops/geometry.terrain_morph matches the JAX function within
atol 1e-6 (f32 arithmetic in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datum_tpu.math.perlin import PerlinEngine as JPerlin
from datum_tpu.ops import geometry as jgeom
from datum_tpu.render import primitives as jprim
from datum_tpu.render.terrain import grid_morph_targets as j_targets
from datum_tpu.render.types import make_sceneset as jax_make_sceneset
from datum_tpu.scenes import stress_scene as jax_stress_scene

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.math.perlin import PerlinEngine
from datum_tpu_torch.ops import geometry
from datum_tpu_torch.render import frame as frame_mod
from datum_tpu_torch.render import primitives
from datum_tpu_torch.render.terrain import grid_morph_targets
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import stress_scene

SMALL = dict(width=256, height=128, terrain_n=24, sphere_detail=8, grid=(3, 2),
             n_point_lights=16, skybox=False, max_vertices=2048, max_triangles=2048)


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_perlin_equals_jax(seed):
    rng = np.random.RandomState(seed)
    x, y, z = (rng.uniform(-40, 40, (33, 17)).astype(np.float32) for _ in range(3))
    a, b = JPerlin(seed), PerlinEngine(seed)
    assert np.array_equal(a.perm, b.perm)
    assert np.array_equal(a.noise3(x, y, z), b.noise3(x, y, z))
    fa, fb = a.fbm3(x, y, z, octaves=4), b.fbm3(x, y, z, octaves=4)
    assert fb.dtype == np.float32 and np.array_equal(fa, fb)


@pytest.mark.parametrize("g", [2, 4])
def test_grid_morph_targets_equal_jax(g):
    rng = np.random.RandomState(g)
    pos = rng.randn(13, 9, 3).astype(np.float32)
    nrm = rng.randn(13, 9, 3).astype(np.float32)
    for a, b in zip(j_targets(pos, nrm, g), grid_morph_targets(pos, nrm, g)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("morph_grid", [0, 4])
def test_terrain_mesh_equals_jax(morph_grid):
    (jv, jt), (pv, pt) = (
        m.terrain(size=28.0, n=24, height=2.2, morph_grid=morph_grid)
        for m in (jprim, primitives))
    assert np.array_equal(jt, pt) and set(jv) == set(pv)
    for k in jv:
        assert jv[k].dtype == pv[k].dtype and np.array_equal(jv[k], pv[k]), k
    assert ("morph_position" in pv) == (morph_grid > 0)


def _scenes(**kw):
    cfg = dict(SMALL, **kw)
    return jax_stress_scene(**cfg), stress_scene(device="cpu", **cfg)


def test_stress_scene_state_equals_jax():
    """The pool (attr12, morph deltas, triangles), the materials and the
    draw arrays (morph_range on the terrain draw only) of the port's
    stress scene equal the JAX package's."""
    (jctx, jcam, jparams, jmk), (ctx, cam, params, mk) = _scenes()
    jg = jax.tree.map(np.asarray, jctx.device_state())["geometry"]
    pg = ctx.host_state()["geometry"]
    for k in ("attr12", "morph6", "triangles", "mesh_vtx_offset", "mesh_tri_count"):
        assert np.array_equal(jg[k], pg[k]), k
    assert np.abs(pg["morph6"]).max() > 0.1
    jd = jmk(0.3).draw_arrays(jctx.config.max_instances, jctx.default_material)
    pd = mk(0.3).draw_arrays(ctx.config.max_instances, ctx.default_material)
    for k in ("mesh", "world", "material", "count", "morph_range"):
        assert np.array_equal(jd[k], pd[k]), k
    assert pd["morph_range"][0].tolist() == [18.0, 34.0]
    assert not pd["morph_range"][1:].any()
    np.testing.assert_array_equal(cam.view(), jcam.view())


def test_stress_scene_without_morph_pushes_plain_meshes():
    _, (ctx, _, _, mk) = _scenes(enable_terrain_morph=False)
    assert not ctx.host_state()["geometry"]["morph6"].any()
    assert not mk(0.0).draw_arrays(8, 0)["morph_range"].any()


def test_terrain_morph_matches_jax():
    """Random vertices over three draws, one off (end <= 0), one with the
    camera inside its begin radius, one rotated and translated."""
    rng = np.random.RandomState(5)
    V, D = 400, 3
    pos = rng.uniform(-8, 8, (V, 3)).astype(np.float32)     # ulps below atol
    nrm = rng.randn(V, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    morph6 = rng.uniform(-0.5, 0.5, (V, 6)).astype(np.float32)
    vtx_draw = rng.randint(0, D, V).astype(np.int32)
    c, s = np.cos(0.7), np.sin(0.7)
    world = np.zeros((D, 3, 4), np.float32)
    world[:, :, :3] = np.eye(3)
    world[2, :, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    world[2, :, 3] = [3.0, -1.0, 2.0]
    morph_range = np.float32([[18, 34], [0, 0], [5, 12]])
    campos = np.float32([1.0, 6.0, 20.0])
    a = jgeom.terrain_morph(*(jnp.asarray(x) for x in (pos, nrm, morph6, vtx_draw,
                                                       world, morph_range, campos)))
    b = geometry.terrain_morph(*(torch.from_numpy(x) for x in (
        pos, nrm, morph6, vtx_draw, world, morph_range, campos)))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-6, rtol=0)
    off = vtx_draw == 1
    assert np.array_equal(b[0].numpy()[off], pos[off])
    assert np.abs(b[0].numpy() - pos)[~off].max() > 0.1


def test_vertex_stage_applies_the_morph():
    """The frame's vertex stage morphs the terrain draw (and only it) as
    the JAX package's does; with the flag off it leaves every vertex
    where the pool has it."""
    from datum_tpu.render import frame as jax_frame

    (jctx, jcam, jparams, jmk), (ctx, cam, params, mk) = _scenes()
    jrl, rl = jmk(0.3), mk(0.3)
    jd = jrl.draw_arrays(jctx.config.max_instances, jctx.default_material)
    jctx.expand_host(jd)
    jss = jax_make_sceneset(jcam, jparams, point_lights=jrl.point_lights,
                            spot_lights=jrl.spot_lights)
    *_, jclip, _, _, jwp, _ = jax_frame._vertex_stage(jctx.config, jctx.device_state(),
                                                     jd, jss)
    ss = make_sceneset(cam, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights)
    d, s = to_torch(ctx.frame_draws(rl, cam), "cpu"), to_torch(ss, "cpu")
    state = ctx.device_state("cpu")
    _, _, clip, _, _, wp = frame_mod._vertex_stage(ctx.config, state, d, s)
    np.testing.assert_allclose(clip.numpy(), np.asarray(jclip), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(wp.numpy(), np.asarray(jwp), atol=1e-5, rtol=1e-6)
    cfg_off = dataclasses.replace(ctx.config, enable_terrain_morph=False)
    _, _, _, _, _, wp0 = frame_mod._vertex_stage(cfg_off, state, d, s)
    moved = (wp - wp0).abs().amax(1) > 1e-4
    terrain_v = d["vtx_draw"] == 0
    assert moved.any() and not (moved & ~terrain_v).any()
