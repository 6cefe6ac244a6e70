"""The port's host side against the JAX package's (CPU, small scene).

The port carries its own numpy host modules (scene, render list,
sceneset, pools, draw expansion) because the machine with the card has
no jax; these tests hold them equal, exactly, to the JAX package's for
the same arguments, and check the configuration contract."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from datum_tpu import math as jmath
from datum_tpu.math import matrix as jmatrix
from datum_tpu.math import quaternion as jquat
from datum_tpu.ops.common import FrameConfig as JaxFrameConfig
from datum_tpu.render.types import make_sceneset as jax_make_sceneset
from datum_tpu.scenes import datumtest_scene as jax_datumtest_scene

from datum_tpu_torch import math as tmath
from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops.common import FrameConfig
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import datumtest_scene

SLICE = dict(width=256, height=128, sphere_detail=8, grid=(4, 3),
             n_point_lights=8, skybox=False, max_vertices=2048,
             max_triangles=2048, bin_capacity=128, big_capacity=16,
             bin_max_span=8, use_pallas=True, enable_material_maps=True,
             texture_filter="mip_half", enable_shadows=False)


def assert_tree_equal(a, b, path="root"):
    """Exact equality of two numpy trees: keys, dtypes, shapes, values."""
    if isinstance(a, dict):
        assert isinstance(b, dict), path
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=path)


def _frame_host(scene_fn, sceneset_fn, t, **kw):
    ctx, camera, params, make_rl = scene_fn(**dict(SLICE, skybox=True,
                                                   skybox_size=16, **kw))
    rl = make_rl(t)
    ss = sceneset_fn(camera, params, point_lights=rl.point_lights,
                     spot_lights=rl.spot_lights)
    draws = rl.draw_arrays(ctx.config.max_instances, ctx.default_material)
    ctx.expand_host(draws)
    return ctx, draws, ss


@pytest.fixture(scope="module")
def both():
    jctx, jdraws, jss = _frame_host(jax_datumtest_scene, jax_make_sceneset, 0.7)
    tctx, tdraws, tss = _frame_host(datumtest_scene, make_sceneset, 0.7, device="cpu")
    return jctx, jdraws, jss, tctx, tdraws, tss


def test_math_copy_matches():
    """The port's copy of the host math (datum_tpu_torch/math) gives
    exactly the JAX package's values: projections, quaternion rotation
    and matrix, and the transforms the scene and the camera build."""
    rng = np.random.RandomState(1)
    np.testing.assert_array_equal(
        tmath.perspective_proj(np.radians(60), 16 / 9, 0.1),
        jmatrix.perspective_proj(np.radians(60), 16 / 9, 0.1))
    np.testing.assert_array_equal(
        tmath.perspective_proj(1.1, 1.0, 0.5, 40.0),
        jmatrix.perspective_proj(1.1, 1.0, 0.5, 40.0))
    np.testing.assert_array_equal(
        tmath.orthographic_proj(-3, 4, -2, 5, 0.5, 80),
        jmatrix.orthographic_proj(-3, 4, -2, 5, 0.5, 80))
    for _ in range(5):
        q = rng.randn(4).astype(np.float32)
        q /= np.linalg.norm(q)
        v = rng.randn(7, 3).astype(np.float32)
        np.testing.assert_array_equal(tmath.quat_to_matrix(q), jquat.quat_to_matrix(q))
        np.testing.assert_array_equal(tmath.quat_rotate(q, v), jquat.quat_rotate(q, v))
        pos, tgt = rng.randn(3) * 5, rng.randn(3)
        for a, b in ((tmath.Transform.lookat(pos, tgt, [0, 1, 0]),
                      jmath.Transform.lookat(pos, tgt, [0, 1, 0])),
                     (tmath.Transform.translation(pos)
                      * tmath.Transform.rotation([0, 1, 0], 0.7),
                      jmath.Transform.translation(pos)
                      * jmath.Transform.rotation([0, 1, 0], 0.7))):
            np.testing.assert_array_equal(a.matrix(), b.matrix())
            np.testing.assert_array_equal(a.inverse().matrix(),
                                          b.inverse().matrix())


def test_frameconfig_fields_and_defaults_equal():
    jf = {f.name: (f.type, f.default) for f in dataclasses.fields(JaxFrameConfig)}
    tf = {f.name: (f.type, f.default) for f in dataclasses.fields(FrameConfig)}
    assert jf == tf


@pytest.mark.parametrize("size", [(1920, 1088), (1920, 1080), (256, 128),
                                  (1280, 720)])
def test_frameconfig_properties_equal(size):
    w, h = size
    a, b = JaxFrameConfig(width=w, height=h), FrameConfig(width=w, height=h)
    for prop in ("padded_width", "padded_height", "tiles_x", "tiles_y",
                 "n_tiles", "bin_capacity"):
        assert getattr(a, prop) == getattr(b, prop), prop


def test_draws_equal(both):
    _, jdraws, _, _, tdraws, _ = both
    assert_tree_equal(jdraws, tdraws)


def test_sceneset_equal(both):
    _, _, jss, _, _, tss = both
    assert_tree_equal(jss, tss)
    # probes stay in the tree with count 0
    assert tss["probes"]["position"].shape == (8, 4)
    assert int(tss["probes"]["count"]) == 0


def test_device_state_equal(both):
    """Pools, materials and matmaps exactly; the skybox environment
    ("ibl": the port keeps the mips, the flat, quad-packed and mip-pair
    tables as plain f32 rows, SH-9 and the env-BRDF LUT) to rtol 1e-4 /
    atol 1e-5, since both packages bake it (the LUT exactly: both read
    the tracked one)."""
    jctx, _, _, tctx, _, _ = both
    jstate = jax.tree.map(np.asarray, jctx.device_state())
    tstate = tctx.host_state()
    jibl, tibl = jstate.pop("ibl"), tstate.pop("ibl")
    assert_tree_equal(jstate, tstate)
    assert sorted(tibl) == ["envbrdf", "flat", "flatp", "flatq", "mips", "sh"]
    np.testing.assert_array_equal(jibl["envbrdf"], tibl["envbrdf"])
    jtab = to_torch({k: jibl[k] for k in ("flat", "flatp", "flatq")}, "cpu")
    for a, b in [*zip(jibl["mips"], tibl["mips"]), (jibl["sh"], tibl["sh"]),
                 *(ab for k in jtab for ab in zip(jtab[k], tibl[k]))]:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def test_device_state_tensors_keep_dtypes(both):
    _, _, _, tctx, _, _ = both
    host = tctx.host_state()
    dev = tctx.device_state("cpu")
    for k, v in host["geometry"].items():
        t = dev["geometry"][k]
        assert isinstance(t, torch.Tensor)
        assert t.dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(t.numpy(), v)
    assert dev["matmaps"]["table"].dtype == torch.uint8


def test_to_torch_keeps_scalars_zero_d():
    tree = dict(a=np.float32(1.5), b=np.int32(3), c=[np.zeros((2, 3), bool)],
                d=None)
    out = to_torch(tree, "cpu")
    assert out["a"].shape == () and out["a"].dtype == torch.float32
    assert out["b"].shape == () and out["b"].dtype == torch.int32
    assert out["c"][0].dtype == torch.bool and out["c"][0].shape == (2, 3)
    assert out["d"] is None


def test_skybox_is_rejected_not_dropped():
    """Box environment probes are ported: add_environment is accepted and
    fills the environment's envprobes (stacked tables, one quad table
    per probe, the count) once a skybox is set; probes of two cubemap
    sizes raise."""
    ctx = datumtest_scene(device="cpu", **dict(SLICE, skybox=True, skybox_size=16))[0]
    ctx.add_environment([0, 1, 0], [2, 2, 2], np.ones((6, 8, 8, 3), np.float32),
                        levels=3)
    ctx.add_environment([1, 1, 0], [1, 2, 3], np.full((6, 8, 8, 3), 0.5, np.float32),
                        rotation=[0.9238795, 0.0, 0.3826834, 0.0], levels=3)
    envs = ctx.host_state()["ibl"]["envprobes"]
    assert int(envs["count"]) == 2
    assert envs["position"].shape == (2, 3) and envs["halfdim"].shape == (2, 3)
    assert [m.shape for m in envs["mips"]] == [(2, 6, 8, 8, 3), (2, 6, 4, 4, 3)]
    assert len(envs["flatqs"]) == 2 and envs["flatqs"][0][0].shape == (6 * 80, 12)
    np.testing.assert_allclose(envs["inv_rot"][1] @ envs["inv_rot"][1].T, np.eye(3),
                               atol=1e-6)
    ctx.add_environment([0, 0, 0], [1, 1, 1], np.ones((6, 16, 16, 3), np.float32),
                        levels=3)
    with pytest.raises(ValueError, match="cubemap size"):
        ctx.host_state()


# a small datumtest scene: the frames below check that render_frame takes
# each configuration (the port rejects no FrameConfig flag)
TINY = dict(width=64, height=32, sphere_detail=4, grid=(2, 2), n_point_lights=2,
            skybox=False, max_vertices=512, max_triangles=512, bin_capacity=64,
            big_capacity=8, shadow_res=128, spot_shadow_res=128)


def _renders(**cfg):
    """One frame of the datumtest scene through RenderContext.render on
    the CPU with the given config: a u8 image of its size, not all black."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx, camera, params, make_rl = datumtest_scene(device="cpu", **cfg)
        img = ctx.render(camera, make_rl(0.3), params)
    finally:
        torch.set_num_threads(threads)
    assert img.shape == (cfg["height"], cfg["width"], 3) and img.dtype == np.uint8
    assert img.max() > 0


def test_slice_config_is_accepted():
    _renders(**SLICE)


_BASE = dict(use_pallas=True, texture_filter="mip_half", enable_shadows=False)


def test_translucent_config_is_accepted():
    """The translucent frame's capacities (lit glass/water layers,
    particles, decals) render."""
    for layers in (1, 2):
        _renders(**dict(
            TINY, **_BASE, max_translucent_draws=2, max_translucent_tris=2048,
            translucent_lit=True, translucent_lit_layers=layers,
            translucent_lit_scale=2, max_particle_quads=512,
            max_decals_active=2, decal_textures=False))


_IDS = lambda d: "-".join(f"{k}={v}" for k, v in d.items())


@pytest.mark.parametrize("override", [
    dict(max_translucent_draws=2, enable_ssao=True),
    dict(max_particle_quads=512, enable_fog=True),
    dict(max_decals_active=2, enable_ssr=True), dict(enable_ssao=True),
    dict(enable_fog=True), dict(enable_ssr=True),
    dict(enable_depth_of_field=True), dict(raster_two_phase=True),
    dict(enable_terrain_morph=True), dict(use_light_clusters=True),
    dict(raster_early_z=True),
    dict(enable_shadows=True, shadow_mode="pcf"),
    dict(max_spot_shadows=1, spot_shadow_mode="perspective"),
    dict(raster_kernel="mxu"), dict(use_pallas=False), dict(texture_filter="nearest"),
    dict(use_shade_kernel=False), dict(enable_material_maps=False),
    dict(max_fog_planes=1), dict(enable_ssr=True, ssr_mode="dda"),
    dict(enable_skinning=True), dict(enable_foliage=True),
    dict(max_dynamic_vertices=64), dict(max_overlay_sprites=4),
], ids=_IDS)
def test_post_flags_accepted(override):
    """SSAO, the froxel fog, the binned SSR, depth of field, the
    two-phase raster (K6), the terrain geomorph, clustered lights and the
    early-z exit are ported, and so is the deferred branch of the frame
    (PCF, perspective spot maps, K7, the scan raster, the legacy texture
    filters, the XLA lighting, no material maps), the fog planes, the
    DDA SSR, the animated vertex stage (skinning, the foliage bends,
    the dynamic-vertex slab) and the sprite pass: a small frame renders
    with each."""
    _renders(**dict(TINY, **dict(_BASE, **override)))


def test_bench_config_is_accepted():
    """The bench frame's flags (bench.py), also with DoF and with the
    two-phase raster, render (at TINY's size and capacities: the bench's
    1920x1088 belongs on the card)."""
    bench = dict(_BASE, enable_shadows=True, shadow_mode="esm", shadow_far_res=512,
                 shadow_slice_blend=0.25, bin_capacity=160, big_capacity=64,
                 bin_max_span=8, shadow_factor_scale=4, enable_ssao=True,
                 enable_fog=True, enable_ssr=True, max_spot_shadows=1,
                 max_particle_quads=512, max_translucent_draws=2,
                 max_translucent_tris=2048, max_decals_active=2,
                 decal_textures=False, translucent_lit_scale=2, fog_sample_scale=8)
    for extra in ({}, dict(enable_depth_of_field=True), dict(raster_two_phase=True)):
        _renders(**dict(TINY, **dict(bench, **extra, shadow_res=256, shadow_far_res=128)))
