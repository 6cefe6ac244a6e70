"""The port's IBL/skybox environment against the JAX package (CPU).

The same numpy inputs (a seed, or the JAX package's skybox and state
through convert.to_torch) go through both packages.  Each test states
its tolerance: rtol 1e-4 for the bakes and taps (float sums taken in
another order), exact where the operation only moves values."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu.ops import ibl as jibl
from datum_tpu.ops import sampling as jsamp
from datum_tpu.ops import skybox_gen as jsky
from datum_tpu.ops.blur import downsample_pool as jpool
from datum_tpu.ops.blur import resize_up_dense_batch as jup_batch
from datum_tpu.ops.lighting_pass import _inv_proj as j_inv_proj
from datum_tpu.ops.lighting_pass import view_ray_grid as jrays
from datum_tpu.render import frame as jframe
from datum_tpu.render.types import make_sceneset as jax_make_sceneset
from datum_tpu.scenes import datumtest_scene as jax_datumtest_scene

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops import ibl as tibl
from datum_tpu_torch.ops import sampling as tsamp
from datum_tpu_torch.ops import skybox_gen as tsky
from datum_tpu_torch.render import frame as tframe
from datum_tpu_torch.render.context import _ENVBRDF_LUT, RenderContext
from datum_tpu_torch.render.skybox import SkyBox

SKY = dict(skycolor=(0.65, 0.57, 0.475), groundcolor=(0.41, 0.37, 0.32),
           sundirection=np.float32([-0.4, -0.7, -0.6]) / np.float32(
               np.linalg.norm([-0.4, -0.7, -0.6])),
           sunintensity=(8.0, 7.56, 7.88))
SCENE = dict(width=256, height=128, sphere_detail=8, grid=(4, 3),
             n_point_lights=8, skybox=True, skybox_size=16, max_vertices=2048,
             max_triangles=2048, bin_capacity=128, big_capacity=16,
             bin_max_span=8, use_pallas=True, texture_filter="mip_half",
             enable_shadows=False)


def _close(a, b, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def cube():
    """The JAX package's 32^3 procedural sky (the bakes' common input)."""
    return np.array(jsky.generate_skybox(32, **SKY))


def test_generate_skybox_matches(cube):
    """rtol 1e-4 (transcendentals of two libraries)."""
    t = tsky.generate_skybox(32, **SKY)
    assert t.shape == (6, 32, 32, 3) and torch.isfinite(t).all()
    _close(cube, t.numpy())


def test_build_specular_mips_matches(cube):
    """The roughness chain (downsample + GGX convolve, 16 samples):
    same sizes, rtol 1e-4 / atol 1e-5."""
    a = jibl.build_specular_mips(jnp.asarray(cube), 7, 16)
    b = tibl.build_specular_mips(torch.from_numpy(cube), 7, 16)
    assert [m.shape[1] for m in b] == [int(m.shape[1]) for m in a] == [32, 16, 8, 4]
    for x, y in zip(a, b):
        _close(x, y.numpy(), atol=1e-5)


def test_sh_project_and_rotate_sh9_match(cube):
    """SH-9 projection, and its rotation by a random rotation: rtol 1e-4
    / atol 1e-5."""
    a = np.array(jibl.sh_project(jnp.asarray(cube)))
    b = tibl.sh_project(torch.from_numpy(cube)).numpy()
    _close(a, b, atol=1e-5)
    q, _ = np.linalg.qr(np.random.RandomState(2).randn(3, 3))
    r = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    _close(jibl.rotate_sh9(jnp.asarray(a), jnp.asarray(r)),
           tibl.rotate_sh9(torch.from_numpy(a), torch.from_numpy(r)).numpy(),
           atol=1e-5)


def test_flatten_cube_mips_pair_matches(cube):
    """The mip-pair table: the JAX u8-bitcast rows viewed as f32 by
    convert.to_torch equal the port's plain f32 rows (rtol 1e-6: the
    bilinear resample of the next mip), bases and sizes exactly."""
    mips = [cube, cube.reshape(6, 16, 2, 16, 2, 3).mean((2, 4)),
            cube[:, ::4, ::4]]
    a = jax.tree.map(np.asarray, jsamp.flatten_cube_mips_pair(
        [jnp.asarray(m) for m in mips]))
    assert a[0].dtype == np.uint8
    a = to_torch(dict(flatp=a), "cpu")["flatp"]
    b = tsamp.flatten_cube_mips_pair([torch.from_numpy(m) for m in mips])
    assert b[0].dtype == a[0].dtype == torch.float32
    assert b[0].shape == a[0].shape == (6 * (32 * 32 + 16 * 16 + 8 * 8), 24)
    _close(a[0].numpy(), b[0].numpy(), rtol=1e-6, atol=0)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)


def test_sample_cubemap_lod_pair_matches(cube):
    """Trilinear taps at random directions and lods (edges and both
    clamps included): rtol 1e-4 / atol 1e-6."""
    rng = np.random.RandomState(3)
    mips = [np.array(m) for m in jibl.build_specular_mips(jnp.asarray(cube), 7, 8)]
    d = rng.randn(500, 3).astype(np.float32)
    d[:6] = np.concatenate([np.eye(3), -np.eye(3)])      # the face centres
    lod = rng.uniform(-0.5, len(mips) + 0.5, 500).astype(np.float32)
    a = jsamp.sample_cubemap_lod_pair(jsamp.flatten_cube_mips_pair(
        [jnp.asarray(m) for m in mips]), jnp.asarray(d), jnp.asarray(lod))
    b = tsamp.sample_cubemap_lod_pair(
        tsamp.flatten_cube_mips_pair([torch.from_numpy(m) for m in mips]),
        torch.from_numpy(d), torch.from_numpy(lod))
    _close(a, b.numpy())
    fj, uvj = jsamp.cubemap_face_uv(jnp.asarray(d))
    ft, uvt = tsamp.cubemap_face_uv(torch.from_numpy(d))
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    _close(uvj, uvt.numpy(), rtol=1e-6)


def test_envbrdf_lut_is_a_copy_of_the_jax_file():
    """The port's tracked LUT is the JAX package's bake_envbrdf(64, 128)
    file byte for byte (K2's CPU parity rests on the two LUTs being
    equal), and the port reads its own copy, not the JAX package's."""
    jax_lut = Path(jibl.__file__).resolve().parents[1] / "_cache" / "envbrdf64.npy"
    assert _ENVBRDF_LUT.parent.name == "data"
    assert "datum_tpu_torch" in _ENVBRDF_LUT.parts
    assert _ENVBRDF_LUT.read_bytes() == jax_lut.read_bytes()


def test_bake_envbrdf_matches_the_tracked_lut():
    """The port's numpy bake against its tracked LUT (a copy of the JAX
    package's bake_envbrdf(64, 128) file): atol 1e-5."""
    lut = np.load(_ENVBRDF_LUT)
    assert lut.shape == (64, 64, 3)
    np.testing.assert_allclose(tibl.bake_envbrdf(64, 128), lut, rtol=0, atol=1e-5)


def test_context_environment_state():
    """set_skybox bakes the mip chain, the flat, quad-packed and mip-pair
    tables, SH-9 and the LUT into device_state()['ibl'] (the LUT read
    only from the port's tracked copy)."""
    ctx = RenderContext()
    ctx.set_skybox(SkyBox(size=16, convolve_samples=4, device="cpu"))
    ibl = ctx.device_state("cpu")["ibl"]
    assert sorted(ibl) == ["envbrdf", "flat", "flatp", "flatq", "mips", "sh"]
    assert [m.shape for m in ibl["mips"]] == [(6, 16, 16, 3), (6, 8, 8, 3),
                                             (6, 4, 4, 3)]
    n = 6 * (256 + 64 + 16)
    assert ibl["flatp"][0].shape == (n, 24)
    assert ibl["flat"][0].shape == (n, 3) and ibl["flatq"][0].shape == (n, 12)
    assert ibl["sh"].shape == (9, 3) and ibl["envbrdf"].shape == (64, 64, 3)
    np.testing.assert_array_equal(ibl["envbrdf"].numpy(), np.load(_ENVBRDF_LUT))


@pytest.fixture(scope="module")
def jax_scene():
    """The JAX package's small sky-lit scene: its state and sceneset as
    numpy, and the port's K1 planes from that state (plain path)."""
    ctx, camera, params, make_rl = jax_datumtest_scene(**SCENE)
    rl = make_rl(0.3)
    ss = jax_make_sceneset(camera, params, point_lights=rl.point_lights,
                           spot_lights=rl.spot_lights)
    draws = rl.draw_arrays(ctx.config.max_instances, ctx.default_material)
    ctx.expand_host(draws)
    state = jax.tree.map(np.asarray, ctx.device_state())
    tstate, td, tss = (to_torch(x, "cpu") for x in (state, draws, ss))
    cfg = ctx.config
    ex, uv, clip, wn, wt, _ = tframe._vertex_stage(cfg, tstate, td, tss)
    planes, _ = tframe._raster_stage(cfg, tstate, td, ex, uv, clip, wn, wt)
    return cfg, state, ss, tstate, tss, planes


def test_assemble_gplanes_environment_matches(jax_scene):
    """_assemble_gplanes with the skybox environment (no shadows): every
    K2 plane within atol 1e-4 on >= 99.9% of pixels, and the specular
    env and env-BRDF planes within atol 1e-3 everywhere."""
    cfg, state, ss, tstate, tss, planes = jax_scene
    jst = jax.tree.map(jnp.asarray, state)
    jpl = {k: jnp.asarray(v.numpy()) for k, v in planes.items()}
    a, _ = jframe._assemble_gplanes(cfg, jpl, jst, jax.tree.map(jnp.asarray, ss),
                                    jst["ibl"], None, cfg.padded_width,
                                    cfg.padded_height)
    b, mask = tframe._assemble_gplanes(cfg, planes, tstate, tss,
                                       dict(sun=None, spot=None),
                                       cfg.padded_width, cfg.padded_height)
    assert sorted(a) == sorted(b)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(planes["visf"]) >= 0)
    for k in sorted(b):
        x, y = np.asarray(a[k]), b[k].numpy()
        ok = np.abs(x - y) <= 1e-4
        assert ok.mean() >= 0.999, (k, ok.mean())
    for k in ("esr", "esg", "esb", "eb0", "eb1", "eb2"):
        assert np.asarray(a[k]).std() > 1e-3, k        # a real environment
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), atol=1e-3,
                                   rtol=0, err_msg=k)


def test_sky_planes_match(jax_scene):
    """The quarter-res sky planes upsampled 4x, against the JAX
    package's composition (render/frame.py, the megakernel sky inputs):
    rtol 1e-4 / atol 1e-5; and the SH rotation of the frame."""
    cfg, state, ss, tstate, tss, _ = jax_scene
    w, h = cfg.padded_width, cfg.padded_height
    proj, iv = jnp.asarray(ss["proj"]), jnp.asarray(ss["invview"])
    skyrot = jnp.asarray(ss["camera"]["skyrot_inv"])
    rx, ry = jrays(j_inv_proj(proj), w, h)
    rays = jnp.stack([rx, ry, -jnp.ones_like(rx)], -1) @ iv[:3, :3].T
    rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
    rays_q = jpool(rays, 4) @ skyrot.T
    lod = jnp.maximum(jnp.float32(ss["camera"]["skyboxlod"]), 0.0)
    flatp = jax.tree.map(jnp.asarray, state["ibl"]["flatp"])
    sky_q = jsamp.sample_cubemap_lod_pair(
        flatp, rays_q, jnp.broadcast_to(lod, rays_q.shape[:-1]))[..., :3]
    a = np.asarray(jup_batch(jnp.transpose(sky_q, (2, 0, 1)), h, w))
    b = tframe._sky_planes(tstate["ibl"], tss, w, h).numpy()
    assert b.shape == (3, h, w) and b.mean() > 0.05
    _close(a, b, atol=1e-5)
    _close(jibl.rotate_sh9(jnp.asarray(state["ibl"]["sh"]), skyrot),
           tibl.rotate_sh9(tstate["ibl"]["sh"], tss["camera"]["skyrot_inv"]).numpy(),
           atol=1e-6)
