"""The local-environment frame's post and host extras in the port
against the JAX package (CPU): the fog-plane arrays (exact), the
analytic fog planes, the DDA SSR, the skybox's cloud layer and the ESM
sun factor with the general second projection (affine_next=False), each
at atol 2e-5 / rtol 1e-4 on inputs made with numpy; and
RenderContext.render at params.scale 0.5 (the frame at half the
viewport, blitted back) against the JAX package's render, u8 RMSE <=
2/255 and mean |d| <= 0.5 levels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)
from test_torch_post import _gbuffer, scene  # noqa: F401 (fixture)
from datum_tpu.ops import fog as jfog
from datum_tpu.ops import lighting_pass as jlp
from datum_tpu.ops import shadow as jshadow
from datum_tpu.ops import skybox_gen as jsky
from datum_tpu.ops import ssr as jssr
from datum_tpu.render.renderlist import RenderList as JaxRenderList
from datum_tpu.scenes import datumtest_scene as jax_datumtest_scene

from datum_tpu_torch.ops import fog, shadow, skybox_gen, ssr
from datum_tpu_torch.render.context import RenderContext
from datum_tpu_torch.render.renderlist import RenderList
from datum_tpu_torch.scenes import datumtest_scene

TOL = dict(atol=2e-5, rtol=1e-4)
# tests/test_kitchen_sink.py's fog plane, and one the camera stands in
FOG_PLANES = [dict(color=(0.6, 0.65, 0.7, 0.5), plane=(0.0, 1.0, 0.0, -0.5),
                   density=0.05),
              dict(color=(0.3, 0.2, 0.5, 0.8), plane=(0.0, 1.0, 0.0, -8.0),
                   density=0.02, startdistance=2.0, falloff=0.8)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _fog_arrays(rl_cls, n_max):
    rl = rl_cls()
    for p in FOG_PLANES:
        rl.push_fogplane(**p)
    return rl.fogplane_arrays(n_max)


@pytest.mark.parametrize("n_max", [3, 1])
def test_fogplane_arrays_match(n_max):
    a, b = _fog_arrays(JaxRenderList, n_max), _fog_arrays(RenderList, n_max)
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == a[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k])


@pytest.mark.parametrize("n_max", [3, 1])
def test_apply_fog_planes_matches(scene, n_max):
    """Two planes (the camera outside the first, inside the second) and an
    unused slot, over a depth field with background."""
    g = _gbuffer(8)
    planes = _fog_arrays(RenderList, n_max)
    kw = dict(proj=scene["proj"], invview=scene["invview"], exposure=np.float32(1.3))
    a = jfog.apply_fog_planes(jnp.asarray(g["hdr"]), jnp.asarray(g["depth"]),
                              {k: jnp.asarray(v) for k, v in planes.items()},
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    b = fog.apply_fog_planes(_t(g["hdr"]), _t(g["depth"]),
                             {k: _t(v) for k, v in planes.items()},
                             **{k: _t(v) for k, v in kw.items()})
    assert np.abs(np.asarray(a) - g["hdr"]).max() > 0.05, "the fog moved nothing"
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_ssr_dda_matches(scene):
    """The DDA march on an hdr, a depth field with background, encoded
    normals, specular + roughness and a mask, with the env-BRDF LUT,
    against the JAX function jitted as the JAX frame runs it: on the
    background the strength is 0 (run eagerly, XLA leaves it NaN)."""
    g = _gbuffer(6, 68, 120)
    lut = RenderContext(device="cpu").envbrdf_lut()
    gb = dict(normal=g["nenc"], specular=np.concatenate([g["spec"], g["rough"][..., None]], -1),
              mask=g["depth"] > 0)
    args = (g["hdr"], g["depth"])
    a = np.asarray(jax.jit(jssr.ssr)(
        *map(jnp.asarray, args), {k: jnp.asarray(v) for k, v in gb.items()},
        jnp.asarray(scene["proj"]), jnp.asarray(scene["view"]),
        envbrdf_lut=jnp.asarray(lut)))
    b = ssr.ssr(*map(_t, args), {k: _t(v) for k, v in gb.items()}, _t(scene["proj"]),
                _t(scene["view"]), envbrdf_lut=_t(lut)).numpy()
    assert b.shape == (68, 120, 4) and np.isfinite(b).all()
    assert (a[..., 3] > 0).mean() > 0.05, "no reflection hit in the test field"
    assert (b[..., 3][g["depth"] == 0] == 0).all()
    np.testing.assert_allclose(b, a, **TOL)


@pytest.mark.parametrize("u8", [False, True], ids=["float", "u8"])
def test_generate_skybox_clouds_matches(u8):
    """The cloud layer: a density and a normal image, float or u8."""
    rng = np.random.RandomState(3)
    dens = rng.uniform(0, 1, (32, 32, 1)).astype(np.float32)
    nrm = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    if u8:
        dens, nrm = (np.round(x * 255).astype(np.uint8) for x in (dens, nrm))
    kw = dict(skycolor=(0.65, 0.57, 0.475), groundcolor=(0.41, 0.37, 0.32),
              sundirection=np.float32([-0.4, -0.7, -0.6]) / np.float32(1.0488088),
              sunintensity=(8.0, 7.56, 7.88), cloudheight=100.0,
              cloudcolor=(1.0, 0.95, 0.9, 0.8))
    a = np.asarray(jsky.generate_skybox(16, clouds=dict(density=jnp.asarray(dens),
                                                        normal=jnp.asarray(nrm)), **kw))
    b = skybox_gen.generate_skybox(16, clouds=dict(density=dens, normal=nrm), **kw).numpy()
    clear = skybox_gen.generate_skybox(16, **kw).numpy()
    assert np.abs(b - clear).max() > 0.05, "the clouds moved nothing"
    np.testing.assert_allclose(b, a, **TOL)


def test_shadow_factor_esm_fast_general_next_matches(scene):
    """affine_next=False: the second tap of the cascade blend projects
    through the next slice's own matrix; ESM maps, zmax and zscale made
    with numpy, the scene's split distances and cascade matrices."""
    rng = np.random.RandomState(17)
    g = _gbuffer(9)
    ml = scene["mainlight"]
    esm = rng.uniform(0.2, 40.0, (4, 64, 64)).astype(np.float32)
    zmax = rng.uniform(0.8, 1.0, 4).astype(np.float32)
    zscale = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    depth = np.where(g["depth"] > 0, g["depth"], np.float32(0.02))
    vp, wp = (np.asarray(x) for x in jlp.reconstruct_positions(
        jnp.asarray(depth), jnp.asarray(scene["proj"]), jnp.asarray(scene["invview"]),
        depth.shape[1], depth.shape[0]))
    nrm = g["nenc"] * 2.0 - 1.0
    args = (wp, esm, zmax, zscale, ml["splits"], ml["shadowview"], -vp[..., 2])
    out = {}
    for affine in (False, True):
        a = np.asarray(jshadow.shadow_factor_esm_fast(
            *map(jnp.asarray, args), normal=jnp.asarray(nrm), slice_blend=0.25,
            affine_next=affine))
        b = shadow.shadow_factor_esm_fast(*map(_t, args), normal=_t(nrm), slice_blend=0.25,
                                          affine_next=affine).numpy()
        np.testing.assert_allclose(b, a, **TOL)
        out[affine] = b
    assert (out[False] < 0.99).mean() > 0.05
    assert (out[False] != out[True]).any(), "the blend seams never differ"


SMALL = dict(width=256, height=128, sphere_detail=8, grid=(4, 3), n_point_lights=8,
             skybox=False, max_vertices=2048, max_triangles=2048, bin_capacity=320,
             big_capacity=16, bin_max_span=8, use_pallas=True,
             enable_material_maps=True, texture_filter="mip_half",
             enable_shadows=False)


def test_render_scaled_matches_jax_render():
    """RenderContext.render with params.scale 0.5: each package renders
    its own scene state at 128x64 and blits it to 256x128."""
    jctx, jcam, jparams, jmake = jax_datumtest_scene(pallas_interpret=True, **SMALL)
    tctx, tcam, tparams, tmake = datumtest_scene(device="cpu", **SMALL)
    jparams.scale = tparams.scale = 0.5
    a = np.asarray(jctx.render(jcam, jmake(0.3), jparams)).astype(np.float32)
    b = tctx.render(tcam, tmake(0.3), tparams).astype(np.float32)
    assert a.shape == b.shape == (128, 256, 3)
    assert b.mean() > 10
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) <= 2.0
    assert tctx.bin_overflow == 0

