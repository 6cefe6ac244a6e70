"""The post slice's modules against the JAX package (CPU).

The same numpy inputs, made from a seed or taken from the small
datumtest scene's camera, go through the JAX package and the port:
HBAO with and without its temporal pass, the fog volume (with and
without the ESM) and its planes, K2's fog group, the binned SSR, the
DoF blur and amount, and the composite with SSR, DoF, bloom and the
exact LUT grade.  The JAX K2 runs in Pallas interpret mode.  Each test
states its tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_shade as shade_t
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)
from datum_tpu.ops import blur as jblur
from datum_tpu.ops import composite as jcomp
from datum_tpu.ops import fog as jfog
from datum_tpu.ops import ssao as jssao
from datum_tpu.ops import ssr2 as jssr2
from datum_tpu.ops.shade_pallas import shade_deferred_pallas
from datum_tpu.render.types import make_sceneset as jax_make_sceneset
from datum_tpu.scenes import datumtest_scene as jax_datumtest_scene

from datum_tpu_torch.ops import blur, composite, fog, ssao, ssr2
from datum_tpu_torch.ops.shade_cuda import (epilogue_inputs, shade_deferred,
                                            shade_epilogue_reference)
from datum_tpu_torch.render import frame as tframe
from datum_tpu_torch.render.camera import Camera
from datum_tpu_torch.render.context import RenderContext
from datum_tpu_torch.render.types import make_sceneset as tmake_sceneset
from datum_tpu_torch.scenes import datumtest_scene as tdatumtest_scene

H, W = 64, 128


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


@pytest.fixture(scope="module")
def scene():
    """The small datumtest scene's sceneset (numpy), sun cascades on, with
    a fog density (the scene's default is 0: no fog)."""
    ctx, camera, params, make_rl = jax_datumtest_scene(
        width=256, height=128, sphere_detail=8, grid=(4, 3), n_point_lights=4,
        skybox=False, max_vertices=2048, max_triangles=2048, bin_capacity=128,
        big_capacity=16, use_pallas=True, texture_filter="mip_half")
    params.fogdensity = np.float32([0.6, 0.65, 0.7, 0.04])
    rl = make_rl(0.3)
    ss = jax_make_sceneset(camera, params, point_lights=rl.point_lights,
                           spot_lights=rl.spot_lights)
    return {k: (np.asarray(v) if not isinstance(v, dict)
                else {kk: np.asarray(vv) for kk, vv in v.items()})
            for k, v in ss.items()}


def _gbuffer(seed, h=H, w=W):
    """A depth field with a background region, encoded world normals,
    specular, roughness and an hdr image."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (0.02 + 0.012 * np.sin(xx * 0.09) * np.cos(yy * 0.13)
             + 0.008 * ((xx // 16 + yy // 8) % 2))
    depth[: h // 5] = 0.0                         # background band
    depth[:, 5 * w // 6:][yy[:, 5 * w // 6:] < h // 2] = 0.0
    n = np.stack([0.4 * np.sin(xx * 0.07), 1.0 + 0 * xx, 0.4 * np.cos(yy * 0.11)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return dict(depth=depth.astype(np.float32),
                nenc=(n * 0.5 + 0.5).astype(np.float32),
                spec=rng.uniform(0.02, 0.9, (h, w, 3)).astype(np.float32),
                rough=rng.uniform(0.0, 0.5, (h, w)).astype(np.float32),
                hdr=rng.uniform(0.0, 3.0, (h, w, 3)).astype(np.float32))


def _within(a, b, atol, share):
    """At least `share` of the values of b within atol of a."""
    ok = np.abs(np.asarray(a) - np.asarray(b)) <= atol
    assert ok.mean() >= share, (ok.mean(), np.abs(np.asarray(a) - np.asarray(b)).max())


def test_hbao_params_equal():
    a, b = jssao.make_hbao_params(), ssao.make_hbao_params()
    for k in ("noise", "kernel"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("temporal", [False, True])
def test_hbao_matches(scene, temporal):
    """hbao, with and without the temporal prev: >= 99.9% of values
    within atol 1e-4 and all within 1e-3 (the 56 contributions are
    summed in another order; the reprojected tap is a floor)."""
    g = _gbuffer(1)
    proj, view = scene["proj"], scene["view"]
    prm = jssao.make_hbao_params()
    kw_j, kw_t = {}, {}
    if temporal:
        prev_view = view.copy()
        prev_view[:3, 3] += np.float32([0.05, -0.02, 0.03])
        g0 = _gbuffer(2)
        prev = np.asarray(jssao.hbao(_j(g0["depth"]), _j(g0["nenc"]), _j(proj),
                                     _j(prev_view), params=prm))
        kw_j = dict(prev_ao=_j(prev), prevview=_j(prev_view),
                    invview=_j(scene["invview"]))
        kw_t = dict(prev_ao=_t(prev), prevview=_t(prev_view),
                    invview=_t(scene["invview"]))
    a = np.asarray(jssao.hbao(_j(g["depth"]), _j(g["nenc"]), _j(proj), _j(view),
                              params=prm, **kw_j))
    b = ssao.hbao(_t(g["depth"]), _t(g["nenc"]), _t(proj), _t(view),
                  params=ssao.make_hbao_params(), **kw_t).numpy()
    assert b.shape == (H, W, 2)
    assert (b[..., 0] < 0.95).mean() > 0.05, "no occlusion in the test field"
    _within(a, b, 1e-4, 0.999)
    np.testing.assert_allclose(b, a, atol=1e-3, rtol=0)


@pytest.mark.parametrize("esm", [False, True], ids=["no-esm", "esm"])
def test_fog_volume_matches(scene, esm):
    """build_fog_volume, without and with the sun ESM (its coarsest
    cascade on the half-resolution grid): atol 2e-5 / rtol 1e-4."""
    rng = np.random.RandomState(3)
    shadow = None
    if esm:
        shadow = (rng.uniform(1.0, 3e8, (4, 64, 64)).astype(np.float32),
                  rng.uniform(0.6, 0.9, 4).astype(np.float32),
                  rng.uniform(0.02, 0.2, 4).astype(np.float32))
    ssj = {k: ({kk: _j(vv) for kk, vv in v.items()} if isinstance(v, dict) else _j(v))
           for k, v in scene.items()}
    sst = {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict) else _t(v))
           for k, v in scene.items()}
    a = np.asarray(jfog.build_fog_volume(
        ssj, proj=ssj["proj"], invview=ssj["invview"],
        shadow=None if shadow is None else tuple(map(_j, shadow))))
    b = fog.build_fog_volume(sst, proj=sst["proj"], invview=sst["invview"],
                             shadow=None if shadow is None else tuple(map(_t, shadow))
                             ).numpy()
    assert b.shape == (64, 90, 160, 4) and np.isfinite(b).all()
    assert b[..., :3].max() > 1e-3 and b[..., 3].min() < 0.999
    np.testing.assert_allclose(b, a, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("q", [8, 4])
def test_fog_planes_match(scene, q):
    """fog_planes (the quad-packed taps at 1/q resolution, upsampled):
    atol 2e-5 / rtol 1e-4."""
    rng = np.random.RandomState(4)
    vol = np.concatenate([rng.uniform(0, 0.3, (64, 90, 160, 3)),
                          rng.uniform(0.5, 1.0, (64, 90, 160, 1))], -1).astype(np.float32)
    depth = _gbuffer(5, 128, 256)["depth"]
    a = jfog.fog_planes(_j(depth), _j(vol), _j(scene["proj"]), sample_scale=q)
    b = fog.fog_planes(_t(depth), _t(vol), _t(scene["proj"]), sample_scale=q)
    for x, y in zip(a, b):
        assert y.shape == (128, 256)
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=2e-5, rtol=1e-4)


def test_epilogue_fog_matches_pallas():
    """K2's fog group: the port's epilogue on the JAX K2's own background
    equals the JAX K2 with the fog planes, exactly (the same bf16 planes,
    one fma as XLA contracts col * fog_t + fog_rgb); with a WBOIT group
    after it, the resolve reads the fogged colour."""
    ss, g = shade_t._scene(), shade_t._gplanes()
    rng = np.random.RandomState(12)
    Hs, Ws = g["depth"].shape
    fogp = dict(fog_r=rng.uniform(0, 0.4, (Hs, Ws)), fog_g=rng.uniform(0, 0.4, (Hs, Ws)),
                fog_b=rng.uniform(0, 0.4, (Hs, Ws)), fog_t=rng.uniform(0.3, 1.0, (Hs, Ws)))
    oitp = dict(oit_r=rng.uniform(0, 2, (Hs, Ws)), oit_g=rng.uniform(0, 2, (Hs, Ws)),
                oit_b=rng.uniform(0, 2, (Hs, Ws)), oit_w=rng.uniform(0, 3, (Hs, Ws)),
                oit_rev=rng.uniform(0, 1, (Hs, Ws)))
    kw = dict(proj=jnp.asarray(ss["proj"]), invview=jnp.asarray(ss["invview"]),
              interpret=True, planes_out=True)
    bg = np.stack(shade_deferred_pallas(shade_t._jax_tree(g), shade_t._jax_tree(ss), **kw))
    for extra in (fogp, dict(fogp, **oitp)):
        gx = dict(g, **{k: v.astype(np.float32) for k, v in extra.items()})
        a = np.stack(shade_deferred_pallas(shade_t._jax_tree(gx),
                                           shade_t._jax_tree(ss), **kw))
        epi = epilogue_inputs(shade_t._torch_tree(gx))
        assert epi["fog"].dtype == torch.bfloat16 and epi["tr"] is None
        b = shade_epilogue_reference(torch.from_numpy(bg), **epi).numpy()
        assert np.abs(a - bg).max() > 1e-3, "the fog moved nothing"
        np.testing.assert_array_equal(b, a)


def test_ssr_binned_matches(scene):
    """ssr_binned: >= 99.5% of the quarter-res values within atol 1e-3
    (bin ids and crossings flip on an ulp of arctan2 and the 1/z march)."""
    g = _gbuffer(6, 68, 120)
    lut = RenderContext().envbrdf_lut()
    mask = g["depth"] > 0
    args_np = (g["hdr"], g["depth"], g["nenc"], g["spec"], g["rough"], mask,
               scene["proj"], scene["view"])
    a = np.asarray(jssr2.ssr_binned(*map(_j, args_np), envbrdf_lut=_j(lut)))
    b = ssr2.ssr_binned(*map(_t, args_np), envbrdf_lut=_t(lut)).numpy()
    assert b.shape == (68, 120, 4) and np.isfinite(b).all()
    assert (b[..., 3] > 0).mean() > 0.05, "no reflection hit in the test field"
    _within(a, b, 1e-3, 0.995)


def test_dof_blur_and_amount_match(scene):
    """The DoF blur (half-res gaussian, dense upsample) and its amount
    from proj and the camera's focal fields: atol 2e-5 / rtol 1e-4."""
    g = _gbuffer(7, 64, 128)
    hdr, depth, proj = g["hdr"], g["depth"], scene["proj"]
    cam = dict(focaldistance=np.float32(14.0), focalwidth=np.float32(4.0))
    a_blur = jblur.resize_up_dense(jblur.gaussian_blur(jblur.downsample2(_j(hdr)), 3.0),
                                   64, 128)
    dist = proj[2, 3] / (_j(depth) + proj[2, 2])
    a_amt = jnp.clip(jnp.abs(dist - cam["focaldistance"])
                     / jnp.maximum(cam["focalwidth"], 1e-3), 0.0, 1.0)
    b_blur, b_amt = tframe.dof_fields(_t(hdr), _t(depth), _t(proj),
                                      {k: _t(v) for k, v in cam.items()})
    np.testing.assert_allclose(b_blur.numpy(), np.asarray(a_blur), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(b_amt.numpy(), np.asarray(a_amt), atol=2e-5, rtol=1e-4)


def test_set_depth_of_field():
    cam = Camera()
    cam.set_depth_of_field(4.0, 14.0)
    assert (cam.focalwidth, cam.focaldistance) == (4.0, 14.0)


@pytest.mark.parametrize("form", ["ssr-dof-bloom-lut", "glow-lut"])
def test_composite_matches(form):
    """composite with SSR, the DoF mix, bloom and the exact trilinear
    LUT grade (or the glow term): atol 2e-5."""
    rng = np.random.RandomState(8)
    hdr = rng.uniform(0, 4, (32, 48, 3)).astype(np.float32)
    lut = rng.uniform(0, 1, (8, 8, 8, 3)).astype(np.float32)
    if form == "glow-lut":
        kw = dict(glow=rng.uniform(0, 1, (32, 48, 3)).astype(np.float32), lut=lut)
    else:
        kw = dict(ssr=rng.uniform(0, 1, (32, 48, 4)).astype(np.float32),
                  dof_blur=rng.uniform(0, 3, (32, 48, 3)).astype(np.float32),
                  dof_amount=rng.uniform(0, 1, (32, 48)).astype(np.float32),
                  bloom=rng.uniform(0, 1, (32, 48, 3)).astype(np.float32),
                  bloom_strength=1.0, lut=lut)
    a = np.asarray(jcomp.composite(_j(hdr), 1.3, **{
        k: (_j(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}))
    b = composite.composite(_t(hdr), 1.3, **{
        k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(b, a, atol=2e-5, rtol=0)


def test_color_grade_exact_matches():
    rng = np.random.RandomState(9)
    lut = rng.uniform(0, 1, (16, 16, 16, 3)).astype(np.float32)
    c = rng.uniform(-0.1, 1.1, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(composite.color_grade(_t(lut), _t(c)).numpy(),
                               np.asarray(jcomp.color_grade(_j(lut), _j(c))),
                               atol=2e-6, rtol=0)


def test_exact_lut_state_and_frame():
    """set_colorlut(poly_tol=0) keeps the exact LUT in the state, as the
    JAX package's device state does, and the frame grades through the
    trilinear tap: within 2 levels of the polynomial grade, not equal."""
    kw = dict(width=128, height=64, sphere_detail=8, grid=(3, 2), n_point_lights=4,
              skybox=False, max_vertices=1024, max_triangles=1024, bin_capacity=64,
              big_capacity=16, use_pallas=True, texture_filter="mip_half",
              enable_shadows=False)
    jctx = jax_datumtest_scene(**kw)[0]
    jctx.set_colorlut(jctx.colorlut, poly_tol=0)
    ctx, camera, params, make_rl = tdatumtest_scene(device="cpu", **kw)
    lut = ctx.colorlut
    images = []
    for tol in (0.008, 0):
        ctx.set_colorlut(lut, poly_tol=tol)
        state = ctx.host_state()
        assert ("colorlut" in state) == (tol == 0) != ("colorlut_poly" in state)
        rl = make_rl(0.2)
        ss = tmake_sceneset(camera, params, point_lights=rl.point_lights,
                            spot_lights=rl.spot_lights)
        images.append(tframe.render_frame(ctx.config, state, ctx.frame_draws(rl, camera),
                                          ss, device="cpu")["image"].float())
    np.testing.assert_array_equal(state["colorlut"],
                                  np.asarray(jctx.device_state()["colorlut"]))
    d = (images[0] - images[1]).abs()
    assert d.max() > 0 and d.mean() <= 2.0
