"""The port's shadow slice against the JAX package (CPU, small sizes).

Inputs are the small datumtest scene (256x128, cascades at 256 and
128, a 128 parabolic spot map) or made from a numpy seed; the same
numpy arrays go through both packages, and the JAX depth raster runs in
Pallas interpret mode, as its own tests run it, one tile per grid step
(see `one_tile_per_step`).  Each test states its tolerance."""

import datum_tpu.ops.raster_pallas as jrp
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu.ops import blur as jblur
from datum_tpu.ops import lighting_pass as jlp
from datum_tpu.ops import raster as jr
from datum_tpu.ops import shadow as js
from datum_tpu.ops.raster_pallas import raster_depth_pallas

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops import blur as tblur
from datum_tpu_torch.ops import lighting_pass as tlp
from datum_tpu_torch.ops import raster as tr
from datum_tpu_torch.ops import shadow as ts
from datum_tpu_torch.ops.raster_depth_cuda import (depth_inputs, raster_depth,
                                                   raster_depth_cuda,
                                                   raster_depth_reference)
from datum_tpu_torch.render import frame as frame_mod
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import datumtest_scene

SCENE = dict(width=256, height=128, sphere_detail=8, grid=(4, 3),
             n_point_lights=8, skybox=False, max_vertices=2048,
             max_triangles=2048, bin_capacity=128, big_capacity=16,
             bin_max_span=8, use_pallas=True, texture_filter="mip_half",
             shadow_res=256, shadow_far_res=128, shadow_slice_blend=0.25,
             shadow_bin_capacity=128, max_spot_shadows=1, spot_shadow_res=128)
CAP, BIG = 128, 16


@pytest.fixture(scope="module", autouse=True)
def one_tile_per_step():
    """Run the JAX depth raster one tile per grid step.  The number of
    tiles a grid step walks (DEPTH_TILES_PER_STEP) is TPU layout: it
    moves no value, and the depth maps are bit-identical at 1 and 16,
    but interpret mode unrolls the walk per tile of a step, so 16 costs
    ~15x the compile time on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrp, "DEPTH_TILES_PER_STEP", 1)
        yield


def _np(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def scene():
    """The small frame's world positions, triangles, sceneset and K1
    planes (the port's plain path), as numpy."""
    ctx, camera, params, make_rl = datumtest_scene(**SCENE)
    rl = make_rl(0.3)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights)
    draws = rl.draw_arrays(ctx.config.max_instances, ctx.default_material)
    ctx.expand_host(draws)
    cfg, state = ctx.config, ctx.device_state("cpu")
    d, s = to_torch(draws, "cpu"), to_torch(ss, "cpu")
    ex, uv, clip, wn, wt, worldp = frame_mod._vertex_stage(cfg, state, d, s)
    planes, _ = frame_mod._raster_stage(cfg, state, d, ex, uv, clip, wn, wt)
    return dict(ss=ss, worldp=worldp.numpy(), tris=ex["tris"].numpy(),
                planes=_np(planes))


def _stacks(scene):
    """(name, port stack): the near and far cascade stacks and the spot
    stack of the small frame."""
    wp, tris = torch.from_numpy(scene["worldp"]), torch.from_numpy(scene["tris"])
    ml, sl = scene["ss"]["mainlight"], scene["ss"]["spotlights"]
    near, far = ts.cascade_stacks(wp, tris, torch.from_numpy(ml["shadowview"]),
                                  res=SCENE["shadow_res"],
                                  far_res=SCENE["shadow_far_res"])
    spot = ts.spot_stack_parabolic(wp, tris, torch.from_numpy(sl["view"]),
                                   torch.from_numpy(sl["attenuation"][:, 3]), 1,
                                   res=SCENE["spot_shadow_res"])
    return dict(near=near, far=far, spot=spot)


def test_triangle_setup_comps_ylim_exact():
    """The per-triangle y scissor rides row16 slots 14-15; the whole row
    (and zbound) is bit-equal to the JAX package's."""
    rng = np.random.RandomState(0)
    T = 300
    comps = {f"{c}{j}": (rng.randn(T) * 0.8).astype(np.float32)
             for c in "xyz" for j in range(3)}
    for j in range(3):
        comps[f"w{j}"] = (1.0 + 0.2 * rng.rand(T)).astype(np.float32)
    shared = rng.rand(T) < 0.05
    lo = (-1.0 + (np.arange(T) // (T // 4)) * 0.5).astype(np.float32)
    hi = lo + np.float32(0.5)
    kw = dict(cull=-1, max_span=4)
    a = jr.triangle_setup_comps({k: jnp.asarray(v) for k, v in comps.items()},
                                jnp.asarray(shared), 256, 1024, 2, 32,
                                ylim=(jnp.asarray(lo), jnp.asarray(hi)), **kw)
    b = tr.triangle_setup_comps({k: torch.from_numpy(v) for k, v in comps.items()},
                                torch.from_numpy(shared), 256, 1024, 2, 32,
                                ylim=(torch.from_numpy(lo), torch.from_numpy(hi)),
                                **kw)
    np.testing.assert_array_equal(np.asarray(a["row16"]), b["row16"].numpy())
    np.testing.assert_array_equal(np.asarray(a["zbound"]), b["zbound"].numpy())
    np.testing.assert_array_equal(b["row16"][:, 14].numpy(), lo)
    np.testing.assert_array_equal(b["row16"][:, 15].numpy(), hi)
    # no ylim: the open scissor
    c = tr.triangle_setup_comps({k: torch.from_numpy(v) for k, v in comps.items()},
                                torch.from_numpy(shared), 256, 1024, 2, 32, **kw)
    assert c["row16"][:, 14].eq(-8).all() and c["row16"][:, 15].eq(8).all()


@pytest.mark.parametrize("stack", ["near", "far", "spot"])
@pytest.mark.parametrize("capacity", [8, CAP])
def test_bin_triangles_stacks_exact(scene, stack, capacity):
    """bins, counts, big_ids, overflow and zub exactly equal to the JAX
    package's on the same setup (tri_block on the cascade stacks,
    depth_prio everywhere); capacity 8 overflows, so the kept triangles
    follow the key."""
    st = _stacks(scene)[stack]
    setup = st["setup"]
    jsetup = dict(bbox_soa=tuple(jnp.asarray(v.numpy()) for v in setup["bbox_soa"]),
                  valid=jnp.asarray(setup["valid"].numpy()),
                  big=jnp.asarray(setup["big"].numpy()))
    args = (st["n_tris"], st["tiles_x"], st["tiles_y"], capacity, BIG)
    kw = dict(max_span=ts.STACK_SPAN, return_overflow=True, return_zub=True)
    a = jr.bin_triangles(jsetup, *args, depth_prio=jnp.asarray(
        setup["zbound"].numpy()), tri_block=st["tri_block"], **kw)
    b = tr.bin_triangles(setup, *args, depth_prio=setup["zbound"],
                         tri_block=st["tri_block"], **kw)
    for name, x, y in zip(("bins", "counts", "big_ids", "overflow", "zub"), a, b):
        x = np.asarray(x)
        assert x.dtype == y.numpy().dtype, name
        np.testing.assert_array_equal(x, y.numpy(), err_msg=name)
    assert (stack == "spot") == (st["tri_block"] is None)
    if capacity == 8:
        assert int(b[3]) > 0, "capacity 8 should overflow"


@pytest.mark.parametrize("stack", ["near", "far", "spot"])
def test_k3_plain_matches_pallas(scene, stack):
    """raster_depth_reference vs raster_depth_pallas(interpret=True,
    early_z=False) on the same rows and bins: >= 99.99% of texels
    bit-identical, the rest within atol 1e-6."""
    st = _stacks(scene)[stack]
    bins, counts, big = ts.bin_stack(st, CAP, BIG)
    inp = depth_inputs(st["setup"], bins, big, counts, st["tiles_x"],
                       st["res"], st["height"])
    ref = raster_depth_reference(**inp).numpy()
    pal = np.asarray(raster_depth_pallas(
        {"row16": jnp.asarray(inp["rows"].numpy())}, jnp.asarray(bins.numpy()),
        jnp.asarray(big.numpy()), jnp.asarray(counts.numpy()), st["tiles_x"],
        st["tiles_y"], st["res"], st["height"], interpret=True, early_z=False))
    assert ref.shape == pal.shape == (st["height"], st["res"])
    assert (ref > 0).mean() > 0.05, "the stack covers too little"
    same = ref == pal
    print(f"{stack}: {same.mean():.6f} identical, {int((~same).sum())} differ")
    assert same.mean() >= 0.9999
    np.testing.assert_allclose(ref, pal, atol=1e-6, rtol=0)


def test_k3_y_scissor_and_strict_depth():
    """One triangle covering the whole viewport: the scissor keeps rows
    with ylo <= yn < yhi only, and a second, equal-depth copy changes
    nothing (strict test)."""
    W = H = 128
    clip = torch.tensor([[-3.0, -3.0, 0.5, 1], [3.0, -3.0, 0.5, 1],
                         [0.0, 3.0, 0.5, 1]] * 2)
    tris = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    setup = tr.triangle_setup(clip, tris, W, H, 1, 4, max_span=1,
                              ylim=(torch.tensor(-0.5), torch.tensor(0.25)))
    bins, counts, big = tr.bin_triangles(setup, 2, 1, 4, 8, 8, max_span=1)
    d = raster_depth(setup, bins, big, counts, 1, 4, W, H)
    yn = (torch.arange(H, dtype=torch.float32) + 0.5) * (2.0 / H) - 1.0
    rows = (yn >= -0.5) & (yn < 0.25)
    assert torch.equal(d[rows], torch.full((int(rows.sum()), W), 0.5))
    assert d[~rows].eq(0).all()


def test_k3_cuda_wrapper_refuses_cpu_tensors(scene):
    st = _stacks(scene)["spot"]
    bins, counts, big = ts.bin_stack(st, CAP, BIG)
    inp = depth_inputs(st["setup"], bins, big, counts, st["tiles_x"],
                       st["res"], st["height"])
    before = raster_depth_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        raster_depth_cuda(**inp)
    assert raster_depth_cuda.launches == before


@pytest.fixture(scope="module")
def cascades(scene):
    """Raw cascades of both packages, with and without far_res."""
    wp, tris = scene["worldp"], scene["tris"]
    sv = scene["ss"]["mainlight"]["shadowview"]
    out = {}
    for far_res, res in ((None, 128), (SCENE["shadow_far_res"],
                                       SCENE["shadow_res"])):
        kw = dict(res=res, bin_capacity=CAP, big_capacity=BIG, far_res=far_res)
        j = js.render_shadow_cascades(jnp.asarray(wp), jnp.asarray(tris),
                                      jnp.asarray(sv), use_pallas=True,
                                      interpret=True, early_z=False, **kw)
        t = ts.render_shadow_cascades(torch.from_numpy(wp),
                                      torch.from_numpy(tris),
                                      torch.from_numpy(sv), **kw)
        out[far_res] = ([np.asarray(m) for m in j], [m.numpy() for m in t])
    return out


@pytest.mark.parametrize("far_res", [None, 128])
def test_render_shadow_cascades_matches(cascades, far_res):
    """Raw cascade depth: same shapes (a list of mixed sizes with
    far_res), >= 99.99% of texels identical, all within rtol 1e-5."""
    j, t = cascades[far_res]
    assert [m.shape for m in j] == [m.shape for m in t]
    if far_res is not None:
        assert t[0].shape == (256, 256) and t[3].shape == (128, 128)
    jj, tt = (np.concatenate([m.ravel() for m in x]) for x in (j, t))
    assert (tt > 0).mean() > 0.05
    assert (jj == tt).mean() >= 0.9999
    np.testing.assert_allclose(tt, jj, rtol=1e-5, atol=0)


@pytest.mark.parametrize("far_res", [None, 128])
def test_build_esm_matches(scene, cascades, far_res):
    """build_esm on the same raw maps (mixed list with far_res): esm,
    zmax and zscale within rtol 1e-5."""
    raw = cascades[far_res][0]
    sv = scene["ss"]["mainlight"]["shadowview"]
    a = js.build_esm([jnp.asarray(m) for m in raw], jnp.asarray(sv))
    b = ts.build_esm([torch.tensor(m) for m in raw], torch.from_numpy(sv))
    assert b[0].shape == (4, raw[0].shape[0], raw[0].shape[0])
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5, atol=0)


def _close_share(a, b, atol):
    """Share of values within atol, and the count of the rest."""
    ok = np.abs(np.asarray(a) - np.asarray(b)) <= atol
    return ok.mean(), int((~ok).sum())


@pytest.mark.parametrize("slice_blend", [0.0, 0.25])
def test_sun_shadow_factor_quarter_matches(scene, cascades, slice_blend):
    """Quarter-res sun factor from the same depth, normals and ESM:
    >= 99.9% of values within atol 1e-4 (the rest are texels whose
    truncated index flips on an ulp of the reconstructed position)."""
    raw = cascades[128][0]
    ss, pl = scene["ss"], scene["planes"]
    sv = ss["mainlight"]["shadowview"]
    esm = js.build_esm([jnp.asarray(m) for m in raw], jnp.asarray(sv))
    jss = {"mainlight": {k: jnp.asarray(v) for k, v in ss["mainlight"].items()}}
    nrm = ("nx", "ny", "nz")
    a = js.sun_shadow_factor_quarter(
        jnp.asarray(pl["depth"]), tuple(jnp.asarray(pl[n]) for n in nrm), esm,
        jss, proj=jnp.asarray(ss["proj"]), invview=jnp.asarray(ss["invview"]),
        slice_blend=slice_blend)
    tss = to_torch({"mainlight": ss["mainlight"]}, "cpu")
    b = ts.sun_shadow_factor_quarter(
        torch.from_numpy(pl["depth"]), tuple(torch.from_numpy(pl[n]) for n in nrm),
        tuple(torch.tensor(np.asarray(x)) for x in esm), tss,
        proj=torch.from_numpy(ss["proj"]), invview=torch.from_numpy(ss["invview"]),
        slice_blend=slice_blend)
    assert b.shape == (32, 64)
    assert (b.numpy() < 0.9).sum() >= 10, "too few shadowed texels"
    share, rest = _close_share(a, b.numpy(), 1e-4)
    print(f"slice_blend {slice_blend}: {share:.6f} within 1e-4, {rest} not")
    assert share >= 0.999


def test_spot_factor_quarter_parabolic_matches(scene):
    """Parabolic spot maps and factor: the maps >= 99.99% identical (the
    spot stack is checked texel by texel in test_k3_plain_matches_pallas);
    build_spot_esm within rtol 1e-5; the factor, from the same ESM,
    >= 99.9% within atol 1e-4."""
    ss, pl = scene["ss"], scene["planes"]
    sl = ss["spotlights"]
    maps = ts.render_spot_maps_parabolic(
        torch.from_numpy(scene["worldp"]), torch.from_numpy(scene["tris"]),
        torch.from_numpy(sl["view"]), torch.from_numpy(sl["attenuation"][:, 3]),
        1, res=SCENE["spot_shadow_res"], bin_capacity=CAP, big_capacity=BIG)
    a_esm = js.build_spot_esm(jnp.asarray(maps.numpy()))
    b_esm = ts.build_spot_esm(maps)
    np.testing.assert_allclose(b_esm.numpy(), np.asarray(a_esm), rtol=1e-5)
    kw = dict(proj=ss["proj"], invview=ss["invview"])
    a = js.spot_factor_quarter_parabolic(
        jnp.asarray(pl["depth"]), a_esm[0], jnp.asarray(sl["view"][0]),
        jnp.asarray(sl["attenuation"][0, 3]),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    b = ts.spot_factor_quarter_parabolic(
        torch.from_numpy(pl["depth"]), torch.tensor(np.asarray(a_esm[0])),
        torch.from_numpy(sl["view"][0]), torch.tensor(sl["attenuation"][0, 3]),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    print("spot-shadowed texels:", int((b.numpy() < 0.9).sum()))
    assert (b.numpy() < 0.9).sum() >= 5, "too few spot-shadowed texels"
    share, rest = _close_share(a, b.numpy(), 1e-4)
    print(f"spot factor: {share:.6f} within 1e-4, {rest} not")
    assert share >= 0.999


@pytest.mark.parametrize("shape,sigma,radius", [((40, 56), 1.5, 3),
                                                ((33, 20, 3), 1.0, 2)])
def test_shifted_gaussian_blur_matches(shape, sigma, radius):
    """HDR input up to e^20 (the ESM range): rtol 1e-6, same tap order."""
    rng = np.random.RandomState(1)
    img = np.exp(rng.rand(*shape) * 20.0).astype(np.float32)
    np.testing.assert_array_equal(jblur.gaussian_kernel(sigma, radius),
                                  tblur.gaussian_kernel(sigma, radius))
    a = jblur.shifted_gaussian_blur(jnp.asarray(img), sigma, radius)
    b = tblur.shifted_gaussian_blur(torch.from_numpy(img), sigma, radius)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_reconstruct_positions_matches(scene):
    """View and world positions from reverse-Z depth, background (0)
    included: rtol 1e-5 / atol 1e-5; the ray grid exactly."""
    ss = scene["ss"]
    depth = scene["planes"]["depth"]
    proj, iv = ss["proj"], ss["invview"]
    a = jlp.reconstruct_positions(jnp.asarray(depth), jnp.asarray(proj),
                                  jnp.asarray(iv), 256, 128)
    b = tlp.reconstruct_positions(torch.from_numpy(depth), torch.from_numpy(proj),
                                  torch.from_numpy(iv), 256, 128)
    assert (depth == 0).any(), "no background texel"
    for x, y in zip(a, b):
        assert np.isfinite(y.numpy()).all()
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5, atol=1e-5)
    for x, y in zip(jlp.view_ray_grid(jlp._inv_proj(jnp.asarray(proj)), 64, 32),
                    tlp.view_ray_grid(tlp._inv_proj(torch.from_numpy(proj)), 64, 32)):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
