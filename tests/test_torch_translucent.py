"""The translucent slice's modules against the JAX package (CPU).

The same numpy inputs (made from a seed, or the small datumtest scene at
256x128 with its glass sphere, water patch, decals and particle cloud)
go through the JAX package and the port.  The JAX rasters and the shade
run as the JAX package's own tests run them, in Pallas interpret mode.
Each test states its tolerance; the forward bins are deep enough that
nothing overflows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

import test_torch_shade as shade_t
from datum_tpu.ops import blur as jblur
from datum_tpu.ops import decal as jdecal
from datum_tpu.ops import raster as jr
from datum_tpu.ops.raster_pallas import raster_blend_pallas, raster_shade_pallas
from datum_tpu.ops.shade_pallas import shade_deferred_pallas
from datum_tpu.render import frame as jframe
from datum_tpu.render.renderlist import RenderList as JaxRenderList
from datum_tpu.scenes import datumtest_scene as jax_datumtest_scene

from datum_tpu_torch.math import Transform, perspective_proj
from datum_tpu_torch.ops import blur as tblur
from datum_tpu_torch.ops import raster as tr
from datum_tpu_torch.ops import shade_cuda
from datum_tpu_torch.ops.decal import apply_decals_planes
from datum_tpu_torch.ops.raster_blend_cuda import (blend_inputs, raster_blend,
                                                   raster_blend_cuda)
from datum_tpu_torch.ops.raster_cuda import PLANE_NAMES, raster_shade
from datum_tpu_torch.ops.shade_cuda import (epilogue_inputs, shade_deferred,
                                            shade_epilogue_cuda,
                                            shade_epilogue_reference)
from datum_tpu_torch.render.context import RenderContext
from datum_tpu_torch.render.renderlist import RenderList
from datum_tpu_torch.scenes import datumtest_scene

H, W, TX, TY = 64, 256, 2, 2
SCENE = dict(width=256, height=128, sphere_detail=8, grid=(4, 3),
             n_point_lights=8, skybox=False, max_vertices=2048,
             max_triangles=2048, bin_capacity=128, big_capacity=16,
             bin_max_span=8, use_pallas=True, enable_material_maps=True,
             texture_filter="mip_half", enable_shadows=False,
             max_translucent_draws=2, max_translucent_tris=2048,
             translucent_lit=True, translucent_lit_layers=1,
             translucent_lit_scale=2, max_particle_quads=512,
             max_decals_active=2, decal_textures=False,
             forward_bin_capacity=256, forward_big_capacity=16)


def _to_jax(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


# -- K4: the weighted-blend OIT raster ---------------------------------------

def _blend_scene(seed=0, n=40):
    """Overlapping perspective triangles (w != 1), an opaque depth, a peel
    plane and mixed soft / peel flags."""
    rng = np.random.RandomState(seed)
    V = 3 * n
    pos = rng.uniform(-0.9, 0.9, (V, 2)).astype(np.float32)
    z = rng.uniform(0.1, 0.9, (V,)).astype(np.float32)
    w = rng.uniform(0.5, 2, (V,)).astype(np.float32)
    clip = np.concatenate([pos * w[:, None], (z * w)[:, None], w[:, None]],
                          -1).astype(np.float32)
    return dict(
        clip=clip, tris=np.arange(V, dtype=np.int32).reshape(n, 3),
        uv=rng.uniform(0, 1, (V, 2)).astype(np.float32),
        color=rng.uniform(0, 1, (V, 4)).astype(np.float32),
        opaque=rng.uniform(0, 0.3, (H, W)).astype(np.float32),
        peel=rng.uniform(0.3, 1.0, (H, W)).astype(np.float32),
        soft_flag=(rng.rand(n) > 0.5).astype(np.float32),
        peel_flag=(rng.rand(n) > 0.5).astype(np.float32))


@pytest.mark.parametrize("soft,peeled", [(True, False), ("per_tri", True),
                                         (False, False)],
                         ids=["soft", "per_tri-peel", "hard"])
def test_k4_plain_matches_pallas(soft, peeled):
    """raster_blend_reference (through raster_blend on CPU tensors)
    against raster_blend_pallas(interpret=True, planes=True): the five
    planes bit-identical on every pixel.  Both evaluate the planes, the
    interpolations, the weight and the sums as the same fused
    multiply-adds (ops/raster_blend_cuda.py); the minimum this test must
    hold is >= 99.9% of values within atol 1e-5 / rtol 1e-4."""
    s = _blend_scene()
    n = s["tris"].shape[0]
    js = jr.triangle_setup(jnp.asarray(s["clip"]), jnp.asarray(s["tris"]), W, H,
                           TX, TY)
    ts = tr.triangle_setup(torch.from_numpy(s["clip"]),
                           torch.from_numpy(s["tris"]), W, H, TX, TY)
    jb = jr.bin_triangles(js, n, TX, TY, 64, 8)
    tb = tr.bin_triangles(ts, n, TX, TY, 64, 8)
    extra = ("peel", "soft_flag", "peel_flag") if peeled else ()
    names = dict(peel="peel_depth", soft_flag="soft_flag", peel_flag="peel_flag")
    a = raster_blend_pallas(js, jb[0], jb[2], jb[1], *(
        jnp.asarray(s[k]) for k in ("tris", "uv", "color", "opaque")), TX, TY, W, H,
        soft=soft, planes=True, interpret=True,
        **{names[k]: jnp.asarray(s[k]) for k in extra})
    b = raster_blend(ts, tb[0], tb[2], tb[1], *(
        torch.from_numpy(s[k]) for k in ("tris", "uv", "color", "opaque")), TX, TY,
        W, H, soft=soft, **{names[k]: torch.from_numpy(s[k]) for k in extra})
    a = np.stack([np.asarray(x) for x in a])
    b = torch.stack(b).numpy()
    assert b.shape == (5, H, W) and np.isfinite(b).all()
    assert (b[4] < 1).mean() > 0.3, "too little coverage to test"
    close = np.isclose(b, a, atol=1e-5, rtol=1e-4)
    assert close.mean() >= 0.999, (~close).sum()
    np.testing.assert_array_equal(b, a)


def test_k4_peel_and_soft_flags_act():
    """In per_tri mode the peel plane removes peel-flagged fragments in
    front of it, and the soft flag thins the flagged quads' alpha."""
    s = _blend_scene(seed=1)
    ts = tr.triangle_setup(torch.from_numpy(s["clip"]), torch.from_numpy(s["tris"]),
                           W, H, TX, TY)
    bins, counts, big = tr.bin_triangles(ts, s["tris"].shape[0], TX, TY, 64, 8)
    t = {k: torch.from_numpy(v) for k, v in s.items()}

    def rev(**kw):
        out = raster_blend(ts, bins, big, counts, t["tris"], t["uv"], t["color"],
                           t["opaque"], TX, TY, W, H, **kw)
        return out[4]

    flags = dict(soft="per_tri", soft_flag=t["soft_flag"], peel_flag=t["peel_flag"])
    hard = rev(soft=False)
    assert (rev(**flags, peel_depth=t["peel"]) > rev(**flags)).any()
    assert (rev(**flags) >= hard).all() and (rev(**flags) > hard).any()


def test_k4_cuda_wrapper_refuses_cpu_tensors():
    s = _blend_scene()
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    ts = tr.triangle_setup(t["clip"], t["tris"], W, H, TX, TY)
    bins, counts, big = tr.bin_triangles(ts, s["tris"].shape[0], TX, TY, 64, 8)
    inp = blend_inputs(ts, bins, big, counts, t["tris"], t["uv"], t["color"],
                       t["opaque"], TX, W, H)
    before = raster_blend_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        raster_blend_cuda(**inp)
    assert raster_blend_cuda.launches == before


# -- K1 on the lit layer: alpha_in_alb and peel_depth ------------------------

def test_k1_alpha_in_alb_and_peel_match_pallas():
    """Two lit layers of two-sided triangles: the plain K1 with
    alpha_in_alb, then peeled strictly behind the first layer's depth,
    against raster_shade_pallas(interpret=True, early_z=False) with the
    same options: every plane bit-identical on every pixel."""
    rng = np.random.RandomState(4)
    hh, ww, tx, ty = 128, 256, 2, 4
    n_v, n_t = 80, 140
    proj = perspective_proj(np.radians(70), ww / hh, 0.1)
    pts = rng.randn(n_v, 3).astype(np.float32) * 2
    pts[:, 2] -= 6
    clip = (np.concatenate([pts, np.ones((n_v, 1), np.float32)], 1)
            @ proj.T).astype(np.float32)
    tris = rng.randint(0, n_v, (n_t, 3)).astype(np.int32)
    ctx = RenderContext()
    for i in range(5):
        ctx.add_material(color=(0.2 * i, 0.5, 0.7, 0.15 + 0.15 * i),
                         metalness=0.1 * i, roughness=0.3 + 0.1 * i,
                         absorb=0.1 * i)
    state = ctx.host_state()
    uv = rng.rand(n_v, 2).astype(np.float32)
    nrm = rng.randn(n_v, 3).astype(np.float32)
    tan = np.concatenate([rng.randn(n_v, 3), np.sign(rng.randn(n_v, 1))],
                         1).astype(np.float32)
    tri_mat = rng.randint(0, 6, n_t).astype(np.int32)
    js = jr.triangle_setup(jnp.asarray(clip), jnp.asarray(tris), ww, hh, tx, ty,
                           cull=0, max_span=4)
    ts = tr.triangle_setup(torch.from_numpy(clip), torch.from_numpy(tris), ww, hh,
                           tx, ty, cull=0, max_span=4)
    jb = jr.bin_triangles(js, n_t, tx, ty, 64, 8, max_span=4)
    tb = tr.bin_triangles(ts, n_t, tx, ty, 64, 8, max_span=4)
    mats = state["materials"]
    peel = None
    for layer in range(2):
        jp = raster_shade_pallas(
            js, jb[0], jb[2], jb[1], jnp.asarray(tris), jnp.asarray(uv),
            jnp.asarray(nrm), jnp.asarray(tri_mat), _to_jax(mats), tx, ty, ww, hh,
            interpret=True, planes_2d=True, tangent=jnp.asarray(tan),
            matmaps=_to_jax(state["matmaps"]), early_z=False, alpha_in_alb=True,
            peel_depth=None if peel is None else jnp.asarray(peel))
        tp = raster_shade(
            ts, tb[0], tb[2], tb[1], torch.from_numpy(tris), torch.from_numpy(uv),
            torch.from_numpy(nrm), torch.from_numpy(tri_mat),
            {k: torch.from_numpy(v) for k, v in mats.items()}, tx, ty, ww, hh,
            tangent=torch.from_numpy(tan), alpha_in_alb=True,
            peel_depth=None if peel is None else torch.from_numpy(peel))
        tp = {k: v.numpy() for k, v in tp.items()}
        covered = tp["visf"] >= 0
        assert covered.mean() > 0.2, (layer, covered.mean())
        for k in PLANE_NAMES:
            np.testing.assert_array_equal(np.asarray(jp[k]), tp[k],
                                          err_msg=f"layer {layer}: {k}")
        # the material alpha rides the albedo-id plane
        assert np.isin(tp["alb"][covered], mats["color"][:, 3]).all(), layer
        if peel is not None:
            assert (tp["depth"][covered] < peel[covered]).all()
        peel = tp["depth"]


# -- resize_matmul -------------------------------------------------------------

@pytest.mark.parametrize("nearest", [True, False], ids=["nearest", "bilinear"])
@pytest.mark.parametrize("shape,out", [((128, 256), (64, 128)),
                                      ((64, 128), (128, 256)),
                                      ((64, 128, 4), (128, 256)),
                                      ((128, 256, 2), (64, 128))],
                         ids=["2d-down", "2d-up", "hwc-up", "hwc-down"])
def test_resize_matmul_matches(nearest, shape, out):
    """Both resamples as two static-matrix products, 2-D and
    channel-last, up and down: rtol 1e-6."""
    img = np.random.RandomState(6).randn(*shape).astype(np.float32)
    a = np.asarray(jblur.resize_matmul(jnp.asarray(img), *out, nearest=nearest))
    b = tblur.resize_matmul(torch.from_numpy(img), *out, nearest=nearest).numpy()
    assert b.shape == out + shape[2:]
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


# -- decals --------------------------------------------------------------------

@pytest.mark.parametrize("textured", [False, True], ids=["flat", "textured"])
def test_apply_decals_planes_matches(textured):
    """Two oriented-box decals (one rotated, one with albedo and normal
    maps when textured) over random K2 planes: rtol 1e-5 / atol 1e-6."""
    rng = np.random.RandomState(8)
    hh, ww = 64, 128
    names = ("dr", "dg", "db", "sr", "sg", "sb", "rgh", "em", "nx", "ny", "nz",
             "depth")
    gpl = {k: rng.uniform(0, 1, (hh, ww)).astype(np.float32) for k in names}
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
    worldp = [((xx - 64) / 16).astype(np.float32),
              rng.uniform(-0.3, 0.3, (hh, ww)).astype(np.float32),
              ((yy - 32) / 16).astype(np.float32)]
    mask = rng.rand(hh, ww) > 0.2
    textures = rng.randint(0, 255, (3, 16, 16, 4)).astype(np.uint8)
    rl = RenderList()
    rl.push_decal(Transform.translation([-1.0, 0.0, 0.0]), [1.4, 0.8, 1.2],
                  color=(0.75, 0.1, 0.05, 0.85), roughness=0.35,
                  albedomap=1 if textured else -1, normalmap=2 if textured else -1)
    rot = Transform.translation([1.5, 0.0, 0.5]) * Transform.rotation([0, 1, 0], 0.6)
    rl.push_decal(rot, [1.0, 0.8, 1.0], color=(0.05, 0.05, 0.06, 0.9),
                  roughness=0.9, emissive=0.2)
    decals = rl.decal_arrays(3)
    tex = textures if textured else None
    a = jdecal.apply_decals_planes(_to_jax(gpl), [jnp.asarray(p) for p in worldp],
                                   _to_jax(decals), jnp.asarray(mask),
                                   textures=None if tex is None else jnp.asarray(tex))
    b = apply_decals_planes({k: torch.from_numpy(v) for k, v in gpl.items()},
                            [torch.from_numpy(p) for p in worldp],
                            {k: torch.from_numpy(np.asarray(v))
                             for k, v in decals.items()},
                            torch.from_numpy(mask),
                            textures=None if tex is None else torch.from_numpy(tex))
    assert sorted(a) == sorted(b)
    moved = 0
    for k in sorted(b):
        x, y = np.asarray(a[k]), b[k].numpy()
        np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6, err_msg=k)
        moved += int((y != gpl[k]).sum())
    assert moved > 1000, "the decals cover too little to test"


# -- the K2 epilogue: refraction, the nearest lit layer, the WBOIT resolve -----

def _epilogue_case():
    """The K2 test scene's planes plus a deeper lit layer (tr2), and the
    tr, refraction and oit groups.  tr_oy steps -4 on every band's first
    row and +4 on its last, so the vertical shift wraps inside the
    16-row band at both edges."""
    ss, g = shade_t._scene(), shade_t._gplanes()
    hh, ww = shade_t.H, shade_t.W
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
    cover = ((xx > 40) & (xx < 200) & (yy > 5)).astype(np.float32)
    oy = np.where(yy % 16 == 0, -4.0, np.where(yy % 16 == 15, 4.0,
                                               rng.uniform(-4, 4, (hh, ww))))
    u = lambda lo, hi: rng.uniform(lo, hi, (hh, ww))
    g.update(tr2_r=u(0, 2), tr2_g=u(0, 2), tr2_b=u(0, 2),
             tr2_a=cover * u(0.0, 0.6))
    grp = dict(tr_r=u(0, 2), tr_g=u(0, 2), tr_b=u(0, 2), tr_a=cover * u(0.1, 0.9),
               tr_ox=cover * u(-9, 9), tr_oy=cover * oy,
               oit_r=u(0, 3), oit_g=u(0, 3), oit_b=u(0, 3), oit_w=u(0, 2),
               oit_rev=u(0.2, 1))
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}
    return ss, f32(g), f32(grp)


@pytest.fixture(scope="module")
def epilogue_case():
    ss, g, grp = _epilogue_case()
    kw = dict(proj=jnp.asarray(ss["proj"]), invview=jnp.asarray(ss["invview"]),
              interpret=True)
    # the JAX kernel's lit background (lighting, sky, tr2) and its full
    # output with the tr, refraction and oit groups
    bg = np.array(shade_deferred_pallas(shade_t._jax_tree(g),
                                          shade_t._jax_tree(ss), **kw))
    full = np.asarray(shade_deferred_pallas(shade_t._jax_tree({**g, **grp}),
                                            shade_t._jax_tree(ss), **kw))
    return ss, g, grp, bg, full


def test_epilogue_plain_matches_pallas_on_its_background(epilogue_case):
    """The plain epilogue on the JAX kernel's own background (so that
    K2's lighting ulps stay out): bit-identical to the JAX kernel with
    the tr, tr_ox/oy and oit groups on every value, with the vertical
    shift wrapping at the 16-row band edges."""
    _, _, grp, bg, full = epilogue_case
    epi = epilogue_inputs({k: torch.from_numpy(v) for k, v in grp.items()})
    out = shade_epilogue_reference(torch.from_numpy(bg).permute(2, 0, 1), **epi)
    out = out.permute(1, 2, 0).numpy()
    # refraction moves values, also at the band edges
    no_refr = shade_epilogue_reference(torch.from_numpy(bg).permute(2, 0, 1),
                                       tr=epi["tr"], oit=epi["oit"])
    moved = np.abs(out - no_refr.permute(1, 2, 0).numpy()).max(-1) > 1e-3
    assert moved.mean() > 0.2
    assert moved[15::16].mean() > 0.2 and moved[16::16].mean() > 0.2
    np.testing.assert_array_equal(out, full)


def test_epilogue_band_wrap_differs_from_a_full_column_roll(epilogue_case,
                                                          monkeypatch):
    """The vertical shift wraps inside each 16-row band: the same
    epilogue with one band over the whole column (a plain column roll)
    gives other values on the band-edge rows and the same values away
    from them."""
    _, _, grp, bg, full = epilogue_case
    epi = epilogue_inputs({k: torch.from_numpy(v) for k, v in grp.items()})
    col = torch.from_numpy(bg).permute(2, 0, 1)
    monkeypatch.setattr(shade_cuda, "SHADE_ROWS", col.shape[1])
    rolled = shade_epilogue_reference(col, **epi).permute(1, 2, 0).numpy()
    differs = (rolled != full).any(-1)
    rows = np.arange(full.shape[0]) % 16
    edge = (rows < 4) | (rows >= 12)
    assert differs[edge].mean() > 0.1
    assert not differs[~edge].any()


def test_shade_with_translucent_groups_matches_pallas(epilogue_case):
    """K2 plus its epilogue (plain versions) against the JAX kernel with
    the tr, tr2, tr_ox/oy and oit groups: K2's tolerance (atol 2e-5 /
    rtol 1e-4 on >= 99.98% of values, rtol 5e-3 on all; see
    test_torch_shade.py), since refraction carries K2's few specular-peak
    ulps to neighbouring pixels."""
    ss, g, grp, _, full = epilogue_case
    tss = shade_t._torch_tree(ss)
    b = shade_deferred(shade_t._torch_tree({**g, **grp}), tss, proj=tss["proj"],
                       invview=tss["invview"]).numpy()
    assert b.shape == full.shape and np.isfinite(b).all()
    close = np.isclose(b, full, atol=2e-5, rtol=1e-4)
    assert close.mean() >= 0.9998, (~close).sum()
    np.testing.assert_allclose(b, full, atol=2e-5, rtol=5e-3)


def test_epilogue_cuda_wrapper_refuses_cpu_tensors():
    _, _, grp = _epilogue_case()
    epi = epilogue_inputs({k: torch.from_numpy(v) for k, v in grp.items()})
    bg = torch.zeros((3,) + epi["tr"].shape[1:])
    before = shade_epilogue_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        shade_epilogue_cuda(bg, **epi)
    assert shade_epilogue_cuda.launches == before


# -- host arrays and the translucent expansion (integer-exact) ----------------

@pytest.fixture(scope="module")
def scenes():
    """The JAX package's and the port's small translucent scene, with
    their render lists at t = 0.3."""
    out = []
    for fn in (jax_datumtest_scene, datumtest_scene):
        ctx, camera, params, make_rl = fn(**SCENE)
        out.append((ctx, camera, make_rl(0.3)))
    return out


def _assert_arrays_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_forward_arrays_equal(scenes):
    (jctx, jcam, jrl), (tctx, tcam, trl) = scenes
    a = jrl.forward_arrays(512, jcam)
    b = trl.forward_arrays(512, tcam)
    _assert_arrays_equal(a, b)
    assert int(b["quad_count"]) == 256


def test_translucent_and_decal_arrays_equal(scenes):
    (jctx, _, jrl), (tctx, _, trl) = scenes
    _assert_arrays_equal(jrl.translucent_arrays(2, jctx.default_material),
                         trl.translucent_arrays(2, tctx.default_material))
    _assert_arrays_equal(jrl.decal_arrays(2), trl.decal_arrays(2))
    assert int(trl.translucent_arrays(2, 0)["count"]) == 2


@pytest.mark.parametrize("quads", [1, 512])
def test_quad_triangles_equal(quads):
    a = JaxRenderList.quad_triangles(quads)
    b = RenderList.quad_triangles(quads)
    assert a.dtype == b.dtype and a.shape == b.shape == (2 * quads, 3)
    np.testing.assert_array_equal(a, b)


def test_host_translucent_expansion_matches_device_expansion(scenes):
    """The port's host expansion of draws["translucent"] against the JAX
    frame's on-device expand_draws at max_translucent_tris: src_v,
    vtx_draw, v_valid, tris, tri_draw and t_valid equal, and the
    per-triangle material that of the triangle's draw."""
    (jctx, _, jrl), (tctx, camera, trl) = scenes
    cfg = tctx.config
    td = jrl.translucent_arrays(cfg.max_translucent_draws, jctx.default_material)
    geom = jctx.device_state()["geometry"]
    a = jax.tree.map(np.asarray, jframe.expand_draws(
        geom, jnp.asarray(td["mesh"]), jnp.asarray(td["count"]), cfg.max_vertices,
        cfg.max_translucent_tris))
    draws = tctx.frame_draws(trl, camera)
    b = draws["translucent"]
    for k in ("src_v", "vtx_draw", "v_valid", "tris", "tri_draw", "t_valid"):
        assert a[k].shape == np.asarray(b[k]).shape, k
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    # the glass sphere and the water patch
    assert 50 < int(b["t_valid"].sum()) < cfg.max_translucent_tris
    np.testing.assert_array_equal(b["tri_mat"], td["material"][a["tri_draw"]])
