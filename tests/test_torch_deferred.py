"""The deferred (non-megakernel) path's modules of the port against the
JAX package (CPU): the samplers of the legacy texture pool and the flat
and quad-packed cubemap chains, the gbuffer resolve (scan raster, K5's
barycentrics, the material-map table) and gbuffer_from_planes with every
texture filter, the BRDF evaluators, PCF and the perspective spot maps,
the clustered point-light loop, the XLA lighting pass, the gbuffer
decals, the fog apply and the XLA weighted-blend OIT
(tests/test_torch_deferred_light.py holds the shadows and the lighting
on the same scene).

One scene (datumtest_scene at 256x128, the JAX package's state through
convert.to_torch) gives the inputs; the port's vertex stage, binning and
scan raster make the per-pixel ones, and the same arrays go through both
packages' functions, the JAX ones eagerly.  Tolerances:
- integer outputs (ids, masks, texel picks) exact; the scan-raster
  shadow stacks bit-equal;
- planes, gbuffers and factors atol 2e-5 / rtol 1e-4;
- the WBOIT accumulation atol 2e-5 / rtol 1e-4 on the weights (rtol
  1e-4 of their 300 cap).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datum_tpu.ops import blend as j_blend
from datum_tpu.ops import brdf as j_brdf
from datum_tpu.ops import decal as j_decal
from datum_tpu.ops import fog as j_fog
from datum_tpu.ops import sampling as j_sampling
from datum_tpu.ops import shade as j_shade
from datum_tpu.render.types import make_sceneset as jax_make_sceneset
from datum_tpu.scenes import datumtest_scene as jax_datumtest_scene

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops import blend, brdf, decal, fog, lighting_pass
from datum_tpu_torch.ops import raster as raster_ops
from datum_tpu_torch.ops import sampling, shade
from datum_tpu_torch.ops.raster_v1_cuda import raster_v1
from datum_tpu_torch.render import frame as fm

W, H = 256, 128
TOL = dict(atol=2e-5, rtol=1e-4)
SCENE = dict(width=W, height=H, sphere_detail=8, grid=(4, 3), n_point_lights=4,
             skybox=True, skybox_size=16, max_vertices=4096, max_triangles=4096,
             bin_capacity=128, big_capacity=32, shadow_res=256,
             shadow_bin_capacity=320, max_decals_active=2, max_particle_quads=512,
             max_translucent_draws=2, max_translucent_tris=2048,
             forward_bin_capacity=256, forward_big_capacity=16)


def _np(x):
    """Any tree of tensors / jax arrays -> numpy."""
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    if torch.is_tensor(x):
        return x.numpy()
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return np.asarray(x)


def _jx(x):
    """Any tree of tensors / numpy arrays -> jax arrays (the JAX
    functions index with traced values inside their scans and loops)."""
    return jax.tree.map(lambda v: jnp.asarray(v) if isinstance(v, (np.ndarray, np.generic))
                        else v, _np(x))


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **(tol or TOL))


@pytest.fixture(scope="module")
def sc():
    """The scene's state, draws and sceneset in both forms, and the
    port's per-pixel inputs: vertex stage, binning, scan raster."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx, camera, params, make_rl = jax_datumtest_scene(**SCENE)
        cfg = ctx.config
        rl = make_rl(0.3)
        ss = jax_make_sceneset(camera, params, point_lights=rl.point_lights,
                               spot_lights=rl.spot_lights)
        draws = rl.draw_arrays(cfg.max_instances, ctx.default_material)
        draws["decals"] = rl.decal_arrays(cfg.max_decals_active)
        draws["forward"] = rl.forward_arrays(cfg.max_particle_quads, camera)
        draws["translucent"] = rl.translucent_arrays(cfg.max_translucent_draws,
                                                     ctx.default_material)
        fm.attach_host_expansion(ctx.pool, draws, cfg.max_vertices, cfg.max_triangles,
                                 cfg.max_translucent_tris)
        state = jax.tree.map(np.asarray, ctx.device_state())
        st, d, s = (to_torch(x, "cpu") for x in (state, draws, ss))
        ex, uv, clip, wn, wt, wp = fm._vertex_stage(cfg, st, d, s)
        setup, bins, counts, big, _ = fm._bin_stage(cfg, ex, clip)
        depth, vis = raster_ops.raster(setup, bins, big, cfg.tiles_x, cfg.tiles_y, W, H)
        _, wpos = lighting_pass.reconstruct_positions(depth, s["proj"], s["invview"], W, H)
    finally:
        torch.set_num_threads(threads)
    return SimpleNamespace(cfg=cfg, state=state, st=st, d=d, s=s, ss=ss, ex=ex, uv=uv,
                           wn=wn, wt=wt, wp=wp, setup=setup, bins=bins, counts=counts,
                           big=big, depth=depth, vis=vis, wpos=wpos)


def _resolve_args(sc, lam=None, matmaps=False, material_maps=True):
    """(args, kwargs) of resolve_gbuffer in torch form."""
    args = (sc.vis, sc.setup, sc.ex["tris"], sc.ex["tri_draw"],
            dict(uv=sc.uv, normal=sc.wn, tangent=sc.wt),
            dict(material=sc.d["material"]), sc.st["materials"], sc.st["textures"], W, H)
    kw = dict(material_maps=material_maps, lam=lam,
              matmaps=sc.st["matmaps"] if matmaps else None)
    return args, kw


def _gbuffer(sc, **kw):
    args, kw = _resolve_args(sc, **kw)
    return shade.resolve_gbuffer(*args, **kw)


# ---------------------------------------------------------------- samplers

@pytest.mark.parametrize("mode", [0, 1], ids=["repeat", "clamp"])
def test_sample_bilinear_matches_jax(sc, mode):
    rng = np.random.RandomState(1)
    uv = (rng.rand(64, 96, 2) * 3 - 1).astype(np.float32)
    ids = rng.randint(0, 4, (64, 96)).astype(np.int32)
    tex = sc.state["textures"]
    a = j_sampling.sample_bilinear(tex, ids, uv, mode=mode)
    b = sampling.sample_bilinear(torch.from_numpy(tex), torch.from_numpy(ids),
                                 torch.from_numpy(uv), mode=mode)
    _close(a, b)
    img = tex[3, :40, :56]
    a = j_sampling.sample_image_bilinear(img, uv, mode=mode)
    b = sampling.sample_image_bilinear(torch.from_numpy(img), torch.from_numpy(uv),
                                       mode=mode)
    _close(a, b)


def test_flat_and_quad_tables_match_jax(sc):
    """The port's set_skybox tables equal the JAX package's (its quad
    table is bitcast to u8 for the TPU's gathers; to_torch views it as
    the f32 rows again)."""
    mips = [np.asarray(m) for m in sc.state["ibl"]["mips"]]
    jf = _np(j_sampling.flatten_cube_mips(mips))
    tf = _np(sampling.flatten_cube_mips([torch.from_numpy(m) for m in mips]))
    tq = _np(sampling.flatten_cube_mips_quad([torch.from_numpy(m) for m in mips]))
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(sc.st["ibl"]["flatq"], tq):
        np.testing.assert_array_equal(a.numpy(), b)
    assert sc.st["ibl"]["flatq"][0].dtype == torch.float32


@pytest.mark.parametrize("sampler", ["lod", "flat", "quad"])
def test_cubemap_lod_samplers_match_jax(sc, sampler):
    rng = np.random.RandomState(2)
    d = rng.randn(48, 64, 3).astype(np.float32)
    lod = (rng.rand(48, 64) * 8 - 1).astype(np.float32)
    ibl_j, ibl_t = sc.state["ibl"], sc.st["ibl"]
    if sampler == "lod":
        a = j_sampling.sample_cubemap_lod(list(ibl_j["mips"]), d, lod)
        b = sampling.sample_cubemap_lod(list(ibl_t["mips"]), torch.from_numpy(d),
                                        torch.from_numpy(lod))
    elif sampler == "flat":
        a = j_sampling.sample_cubemap_lod_flat(ibl_j["flat"], d, lod)
        b = sampling.sample_cubemap_lod_flat(ibl_t["flat"], torch.from_numpy(d),
                                             torch.from_numpy(lod))
    else:
        a = j_sampling.sample_cubemap_lod_quad(ibl_j["flatq"], d, lod)
        b = sampling.sample_cubemap_lod_quad(ibl_t["flatq"], torch.from_numpy(d),
                                             torch.from_numpy(lod))
    _close(a, b)


# ---------------------------------------------------------------- gbuffer

@pytest.mark.parametrize("variant", ["scan", "k5_lam", "matmaps", "no_material_maps"])
def test_resolve_gbuffer_matches_jax(sc, variant):
    lam = None
    if variant == "k5_lam":
        _, _, l0, l1 = raster_v1(sc.setup, sc.bins, sc.big, sc.counts, sc.cfg.tiles_x,
                                 sc.cfg.tiles_y, W, H)
        lam = torch.stack([l0, l1, 1.0 - l0 - l1], -1)
    args, kw = _resolve_args(sc, lam=lam, matmaps=variant == "matmaps",
                             material_maps=variant != "no_material_maps")
    b = shade.resolve_gbuffer(*args, **kw)
    # jitted, as the JAX frame runs it: XLA contracts the edge planes
    # a*xn + b*yn + c into fma(a, xn, b*yn) + c, as the port computes them
    resolve = jax.jit(j_shade.resolve_gbuffer,
                      static_argnames=("width", "height", "material_maps"))
    a = resolve(*_jx(args[:8]), width=W, height=H, **_jx(kw))
    assert 0.3 < b["mask"].float().mean() < 1.0
    np.testing.assert_array_equal(np.asarray(a["mask"]), b["mask"].numpy())
    for k in ("diffuse", "specular", "normal"):
        _close(a[k], b[k])


@pytest.mark.parametrize("filt", ["none", "nearest", "nearest_half", "nearest_quarter",
                                  "bilinear", "mip", "mip_half"])
def test_gbuffer_from_planes_matches_jax(sc, filt):
    from datum_tpu_torch.ops.raster_cuda import raster_shade
    p2 = raster_shade(sc.setup, sc.bins, sc.big, sc.counts, sc.ex["tris"], sc.uv, sc.wn,
                      sc.d["tri_mat"], sc.st["materials"], sc.cfg.tiles_x,
                      sc.cfg.tiles_y, W, H, tangent=sc.wt)
    planes = fm._k1_planes(p2)
    b = shade.gbuffer_from_planes(planes, sc.st["textures"], texture_filter=filt,
                                  matmaps=sc.st["matmaps"])
    a = j_shade.gbuffer_from_planes(_np(planes), sc.state["textures"],
                                    texture_filter=filt, matmaps=sc.state["matmaps"])
    np.testing.assert_array_equal(np.asarray(a["mask"]), b["mask"].numpy())
    for k in ("diffuse", "specular", "normal"):
        _close(a[k], b[k])


# ---------------------------------------------------------------- BRDF

def _brdf_inputs():
    rng = np.random.RandomState(3)
    n = (16, 24)
    unit = lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    pos = (rng.randn(*n, 3) * 3).astype(np.float32)
    nrm = unit(rng.randn(*n, 3))
    eye = unit(rng.randn(*n, 3) + nrm)
    alb = rng.rand(*n, 3).astype(np.float32)
    rough = (rng.rand(*n) * 0.9 + 0.05).astype(np.float32)
    met = rng.rand(*n).astype(np.float32)
    refl = rng.rand(*n).astype(np.float32)
    em = rng.rand(*n).astype(np.float32)
    return pos, nrm, eye, alb, rough, met, refl, em


@pytest.mark.parametrize("fn", ["material", "main", "point", "spot", "env", "probe",
                                "dominant"])
def test_brdf_matches_jax(fn):
    pos, nrm, eye, alb, rough, met, refl, em = _brdf_inputs()
    t = lambda *xs: [torch.from_numpy(np.asarray(x)) for x in xs]
    jm = j_brdf.make_material(alb, em, met, refl, rough)
    tm = brdf.make_material(*t(alb, em, met, refl, rough))
    if fn == "material":
        for k in ("diffuse", "specular", "emissive", "alpha"):
            _close(jm[k], tm[k])
        return
    light = np.float32([2.0, 3.0, 1.0])
    inten = np.float32([3.0, 2.5, 2.0])
    att = np.float32([0.3, 0.1, 1.0, 9.0])
    dirn = np.float32([-0.4, -0.8, -0.45]) / np.float32(1.0076)
    if fn == "main":
        sf = np.random.RandomState(4).rand(*rough.shape).astype(np.float32)
        a = j_brdf.main_light(nrm, eye, jm, dirn, inten, np.float32(0.9), sf)
        b = brdf.main_light(*t(nrm, eye), tm, *t(dirn, inten, np.float32(0.9), sf))
    elif fn == "point":
        a = j_brdf.point_light(pos, nrm, eye, jm, light, inten, att)
        b = brdf.point_light(*t(pos, nrm, eye), tm, *t(light, inten, att))
    elif fn == "spot":
        a = j_brdf.spot_light(pos, nrm, eye, jm, light, inten, att, dirn,
                              np.float32(0.6), np.float32(0.7))
        b = brdf.spot_light(*t(pos, nrm, eye), tm, *t(light, inten, att, dirn,
                                                      np.float32(0.6), np.float32(0.7)))
    elif fn == "env":
        rng = np.random.RandomState(5)
        ed, es, eb = (rng.rand(*rough.shape, 3).astype(np.float32) for _ in range(3))
        amb = rng.rand(*rough.shape).astype(np.float32)
        a = j_brdf.env_light(jm, ed, es, eb, amb)
        b = brdf.env_light(tm, *t(ed, es, eb, amb))
    elif fn == "probe":
        sh = np.random.RandomState(6).randn(9, 3).astype(np.float32)
        a = (j_brdf.probe_irradiance(sh, nrm),)
        b = (brdf.probe_irradiance(*t(sh, nrm)),)
    else:
        a = (j_brdf.diffuse_dominant_direction(nrm, eye, rough),)
        b = (brdf.diffuse_dominant_direction(*t(nrm, eye, rough)),)
    for x, y in zip(a, b):
        _close(x, y)


# ---------------------------------------------------------------- decals, fog, OIT

@pytest.mark.parametrize("textured", [False, True], ids=["flat", "textured"])
def test_apply_decals_matches_jax(sc, textured):
    gb = _gbuffer(sc)
    dec = dict(sc.d["decals"])
    if textured:
        # the checker (albedo) and the flat normal map of the pool
        dec["albedomap"] = torch.tensor([3, -1], dtype=torch.int32)
        dec["normalmap"] = torch.tensor([1, 1], dtype=torch.int32)
    tex = sc.st["textures"] if textured else None
    b = decal.apply_decals(gb, sc.wpos, dec, textures=tex)
    a = j_decal.apply_decals(_np(gb), _np(sc.wpos), _np(dec),
                             textures=None if tex is None else _np(tex))
    moved = (b["diffuse"] - gb["diffuse"]).abs().amax(-1) > 1e-3
    assert int(moved.sum()) > 50
    for k in ("diffuse", "specular", "normal"):
        _close(a[k], b[k])


def test_apply_fog_matches_jax(sc):
    s = dict(sc.s, camera=dict(sc.s["camera"],
                               fogdensity=torch.tensor([0.6, 0.65, 0.7, 0.04])))
    vol = fog.build_fog_volume(s, proj=s["proj"], invview=s["invview"])
    hdr = torch.from_numpy(np.random.RandomState(12).rand(H, W, 3).astype(np.float32))
    b = fog.apply_fog(hdr, sc.depth, vol, s["proj"], sample_scale=4)
    a = j_fog.apply_fog(_np(hdr), _np(sc.depth), _np(vol), sc.ss["proj"], sample_scale=4)
    assert float((b - hdr).abs().mean()) > 1e-3
    _close(a, b)


@pytest.mark.parametrize("stream", ["translucent", "particles"])
def test_xla_blend_matches_jax(sc, stream):
    """The XLA WBOIT raster (soft alpha for the particles) and its
    resolve."""
    cfg = sc.cfg
    if stream == "translucent":
        ts = fm.translucent_stream(sc.st, sc.d, sc.s)
        dd = ts["d"]
        clip, tris, uv, valid = ts["clip"], dd["tris"], ts["uv"], dd["t_valid"]
        color = sc.st["materials"]["color"][dd["material"][dd["vtx_draw"].long()].long()]
        n_tris, soft = cfg.max_translucent_tris, False
    else:
        fwd = sc.d["forward"]
        vp = sc.s["proj"] @ sc.s["view"]
        clip = fwd["positions"] @ vp[:, :3].T + vp[:, 3]
        tris = torch.from_numpy(fm.RenderList.quad_triangles(cfg.max_particle_quads))
        valid = torch.arange(tris.shape[0]) < fwd["quad_count"] * 2
        uv, color, n_tris, soft = fwd["uv"], fwd["color"], tris.shape[0], True
    setup = raster_ops.triangle_setup(clip, tris, W, H, cfg.tiles_x, cfg.tiles_y,
                                      tri_valid=valid)
    bins, _, big = raster_ops.bin_triangles(setup, n_tris, cfg.tiles_x, cfg.tiles_y,
                                            cfg.forward_bin_capacity,
                                            cfg.forward_big_capacity)
    args = (setup, bins, big, uv, color, tris, sc.depth, cfg.tiles_x, cfg.tiles_y, W, H)
    acc_b, rev_b = blend.raster_blend(*args, soft=soft)
    acc_a, rev_a = j_blend.raster_blend(*_jx(args), soft=soft)
    assert float((1.0 - rev_b).mean()) > 1e-3
    _close(acc_a, acc_b)
    _close(rev_a, rev_b)
    hdr = torch.from_numpy(np.random.RandomState(13).rand(H, W, 3).astype(np.float32))
    _close(j_blend.resolve_oit(_np(hdr), acc_a, rev_a, exposure=np.float32(1.3)),
           blend.resolve_oit(hdr, acc_b, rev_b, exposure=1.3))
    _close(j_blend.oit_weight(jnp.asarray(_np(sc.depth))), blend.oit_weight(sc.depth))
