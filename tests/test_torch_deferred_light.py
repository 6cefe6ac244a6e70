"""The deferred path's shadows and lighting of the port against the JAX
package (CPU), on tests/test_torch_deferred.py's scene: the scan-raster
cascade stack and perspective spot maps (use_pallas=False), PCF with its
split weights, the perspective spot factors, the clustered point-light
loop and the XLA lighting pass (shade_deferred) with the SH + quad
environment and the ESM factor, the flat environment with PCF and
clusters, the per-mip environment with shadowed spots and SSAO, and no
environment.  Tolerances:
- the scan-raster stacks and the single-tap spot test bit-equal;
- factors and light sums atol 2e-5 / rtol 1e-4;
- shade_deferred: 99.98% of values within atol 2e-5 / rtol 1e-4 and
  the rest (specular peaks) within rtol 5e-3, K2's CPU scheme (XLA's
  CPU rsqrt is an ulp off 1/sqrt, and GGX amplifies it ~1000x near
  N.H = 1; ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

from datum_tpu.ops import cluster as j_cluster
from datum_tpu.ops import lighting_pass as j_lp
from datum_tpu.ops import shadow as j_shadow

from test_torch_deferred import TOL, H, W, _close, _gbuffer, _jx, _np, sc  # noqa: F401
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu_torch.ops import brdf, cluster, lighting_pass, shadow
from datum_tpu_torch.render.frame import host_light_counts


# ---------------------------------------------------------------- shadows

def test_scan_shadow_cascades_match_jax(sc):
    """use_pallas=False: the cascade stack through the scan raster (no
    band scissor, as the JAX package's XLA path) — bit-equal."""
    sv = sc.s["mainlight"]["shadowview"]
    a = j_shadow.render_shadow_cascades(_np(sc.wp), _np(sc.ex["tris"]), _np(sv), res=128,
                                        bin_capacity=96, big_capacity=16)
    b = shadow.render_shadow_cascades(sc.wp, sc.ex["tris"], sv, res=128, bin_capacity=96,
                                      big_capacity=16, use_kernel=False)
    assert (b > 0).float().mean() > 0.05
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _maps(seed, n, res):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, res, res) * 0.6 + 0.2).astype(np.float32)


def test_pcf_factor_matches_jax(sc):
    ml = sc.ss["mainlight"]
    maps = _maps(7, 4, 128)
    nrm = (_np(_gbuffer(sc)["normal"])[..., :3] * 2 - 1).astype(np.float32)
    vp, wpos = (_np(x) for x in lighting_pass.reconstruct_positions(
        sc.depth, sc.s["proj"], sc.s["invview"], W, H))
    a = j_shadow.shadow_factor(wpos, maps, ml["splits"], ml["shadowview"], -vp[..., 2],
                               normal=nrm)
    b = shadow.shadow_factor(*(torch.from_numpy(x) for x in (
        wpos, maps, ml["splits"], ml["shadowview"], -vp[..., 2])),
        normal=torch.from_numpy(nrm))
    assert 0.0 < float(b.mean()) < 1.0
    _close(a, b)
    dd = np.linspace(0, 60, 97, dtype=np.float32)
    _close(j_shadow.shadow_split_weights(ml["splits"], 4, dd),
           shadow.shadow_split_weights(torch.from_numpy(ml["splits"]), 4,
                                       torch.from_numpy(dd)))


def test_spot_factors_match_jax(sc):
    sv = sc.ss["spotlights"]["shadowview"][0]
    m = _maps(8, 1, 128)[0]
    a = j_shadow.spot_shadow_factor(_np(sc.wpos), m, sv)
    b = shadow.spot_shadow_factor(sc.wpos, torch.from_numpy(m), torch.from_numpy(sv))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    kw = dict(proj=sc.ss["proj"], invview=sc.ss["invview"])
    a = j_shadow.spot_factor_quarter(_np(sc.depth), m, sv, **kw)
    b = shadow.spot_factor_quarter(sc.depth, torch.from_numpy(m), torch.from_numpy(sv),
                                   **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(a, b)


def test_perspective_spot_maps_match_jax(sc):
    """render_spot_maps without Pallas: the spot shadowviews' cascade
    stack through the scan raster, bit-equal."""
    sv = sc.s["spotlights"]["shadowview"]
    a = j_shadow.render_spot_maps(_np(sc.wp), _np(sc.ex["tris"]), _np(sv), 1, res=128,
                                  bin_capacity=96, big_capacity=16)
    b = shadow.render_spot_maps(sc.wp, sc.ex["tris"], sv, 1, res=128, bin_capacity=96,
                                big_capacity=16, use_kernel=False)
    assert (b > 0).float().mean() > 0.05
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------- lighting

def test_clustered_point_lights_match_jax(sc):
    gb = _gbuffer(sc)
    nrm = gb["normal"][..., :3] * 2.0 - 1.0
    eye = brdf.normalize(sc.s["invview"][:3, 3] - sc.wpos)
    rough = gb["specular"][..., 3]
    mat = dict(specular=gb["specular"][..., :3], alpha=rough ** 2)
    pl = sc.s["pointlights"]
    lists, _ = cluster.bin_lights(pl["position"], pl["attenuation"][:, 3], pl["count"],
                                  sc.s["view"], sc.s["proj"], 2, 4, W, H, 4)
    assert int((lists >= 0).sum()) > 4
    b = cluster.clustered_point_lights(sc.wpos, nrm, eye, mat, pl, lists, 2, 4)
    a = j_cluster.clustered_point_lights(*_jx((sc.wpos, nrm, eye, mat, pl, lists)), 2, 4)
    for x, y in zip(a, b):
        _close(x, y)


def _shade_close(a, b):
    """K2's CPU scheme (see the module docstring)."""
    a, b = _np(a), _np(b)
    ok = np.abs(a - b) <= TOL["atol"] + TOL["rtol"] * np.abs(a)
    assert ok.mean() >= 0.9998, ok.mean()
    np.testing.assert_allclose(a[~ok], b[~ok], rtol=5e-3, atol=TOL["atol"])


@pytest.mark.parametrize("variant", ["sh_quad_esm_dense", "flat_pcf_clusters",
                                     "mips_spots_ssao", "no_env"])
def test_shade_deferred_matches_jax(sc, variant):
    gb = _gbuffer(sc)
    ibl = dict(sc.st["ibl"])
    kw = dict(shadow_factor_scale=2, shadow_slice_blend=0.25)
    ml = sc.s["mainlight"]
    if variant == "sh_quad_esm_dense":
        kw["shadowmaps"] = shadow.build_esm(torch.from_numpy(_maps(14, 4, 128)),
                                            ml["shadowview"])
    elif variant == "flat_pcf_clusters":
        del ibl["flatq"]
        kw["shadowmaps"] = torch.from_numpy(_maps(9, 4, 128))
        pl = sc.s["pointlights"]
        lists, cc = cluster.bin_lights(pl["position"], pl["attenuation"][:, 3],
                                       pl["count"], sc.s["view"], sc.s["proj"], 2, 4,
                                       W, H, 4)
        kw["cluster"] = (lists, cc, 2, 4)
    elif variant == "mips_spots_ssao":
        ibl = {k: v for k, v in ibl.items() if k not in ("flat", "flatq")}
        kw["spotmaps"] = torch.from_numpy(_maps(10, 1, 128))
        kw["ssao"] = torch.from_numpy(
            np.random.RandomState(11).rand(H, W).astype(np.float32))
    else:
        ibl = None
    b = lighting_pass.shade_deferred(gb, sc.depth, sc.s, proj=sc.s["proj"],
                                     invview=sc.s["invview"], ibl=ibl,
                                     light_counts=host_light_counts(sc.ss), **kw)
    jkw = _jx(kw)
    jibl = None
    if ibl is not None:
        jibl = _jx({k: v for k, v in sc.state["ibl"].items() if k in ibl})
        jibl["mips"] = list(jibl["mips"])
    jss = _jx(sc.ss)
    a = j_lp.shade_deferred(_jx(gb), _jx(sc.depth), jss, proj=jss["proj"],
                            invview=jss["invview"], ibl=jibl, **jkw)
    assert float(b.mean()) > 0.01 and torch.isfinite(b).all()
    _shade_close(a, b)
