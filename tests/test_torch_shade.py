"""K2 (plain version) and the plane/post ops against the JAX package.

K2 runs on the tests/test_shade_pallas.py scene template (3 point
lights, 2 spots, probes off and on) plus one spot factor plane, ao and
the sky planes; the JAX side runs shade_deferred_pallas in interpret
mode.  Tolerance atol 2e-5 / rtol 1e-4, the precedent of
test_shade_pallas.py (both sides shade the same bf16-rounded planes), on
all but 0.02% of the values.  Those few sit on specular peaks: XLA's CPU
rsqrt differs from 1/sqrt by an ulp on about a third of its inputs, and
the GGX term at N.H ~ 1 with alpha 0.0625 amplifies an ulp of N.H about
a thousandfold, so they are held to rtol 5e-3 instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datum_tpu.ops import blur as jblur
from datum_tpu.ops import bloom as jbloom
from datum_tpu.ops import composite as jcomp
from datum_tpu.ops import geometry as jgeom
from datum_tpu.ops.common import srgb_encode as jsrgb
from datum_tpu.ops.shade import sample_matmaps as jsample
from datum_tpu.ops.shade_pallas import shade_deferred_pallas

from datum_tpu_torch.ops import blur, bloom, composite, geometry
from datum_tpu_torch.ops.common import srgb_encode
from datum_tpu_torch.ops.shade import sample_matmaps
from datum_tpu_torch.ops.shade_cuda import (shade_deferred, shade_deferred_cuda,
                                            shade_inputs)
from datum_tpu_torch.render.context import RenderContext

H, W = 64, 256


def _scene(n_point=3, n_spot=2, probes=False):
    """numpy sceneset of the test_shade_pallas.py template."""
    rng = np.random.RandomState(7)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 1.2
    proj[1, 1] = -2.1
    proj[2, 3] = 0.1
    proj[3, 2] = -1.0
    invview = np.eye(4, dtype=np.float32)
    invview[:3, 3] = [0.0, 2.0, 5.0]
    npl, nsl = 8, 4
    pl_pos = np.zeros((npl, 3), np.float32)
    pl_int = np.zeros((npl, 3), np.float32)
    pl_att = np.zeros((npl, 4), np.float32)
    pl_pos[:n_point] = rng.uniform(-3, 3, (n_point, 3)) + [0, 2, 0]
    pl_int[:n_point] = rng.uniform(1, 4, (n_point, 3))
    pl_att[:n_point] = [0.2, 0.1, 1.0, 8.0]
    sl_pos = np.zeros((nsl, 3), np.float32)
    sl_int = np.zeros((nsl, 3), np.float32)
    sl_att = np.zeros((nsl, 4), np.float32)
    sl_dir = np.tile(np.float32([0, -1, 0]), (nsl, 1))
    sl_cut = np.full(nsl, 0.5, np.float32)
    sl_pos[:n_spot] = rng.uniform(-2, 2, (n_spot, 3)) + [0, 3, 0]
    sl_int[:n_spot] = rng.uniform(1, 3, (n_spot, 3))
    sl_att[:n_spot] = [0.1, 0.1, 1.0, 10.0]
    pr_pos = np.zeros((4, 4), np.float32)
    pr_sh = np.zeros((4, 9, 3), np.float32)
    pr_count = 0
    if probes:
        pr_count = 2
        pr_pos[:2] = [[0, 1, -3, 4.0], [2, 1, -4, 3.0]]
        pr_sh[:2] = rng.uniform(0, 0.4, (2, 9, 3))
    sh9 = np.zeros((9, 3), np.float32)
    sh9[0] = [0.8, 0.9, 1.0]
    sh9[2] = [0.2, 0.2, 0.3]
    d = np.float32([0.3, -0.8, -0.5])
    return dict(
        proj=proj, invview=invview,
        camera=dict(exposure=np.float32(1.1), ambientintensity=np.float32(0.6),
                    specularintensity=np.float32(0.9)),
        mainlight=dict(direction=d / np.linalg.norm(d),
                       intensity=np.float32([4.0, 3.8, 3.5]),
                       cutoff=np.float32(0.9)),
        pointlights=dict(position=pl_pos, intensity=pl_int,
                         attenuation=pl_att, count=np.int32(n_point)),
        spotlights=dict(position=sl_pos, intensity=sl_int, attenuation=sl_att,
                        direction=sl_dir, cutoff=sl_cut,
                        count=np.int32(n_spot)),
        probes=dict(position=pr_pos, sh=pr_sh, count=np.int32(pr_count)),
        _sh=sh9,
    )


def _gplanes(sky=True):
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = 0.02 + 0.01 * np.sin(xx * 0.05) * np.cos(yy * 0.07)
    maskf = (((xx // 32) + (yy // 16)) % 3 != 0).astype(np.float32)
    nz = np.ones((H, W), np.float32)
    nx = 0.3 * np.sin(xx * 0.1)
    ny = 0.3 * np.cos(yy * 0.1)
    nn = np.sqrt(nx * nx + ny * ny + nz * nz)
    g = dict(
        depth=depth * maskf, visf=np.where(maskf > 0, 1.0, -1.0),
        nx=nx / nn, ny=ny / nn, nz=nz / nn,
        dr=0.4 + 0.2 * np.sin(xx * 0.02), dg=np.full((H, W), 0.5),
        db=0.4 + 0.2 * np.cos(yy * 0.03), em=np.full((H, W), 0.05),
        sr=0.1 + 0.5 * np.sin(xx * 0.013) ** 2,
        sg=np.full((H, W), 0.2), sb=np.full((H, W), 0.3),
        rgh=0.25 + 0.5 * (yy / H),
        esr=rng.uniform(0.1, 0.6, (H, W)), esg=rng.uniform(0.1, 0.6, (H, W)),
        esb=rng.uniform(0.1, 0.6, (H, W)),
        eb0=np.full((H, W), 0.7), eb1=np.full((H, W), 0.1),
        eb2=np.full((H, W), 0.9), sf=rng.uniform(0.3, 1.0, (H, W)),
    )
    if sky:
        g.update(sky_r=rng.uniform(0, 2, (H, W)), sky_g=rng.uniform(0, 2, (H, W)),
                 sky_b=rng.uniform(0, 2, (H, W)))
    return {k: np.asarray(v, np.float32) for k, v in g.items()}


def _jax_tree(t):
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    return jnp.asarray(t)


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    return torch.from_numpy(np.array(t))


@pytest.mark.parametrize("probes", [False, True])
def test_k2_plain_matches_pallas(probes):
    ss, g = _scene(probes=probes), _gplanes()
    rng = np.random.RandomState(11)
    ao = rng.uniform(0.4, 1.0, (H, W)).astype(np.float32)
    spotsf = rng.uniform(0.0, 1.0, (1, H, W)).astype(np.float32)
    a = shade_deferred_pallas(_jax_tree(g), _jax_tree(ss),
                              proj=jnp.asarray(ss["proj"]),
                              invview=jnp.asarray(ss["invview"]),
                              ao=jnp.asarray(ao), spotsf=jnp.asarray(spotsf),
                              interpret=True)
    tss = _torch_tree(ss)
    b = shade_deferred(_torch_tree(g), tss, proj=tss["proj"],
                       invview=tss["invview"], ao=torch.from_numpy(ao),
                       spotsf=torch.from_numpy(spotsf))
    a, b = np.asarray(a), b.numpy()
    assert b.shape == (H, W, 3) and np.isfinite(b).all()
    assert np.abs(b).max() > 0.1
    close = np.isclose(b, a, atol=2e-5, rtol=1e-4)
    assert close.mean() >= 0.9998, (~close).sum()
    np.testing.assert_allclose(b, a, atol=2e-5, rtol=5e-3)


def test_k2_sky_fills_uncovered_pixels():
    ss, g = _scene(), _gplanes()
    tss = _torch_tree(ss)
    b = shade_deferred(_torch_tree(g), tss, proj=tss["proj"],
                       invview=tss["invview"]).numpy()
    bg = g["visf"] < 0
    sky = np.stack([g["sky_r"], g["sky_g"], g["sky_b"]], -1)
    bf = torch.from_numpy(sky).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(b[bg], bf[bg] * np.float32(1.1), rtol=1e-6)


@pytest.mark.parametrize("extra", [
    dict(fog_r=1, fog_g=1, fog_b=1, fog_t=1), dict(fog_t=1),
], ids=lambda d: "-".join(sorted(d)))
def test_k2_fog_group(extra):
    """The fog group is ported: given whole, K2 plus its epilogue runs,
    and no in-scatter with transmittance 1 leaves the shade unchanged
    (exactly); a part of the group is refused."""
    ss, g = _torch_tree(_scene()), _torch_tree(_gplanes(sky=False))
    base = shade_deferred(g, ss, proj=ss["proj"], invview=ss["invview"])
    g.update({k: torch.zeros(H, W) for k in extra})
    if len(extra) < 4:
        with pytest.raises(ValueError, match="group"):
            shade_deferred(g, ss, proj=ss["proj"], invview=ss["invview"])
        return
    g["fog_t"] = torch.ones(H, W)
    out = shade_deferred(g, ss, proj=ss["proj"], invview=ss["invview"])
    assert torch.equal(out, base)


@pytest.mark.parametrize("extra", [
    dict(edr=1, edg=1, edb=1, edm=1), dict(edm=1),
], ids=lambda d: "-".join(sorted(d)))
def test_k2_later_groups_raise(extra):
    """The box env-probe override is ported: given whole with edm 0 (no
    pixel in a box) it leaves the shade unchanged (exactly), with edm 1
    its diffuse (2, 0, 0) replaces the SH-9 term; a part of the group is
    refused."""
    ss, g = _torch_tree(_scene()), _torch_tree(_gplanes(sky=False))
    base = shade_deferred(g, ss, proj=ss["proj"], invview=ss["invview"])
    g.update({k: torch.zeros(H, W) for k in extra})
    if len(extra) < 4:
        with pytest.raises(ValueError, match="group"):
            shade_deferred(g, ss, proj=ss["proj"], invview=ss["invview"])
        return
    assert torch.equal(shade_deferred(g, ss, proj=ss["proj"], invview=ss["invview"]),
                       base)
    g["edr"] = torch.full((H, W), 2.0)
    g["edm"] = torch.ones(H, W)
    out = shade_deferred(g, ss, proj=ss["proj"], invview=ss["invview"])
    covered = torch.from_numpy(_gplanes()["visf"] >= 0)
    assert (out[..., 0] > base[..., 0])[covered].all()
    assert (out[..., 1:] < base[..., 1:])[covered].all()     # edg = edb = 0


@pytest.mark.parametrize("count", [0, 3], ids=["clusters-empty", "clusters"])
def test_k2_clusters_run(count):
    """Clustered lights are ported: every cell's list holding the first
    `count` lights shades as the dense loop over `count` lights (no light
    culled: the same sums in the same order)."""
    ss, g = _torch_tree(_scene()), _torch_tree(_gplanes(sky=False))
    lists = torch.full((H // 16, W // 128, 8), -1, dtype=torch.int32)
    lists[..., :count] = torch.arange(count, dtype=torch.int32)
    counts = torch.full((H // 16, W // 128), count, dtype=torch.int32)
    out = shade_deferred(g, ss, proj=ss["proj"], invview=ss["invview"],
                         clusters=(lists, counts))
    ss["pointlights"]["count"] = torch.tensor(count, dtype=torch.int32)
    dense = shade_deferred(g, ss, proj=ss["proj"], invview=ss["invview"])
    assert torch.equal(out, dense)


@pytest.mark.parametrize("extra", [
    dict(tr_r=1, tr_g=1, tr_b=1, tr_a=1),
    dict(tr_r=1, tr_g=1, tr_b=1, tr_a=1, tr_ox=1, tr_oy=1),
    dict(oit_r=1, oit_g=1, oit_b=1, oit_w=1, oit_rev=1), dict(planes_out=1),
], ids=["tr", "tr-refr", "oit", "planes_out"])
def test_k2_translucent_groups_run(extra):
    """The lit-layer, refraction and WBOIT groups and planes_out are
    ported: K2 plus its epilogue give (H, W, 3), or three (H, W)
    planes; a zero tr_a and an empty WBOIT (rev 1, no weight) leave the
    shade unchanged (exactly)."""
    ss, g = _torch_tree(_scene()), _torch_tree(_gplanes(sky=False))
    base = shade_deferred(g, ss, proj=ss["proj"], invview=ss["invview"])
    planes_out = "planes_out" in extra
    if not planes_out:
        g.update({k: torch.zeros(H, W) for k in extra})
        if "oit_rev" in g:
            g["oit_rev"] = torch.ones(H, W)
    out = shade_deferred(g, ss, proj=ss["proj"], invview=ss["invview"],
                         planes_out=planes_out)
    if planes_out:
        assert len(out) == 3 and all(p.shape == (H, W) for p in out)
        out = torch.stack(out, -1)
    assert out.shape == (H, W, 3)
    assert torch.equal(out, base)


def test_k2_rounds_planes_to_bf16_except_depth_and_visf():
    ss, g = _torch_tree(_scene()), _torch_tree(_gplanes())
    inp = shade_inputs(g, ss, proj=ss["proj"], invview=ss["invview"],
                       ao=torch.ones(H, W), spotsf=torch.ones(1, H, W))
    assert inp["f32_planes"].dtype == torch.float32
    for k in ("planes", "ao", "spotsf"):
        assert inp[k].dtype == torch.bfloat16, k
    assert inp["planes"].shape[0] == 18 + 3
    assert inp["counts"].tolist() == [3, 2, 0, 0]


def test_k2_cuda_wrapper_refuses_cpu_tensors():
    ss, g = _torch_tree(_scene()), _torch_tree(_gplanes())
    inp = shade_inputs(g, ss, proj=ss["proj"], invview=ss["invview"])
    before = shade_deferred_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        shade_deferred_cuda(**inp)
    assert shade_deferred_cuda.launches == before


def test_sample_matmaps_matches():
    rng = np.random.RandomState(5)
    ctx = RenderContext()
    tex = ctx.add_texture(rng.randint(0, 255, (64, 64, 4)).astype(np.uint8))
    big = ctx.add_texture(rng.randint(0, 255, (256, 128, 4)).astype(np.uint8))
    ctx.add_material(albedomap=tex)
    ctx.add_material(albedomap=big, normalmap=tex)
    mm = ctx.host_state()["matmaps"]
    hh, ww = 48, 80
    mat = rng.randint(0, 3, (hh, ww))
    base, size = mm["base"][mat], mm["size"][mat]
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
    uv = np.stack([xx * 0.037 * (1 + yy / hh) - 0.3, yy * 0.051 + 0.2],
                  -1).astype(np.float32)
    a = jsample(jnp.asarray(mm["table"]), jnp.asarray(base), jnp.asarray(size),
                jnp.asarray(uv), pool=2, channel_first=True)
    b = sample_matmaps(torch.from_numpy(mm["table"]), torch.from_numpy(base),
                       torch.from_numpy(size), torch.from_numpy(uv), pool=2)
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6, rtol=0)


def _img(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("reduce", ["mean", "first"])
def test_downsample_pool_matches(reduce):
    x = _img((34, 50, 3))
    a = jblur.downsample_pool(jnp.asarray(x), 2, reduce=reduce)
    b = blur.downsample_pool(torch.from_numpy(x), 2, reduce=reduce)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_gaussian_blur_matches():
    x = _img((40, 72, 3), scale=20.0)
    a = jblur.gaussian_blur(jnp.asarray(x), 4.0)
    b = blur.gaussian_blur(torch.from_numpy(x), 4.0)
    # cumsum box blurs drift by ulps with the summation order
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape", [(17, 32), (17, 32, 3)])
def test_resize_up_dense_matches(shape):
    x = _img(shape, seed=1)
    a = jblur.resize_up_dense(jnp.asarray(x), 68, 128)
    b = blur.resize_up_dense(torch.from_numpy(x), 68, 128)
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6, rtol=1e-6)


def test_resize_up_dense_batch_matches():
    x = _img((5, 16, 24), seed=2)
    a = jblur.resize_up_dense_batch(jnp.asarray(x), 32, 48)
    b = blur.resize_up_dense_batch(torch.from_numpy(x), 32, 48)
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6, rtol=1e-6)


def test_bloom_quarter_matches():
    x = _img((64, 128, 3), seed=3, scale=30.0)
    a = jbloom.bloom(jnp.asarray(x), 0.8, upsample=False)
    b = bloom.bloom(torch.from_numpy(x), 0.8, upsample=False)
    assert float(np.asarray(a).max()) > 0.01
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5, rtol=1e-4)


def test_composite_graded_matches():
    lut = np.random.RandomState(4).rand(8, 8, 8, 3).astype(np.float32) * 0.1
    g = np.linspace(0, 1, 8, dtype=np.float32)
    lut += np.stack(np.meshgrid(g, g, g, indexing="ij")[::-1], -1) * 0.9
    coeffs, _ = jcomp.fit_lut_poly(lut)
    coeffs_t, _ = composite.fit_lut_poly(lut)
    np.testing.assert_array_equal(coeffs, coeffs_t)
    hdr = _img((32, 48, 3), seed=5, scale=3.0)
    glow = _img((32, 48, 3), seed=6, scale=0.2)
    a = jcomp.composite(jnp.asarray(hdr), 1.0, lut_poly=jnp.asarray(coeffs),
                        glow=jnp.asarray(glow))
    b = composite.composite(torch.from_numpy(hdr), 1.0,
                            lut_poly=torch.from_numpy(coeffs),
                            glow=torch.from_numpy(glow))
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=2e-6, rtol=1e-5)
    ua = np.asarray(jcomp.to_u8_image(a))
    ub = composite.to_u8_image(b).numpy()
    assert ua.dtype == ub.dtype == np.uint8
    assert np.abs(ua.astype(int) - ub).max() <= 1


def test_tonemap_and_srgb_match():
    x = _img((1000,), seed=7, scale=20.0)
    np.testing.assert_allclose(np.asarray(jcomp.tonemap(jnp.asarray(x))),
                               composite.tonemap(torch.from_numpy(x)).numpy(),
                               atol=1e-6, rtol=1e-6)
    y = _img((1000,), seed=8)
    np.testing.assert_allclose(np.asarray(jsrgb(jnp.asarray(y))),
                               srgb_encode(torch.from_numpy(y)).numpy(),
                               atol=1e-6, rtol=1e-6)


def test_transform_vertices_rigid_matches():
    rng = np.random.RandomState(9)
    V, D = 50, 4
    pos = rng.randn(V, 3).astype(np.float32)
    nrm = rng.randn(V, 3).astype(np.float32)
    tan = rng.randn(V, 4).astype(np.float32)
    vd = rng.randint(0, D, V).astype(np.int32)
    world = rng.randn(D, 3, 4).astype(np.float32)
    vp = rng.randn(4, 4).astype(np.float32)
    a = jgeom.transform_vertices_rigid(*map(jnp.asarray, (pos, nrm, tan, vd,
                                                          world, vp)))
    b = geometry.transform_vertices_rigid(*map(torch.from_numpy, (pos, nrm, tan,
                                                                  vd, world, vp)))
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), atol=1e-5, rtol=1e-6)
