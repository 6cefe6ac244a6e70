"""Port setup/binning and K1 (plain version) against the JAX package.

Inputs are made from a seed with numpy and fed to both packages; the
JAX K1 runs as its own tests run it, in Pallas interpret mode.
Tolerances: setup to atol 1e-6; bins, counts, big ids, overflow and
depth bands exactly (the sort keys are unique, so any correct sort gives
the same bins); K1 planes as stated in test_k1_plain_matches_pallas."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu.math.matrix import perspective_proj
from datum_tpu.ops import raster as jr
from datum_tpu.ops.raster_pallas import raster_shade_pallas

from datum_tpu_torch.ops import raster as tr
from datum_tpu_torch.ops.raster_cuda import (PLANE_NAMES, _entry_ids,
                                             raster_inputs, raster_shade,
                                             raster_shade_cuda,
                                             raster_shade_reference)
from datum_tpu_torch.render.context import RenderContext

W, H, TX, TY = 256, 128, 2, 4


def _mesh(seed, n_v=60, n_t=90, n_behind=3):
    """A perspective mesh of overlapping triangles, plus triangles that
    cross the eye plane (w <= 0 corners: the big list)."""
    rng = np.random.RandomState(seed)
    proj = perspective_proj(np.radians(70), W / H, 0.1)
    pts = rng.randn(n_v, 3).astype(np.float32) * 2
    pts[:, 2] -= 6
    pts[:n_behind, 2] = 3.0           # behind the eye
    hp = np.concatenate([pts, np.ones((n_v, 1), np.float32)], 1)
    clip = (hp @ proj.T).astype(np.float32)
    tris = rng.randint(0, n_v, (n_t, 3)).astype(np.int32)
    tris[:n_behind, 0] = np.arange(n_behind)   # force some crossing tris
    return clip, tris, rng


def _setups(clip, tris, cull=0, max_span=16):
    js = jr.triangle_setup(jnp.asarray(clip), jnp.asarray(tris), W, H, TX, TY,
                           cull=cull, max_span=max_span)
    ts = tr.triangle_setup(torch.from_numpy(clip), torch.from_numpy(tris), W,
                           H, TX, TY, cull=cull, max_span=max_span)
    return js, ts


def test_adjugate3_matches():
    m = np.random.RandomState(0).randn(50, 3, 3).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jr.adjugate3(jnp.asarray(m))),
                               tr.adjugate3(torch.from_numpy(m)).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("cull", [0, -1, 1])
def test_triangle_setup_matches(cull):
    clip, tris, _ = _mesh(1)
    js, ts = _setups(clip, tris, cull=cull, max_span=4)
    assert bool(np.asarray(js["big"]).any()), "no big triangles in the mesh"
    for k in ("row16", "zbound"):
        np.testing.assert_allclose(np.asarray(js[k]), ts[k].numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)
    for k in ("valid", "big"):
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy())
    for a, b in zip(js["bbox_soa"], ts["bbox_soa"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("prio", [False, True])
@pytest.mark.parametrize("capacity", [8, 64])
def test_bin_triangles_exact(prio, capacity):
    clip, tris, _ = _mesh(2, n_t=120)
    js, ts = _setups(clip, tris, cull=0, max_span=4)
    kw = dict(max_span=4, return_overflow=True)
    jout = jr.bin_triangles(js, tris.shape[0], TX, TY, capacity, 4,
                            depth_prio=js["zbound"] if prio else None,
                            return_zub=prio, **kw)
    tout = tr.bin_triangles(ts, tris.shape[0], TX, TY, capacity, 4,
                            depth_prio=ts["zbound"] if prio else None,
                            return_zub=prio, **kw)
    names = ["bins", "counts", "big_ids", "bin_overflow"] + (["bin_zub"] if prio else [])
    for name, a, b in zip(names, jout, tout):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    if capacity == 8:
        assert int(tout[3]) > 0, "the small capacity should overflow"


def test_untile_and_tile_image_match():
    img = np.random.RandomState(3).randn(H, W, 2).astype(np.float32)
    a = np.asarray(jr.tile_image(jnp.asarray(img), TX, TY))
    b = tr.tile_image(torch.from_numpy(img), TX, TY).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        np.asarray(jr._untile(jnp.asarray(a[..., 0]), TX, TY)),
        tr._untile(torch.from_numpy(b[..., 0]), TX, TY).numpy())


def test_entry_ids_walk_order():
    bins = torch.tensor([[5, 6, -1], [7, -1, -1]], dtype=torch.int32)
    big = torch.tensor([1, 2, -1, -1], dtype=torch.int32)
    ids = _entry_ids(bins, big)
    assert ids.tolist() == [[1, 2, -1, -1, 5, 6, -1], [1, 2, -1, -1, 7, -1, -1]]


def _k1_inputs(seed):
    clip, tris, rng = _mesh(seed, n_v=80, n_t=140)
    n_v, n_t = clip.shape[0], tris.shape[0]
    ctx = RenderContext()
    tex = ctx.add_texture(rng.randint(0, 255, (16, 16, 4)).astype(np.uint8))
    for i in range(5):
        ctx.add_material(color=(0.2 * i, 0.5, 0.7, 1.0), metalness=0.1 * i,
                         roughness=0.3 + 0.1 * i, emissive=0.05 * i,
                         albedomap=tex if i % 2 else 0, absorb=0.1 * i)
    state = ctx.host_state()
    uv = rng.rand(n_v, 2).astype(np.float32)
    nrm = rng.randn(n_v, 3).astype(np.float32)
    tan = np.concatenate([rng.randn(n_v, 3), np.sign(rng.randn(n_v, 1))],
                         1).astype(np.float32)
    tri_mat = rng.randint(0, 6, n_t).astype(np.int32)
    return clip, tris, uv, nrm, tan, tri_mat, state


def test_k1_plain_matches_pallas():
    """raster_shade_reference vs raster_shade_pallas (interpret): every
    plane bit-identical on every pixel.  Both evaluate each plane
    a*xn + b*yn + c as fma(a, xn, b*yn) + c (XLA's contraction of the
    Pallas expression on the CPU), so visibility, depth and the
    interpolated planes round alike."""
    clip, tris, uv, nrm, tan, tri_mat, state = _k1_inputs(4)
    mats = state["materials"]
    js, ts = _setups(clip, tris, cull=0, max_span=4)
    jb = jr.bin_triangles(js, tris.shape[0], TX, TY, 64, 8, max_span=4)
    tb = tr.bin_triangles(ts, tris.shape[0], TX, TY, 64, 8, max_span=4)
    jmats = {k: jnp.asarray(v) for k, v in mats.items()}
    jmm = {k: jnp.asarray(v) for k, v in state["matmaps"].items()}
    jp = raster_shade_pallas(js, jb[0], jb[2], jb[1], jnp.asarray(tris),
                             jnp.asarray(uv), jnp.asarray(nrm),
                             jnp.asarray(tri_mat), jmats, TX, TY, W, H,
                             interpret=True, planes_2d=True,
                             tangent=jnp.asarray(tan), matmaps=jmm,
                             early_z=False)
    tmats = {k: torch.from_numpy(v) for k, v in mats.items()}
    tp = raster_shade(ts, tb[0], tb[2], tb[1], torch.from_numpy(tris),
                      torch.from_numpy(uv), torch.from_numpy(nrm),
                      torch.from_numpy(tri_mat), tmats, TX, TY, W, H,
                      tangent=torch.from_numpy(tan))
    jp = {k: np.asarray(v) for k, v in jp.items()}
    tp = {k: v.numpy() for k, v in tp.items()}
    assert sorted(jp) == sorted(tp) == sorted(PLANE_NAMES)
    covered = (tp["visf"] >= 0).mean()
    assert covered > 0.3, covered
    assert len(np.unique(tp["visf"])) > 20          # many overlapping winners
    for n in PLANE_NAMES:
        np.testing.assert_array_equal(jp[n], tp[n], err_msg=n)


@pytest.mark.parametrize("max_span", [16, 1])
def test_k1_ties_keep_the_first_entry(max_span):
    """Two identical triangles tie on every pixel: the walk is in entry
    order and the depth test strict, so the first id wins (binned with
    max_span 16, both big with max_span 1)."""
    clip = np.array([[-0.6, -0.6, 0.5, 1], [0.6, -0.6, 0.5, 1],
                     [0.0, 0.6, 0.5, 1]] * 2, np.float32)
    tris = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    ts = tr.triangle_setup(torch.from_numpy(clip), torch.from_numpy(tris), W,
                           H, TX, TY, max_span=max_span)
    assert ts["big"].tolist() == [max_span == 1] * 2
    bins, counts, big = tr.bin_triangles(ts, 2, TX, TY, 8, 2,
                                         max_span=max_span)
    rows = raster_inputs(ts, bins, big, counts, torch.from_numpy(tris),
                         torch.zeros(6, 2), torch.zeros(6, 3),
                         torch.zeros(2, dtype=torch.int32),
                         dict(packed10=torch.zeros(1, 12)), TX, W, H,
                         torch.zeros(6, 4))
    visf = raster_shade_reference(**rows)[1]
    assert (visf == 0).sum() > 1000 and (visf == 1).sum() == 0


def test_k1_cuda_wrapper_refuses_cpu_tensors():
    clip, tris, uv, nrm, tan, tri_mat, state = _k1_inputs(5)
    _, ts = _setups(clip, tris)
    bins, counts, big = tr.bin_triangles(ts, tris.shape[0], TX, TY, 32, 8)
    inp = raster_inputs(ts, bins, big, counts, torch.from_numpy(tris),
                        torch.from_numpy(uv), torch.from_numpy(nrm),
                        torch.from_numpy(tri_mat),
                        {k: torch.from_numpy(v) for k, v in
                         state["materials"].items()}, TX, W, H,
                        torch.from_numpy(tan))
    before = raster_shade_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        raster_shade_cuda(**inp)
    assert raster_shade_cuda.launches == before
