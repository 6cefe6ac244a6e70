"""K5 (the v1 raster), K7 (the matmul raster) and the scan raster of the
port against the JAX package (CPU).

Inputs are made from a seed with numpy and go through both packages;
the JAX kernels run as its own tests run them, in Pallas interpret mode.
Tolerances:
- K5's plain version against `raster_pallas`: vis exact, depth, l0 and
  l1 bit-equal (both evaluate each plane as fma(a, xn, b*yn) + c, XLA's
  contraction of the kernel's expression on the CPU);
- K7's plain version against `raster_shade_mxu`: every plane bit-equal
  (its 24-term product runs as fused multiply-adds in term order from 0,
  fma(b, yn, a*xn) + c, and each attribute as fma(c, l2, fma(a, l0,
  b*l1)); see ops/raster_mxu_cuda.py);
- the scan raster and resolve_barycentrics against the JAX ones: vis
  exact, depth bit-equal (atol 1e-6 against the jitted `rasterize`),
  barycentrics to atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu.math.matrix import perspective_proj
from datum_tpu.ops import raster as jr
from datum_tpu.ops.raster_pallas import raster_pallas, raster_shade_mxu

from datum_tpu_torch.ops import raster as tr
from datum_tpu_torch.ops.raster_mxu_cuda import (raster_mxu_cuda, raster_mxu_inputs,
                                                 raster_shade_mxu as t_mxu)
from datum_tpu_torch.ops.raster_v1_cuda import (raster_v1, raster_v1_cuda,
                                                raster_v1_inputs)

W, H, TX, TY = 256, 128, 2, 4


def _mesh(seed, n_v=80, n_t=140, n_behind=3, w=W, h=H, spread=2.0):
    """A perspective mesh of overlapping triangles, with triangles that
    cross the eye plane (w <= 0 corners: the big list)."""
    rng = np.random.RandomState(seed)
    proj = perspective_proj(np.radians(70), w / h, 0.1)
    pts = rng.randn(n_v, 3).astype(np.float32) * spread
    pts[:, 2] -= 6
    pts[:n_behind, 2] = 3.0           # behind the eye
    hp = np.concatenate([pts, np.ones((n_v, 1), np.float32)], 1)
    clip = (hp @ proj.T).astype(np.float32)
    tris = rng.randint(0, n_v, (n_t, 3)).astype(np.int32)
    tris[:n_behind, 0] = np.arange(n_behind)
    return clip, tris, rng


def _both_setups(clip, tris, w, h, tx, ty, **kw):
    js = jr.triangle_setup(jnp.asarray(clip), jnp.asarray(tris), w, h, tx, ty, **kw)
    tkw = dict(kw)
    if "ylim" in tkw:
        tkw["ylim"] = tuple(torch.from_numpy(np.asarray(v)) for v in tkw["ylim"])
    ts = tr.triangle_setup(torch.from_numpy(clip), torch.from_numpy(tris), w, h,
                           tx, ty, **tkw)
    return js, ts


def test_setup_carries_the_aos_fields():
    clip, tris, _ = _mesh(1)
    js, ts = _both_setups(clip, tris, W, H, TX, TY)
    for k in ("adj", "det", "zc"):
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(), err_msg=k)


@pytest.mark.parametrize("scissor", [False, True], ids=["open", "ylim"])
def test_k5_plain_matches_pallas(scissor):
    """Big-list entries (eye-plane crossings and a max_span of 4), the
    near plane, and with `scissor` a per-triangle y scissor band."""
    clip, tris, _ = _mesh(4)
    kw = dict(cull=0, max_span=4)
    if scissor:
        lo = np.where(np.arange(tris.shape[0]) % 2 == 0, -1.0, -0.3).astype(np.float32)
        kw["ylim"] = (lo, lo + np.float32(0.9))
    js, ts = _both_setups(clip, tris, W, H, TX, TY, **kw)
    jb = jr.bin_triangles(js, tris.shape[0], TX, TY, 64, 8, max_span=4)
    tb = tr.bin_triangles(ts, tris.shape[0], TX, TY, 64, 8, max_span=4)
    assert int((tb[2] >= 0).sum()) >= 3, "no big-list entries"
    ref = [np.asarray(a) for a in raster_pallas(js, jb[0], jb[2], jb[1], TX, TY,
                                                W, H, interpret=True)]
    out = [a.numpy() for a in raster_v1(ts, tb[0], tb[2], tb[1], TX, TY, W, H)]
    assert out[1].dtype == np.int32
    cover = (out[1] >= 0).mean()
    assert 0.2 < cover < (0.8 if scissor else 1.0), cover
    for name, a, b in zip(("depth", "vis", "l0", "l1"), ref, out):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_scan_raster_matches_jax():
    """The scan raster walks the bins first, then the big list, takes
    either winding (two-sided setup) and reads no valid flag."""
    clip, tris, _ = _mesh(6)
    js, ts = _both_setups(clip, tris, W, H, TX, TY, cull=0, max_span=4)
    jb = jr.bin_triangles(js, tris.shape[0], TX, TY, 64, 8, max_span=4)
    tb = tr.bin_triangles(ts, tris.shape[0], TX, TY, 64, 8, max_span=4)
    jd, jv = (np.asarray(a) for a in jr.raster(js, jb[0], jb[2], TX, TY, W, H))
    td, tv = tr.raster(ts, tb[0], tb[2], TX, TY, W, H)
    assert (tv >= 0).float().mean() > 0.2
    np.testing.assert_array_equal(jv, tv.numpy())
    np.testing.assert_array_equal(jd, td.numpy())
    jl, jm = jr.resolve_barycentrics(jnp.asarray(jv), js, W, H)
    tl, tm = tr.resolve_barycentrics(tv, ts, W, H)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=1e-6, rtol=0)


def test_rasterize_matches_jax():
    """The jitted JAX `rasterize` fuses the depth-plane products into
    their sum (fused multiply-adds), which the eager `raster` does not:
    its depth is held to atol 1e-6, vis exactly."""
    clip, tris, _ = _mesh(7)
    jd, jv, _ = jr.rasterize(jnp.asarray(clip), jnp.asarray(tris), width=W, height=H,
                             tiles_x=TX, tiles_y=TY, bin_capacity=64, big_capacity=8)
    td, tv, _ = tr.rasterize(torch.from_numpy(clip), torch.from_numpy(tris), width=W,
                             height=H, tiles_x=TX, tiles_y=TY, bin_capacity=64,
                             big_capacity=8)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=1e-6, rtol=0)


def _mxu_inputs():
    """256x32 (two tiles): 300 small triangles (more than 128 entries a
    tile, so the TPU kernel walks at least two chunks), every fifth one
    duplicated under a later id (exact depth ties), and eye-plane
    crossings in the big list."""
    w, h = 256, 32
    clip, tris, rng = _mesh(9, n_v=400, n_t=300, w=w, h=h, spread=1.2)
    tris[250:300] = tris[0:250:5]               # identical copies: ties
    n_v, n_t = clip.shape[0], tris.shape[0]
    uv = rng.rand(n_v, 2).astype(np.float32)
    nrm = rng.randn(n_v, 3).astype(np.float32)
    nm = 6
    mats = dict(color=rng.rand(nm, 4).astype(np.float32),
                emissive=rng.rand(nm).astype(np.float32),
                metalness=rng.rand(nm).astype(np.float32),
                roughness=rng.rand(nm).astype(np.float32),
                reflectivity=rng.rand(nm).astype(np.float32),
                albedomap=rng.randint(0, 5, nm).astype(np.int32))
    tri_mat = rng.randint(0, nm, n_t).astype(np.int32)
    return w, h, clip, tris, uv, nrm, mats, tri_mat


def test_k7_plain_matches_pallas():
    w, h, clip, tris, uv, nrm, mats, tri_mat = _mxu_inputs()
    tx, ty = 2, 1
    js, ts = _both_setups(clip, tris, w, h, tx, ty, cull=0, max_span=2)
    jb = jr.bin_triangles(js, tris.shape[0], tx, ty, 256, 8, max_span=2)
    tb = tr.bin_triangles(ts, tris.shape[0], tx, ty, 256, 8, max_span=2)
    assert int(tb[1].min()) + 8 > 128, tb[1]    # two chunks or more a tile
    assert int((tb[2] >= 0).sum()) >= 1
    ref = raster_shade_mxu(js, jb[0], jb[2], jb[1], jnp.asarray(tris), jnp.asarray(uv),
                           jnp.asarray(nrm), jnp.asarray(tri_mat),
                           {k: jnp.asarray(v) for k, v in mats.items()}, tx, ty, w, h,
                           interpret=True)
    out = t_mxu(ts, tb[0], tb[2], tb[1], torch.from_numpy(tris), torch.from_numpy(uv),
                torch.from_numpy(nrm), torch.from_numpy(tri_mat),
                {k: torch.from_numpy(v) for k, v in mats.items()}, tx, ty, w, h)
    vis = out["vis"].numpy()
    assert 0.3 < (vis >= 0).mean() < 1.0
    assert ((vis >= 250) & (vis < 300)).sum() == 0, "a tie went to the later copy"
    assert sorted(ref) == sorted(out)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]), out[k].numpy(), err_msg=k)


def test_k7_ties_keep_the_first_entry():
    """Two identical triangles tie on every pixel: the first id wins."""
    clip = np.array([[-0.6, -0.6, 0.5, 1], [0.6, -0.6, 0.5, 1],
                     [0.0, 0.6, 0.5, 1]] * 2, np.float32)
    tris = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    ts = tr.triangle_setup(torch.from_numpy(clip), torch.from_numpy(tris), W, H, TX, TY)
    bins, counts, big = tr.bin_triangles(ts, 2, TX, TY, 8, 2)
    mats = dict(color=torch.ones(1, 4), emissive=torch.zeros(1),
                metalness=torch.zeros(1), roughness=torch.ones(1),
                reflectivity=torch.ones(1), albedomap=torch.zeros(1, dtype=torch.int32))
    out = t_mxu(ts, bins, big, counts, torch.from_numpy(tris), torch.zeros(6, 2),
                torch.zeros(6, 3), torch.zeros(2, dtype=torch.int32), mats, TX, TY, W, H)
    assert (out["vis"] == 0).sum() > 1000 and (out["vis"] == 1).sum() == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    clip, tris, _ = _mesh(5)
    _, ts = _both_setups(clip, tris, W, H, TX, TY)
    bins, counts, big = tr.bin_triangles(ts, tris.shape[0], TX, TY, 32, 8)
    n = clip.shape[0]
    before = raster_v1_cuda.launches, raster_mxu_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        raster_v1_cuda(**raster_v1_inputs(ts, bins, big, counts, TX, W, H))
    mats = dict(color=torch.ones(1, 4), emissive=torch.zeros(1),
                metalness=torch.zeros(1), roughness=torch.ones(1),
                reflectivity=torch.ones(1), albedomap=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        raster_mxu_cuda(**raster_mxu_inputs(
            ts, bins, big, counts, torch.from_numpy(tris), torch.zeros(n, 2),
            torch.zeros(n, 3), torch.zeros(tris.shape[0], dtype=torch.int32), mats,
            TX, W, H))
    assert (raster_v1_cuda.launches, raster_mxu_cuda.launches) == before
