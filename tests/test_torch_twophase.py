"""K6, the two-phase fused raster (plain version), against the JAX
package's `_raster_shade_kernel_2p` and against the port's K1.

Inputs come from tests/test_torch_raster.py's seeded mesh (overlapping
triangles, some crossing the eye plane into the big list) and go through
`raster_shade_pallas(two_phase=True, early_z=False)` in Pallas interpret
mode and through the port's `raster_shade(two_phase=True)`.  Every plane
is held bit-identical on every pixel, in four forms: base (no tangent:
the JAX kernel's 15 planes), extended, with a peel plane, and with the
material alpha in the albedo slot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_raster as rt
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)
from datum_tpu.ops import raster as jr
from datum_tpu.ops.raster_pallas import raster_shade_pallas

from datum_tpu_torch.ops import raster as tr
from datum_tpu_torch.ops.raster_cuda import (PLANE_NAMES, raster_inputs, raster_shade,
                                             raster_shade_2p_cuda,
                                             raster_shade_2p_reference,
                                             raster_shade_reference)

TX, TY, W, H = rt.TX, rt.TY, rt.W, rt.H
BASE_PLANES = PLANE_NAMES[:15]


def _case(seed):
    clip, tris, uv, nrm, tan, tri_mat, state = rt._k1_inputs(seed)
    js, ts = rt._setups(clip, tris, cull=0, max_span=4)
    jb = jr.bin_triangles(js, tris.shape[0], TX, TY, 64, 8, max_span=4)
    tb = tr.bin_triangles(ts, tris.shape[0], TX, TY, 64, 8, max_span=4)
    return clip, tris, uv, nrm, tan, tri_mat, state, js, ts, jb, tb


def _jax_planes(case, *, extended=True, two_phase=True, **kw):
    clip, tris, uv, nrm, tan, tri_mat, state, js, _, jb, _ = case
    mats = {k: jnp.asarray(v) for k, v in state["materials"].items()}
    ext = {}
    if extended:
        ext = dict(tangent=jnp.asarray(tan),
                   matmaps={k: jnp.asarray(v) for k, v in state["matmaps"].items()})
    out = raster_shade_pallas(js, jb[0], jb[2], jb[1], jnp.asarray(tris),
                              jnp.asarray(uv), jnp.asarray(nrm), jnp.asarray(tri_mat),
                              mats, TX, TY, W, H, interpret=True, planes_2d=True,
                              two_phase=two_phase, early_z=False, **ext, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_planes(case, *, extended=True, two_phase=True, **kw):
    clip, tris, uv, nrm, tan, tri_mat, state, _, ts, _, tb = case
    mats = {k: torch.from_numpy(v) for k, v in state["materials"].items()}
    tangent = torch.from_numpy(tan) if extended else torch.zeros(tan.shape)
    out = raster_shade(ts, tb[0], tb[2], tb[1], torch.from_numpy(tris),
                       torch.from_numpy(uv), torch.from_numpy(nrm),
                       torch.from_numpy(tri_mat), mats, TX, TY, W, H,
                       tangent=tangent, two_phase=two_phase, **kw)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def case():
    return _case(4)


@pytest.mark.parametrize("form", ["base", "extended", "peel_depth", "alpha_in_alb"])
def test_k6_plain_matches_pallas(case, form):
    """raster_shade_2p_reference vs the JAX two-phase kernel (interpret,
    early_z=False): every plane bit-identical on every pixel."""
    kw = {}
    if form == "peel_depth":
        # peel behind the first layer's depth: the second layer
        first = _port_planes(case, two_phase=False)["depth"]
        kw = dict(peel_depth=first)
    elif form == "alpha_in_alb":
        kw = dict(alpha_in_alb=True)
    extended = form != "base"
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jp = _jax_planes(case, extended=extended, **jkw)
    tp = _port_planes(case, extended=extended, **tkw)
    names = PLANE_NAMES if extended else BASE_PLANES
    assert sorted(jp) == sorted(names)
    covered = (tp["visf"] >= 0).mean()
    assert covered > (0.05 if form == "peel_depth" else 0.3), covered
    assert len(np.unique(tp["visf"])) > (5 if form == "peel_depth" else 20)
    for n in names:
        np.testing.assert_array_equal(jp[n], tp[n], err_msg=n)
    if form == "alpha_in_alb":
        assert not np.array_equal(tp["alb"], _port_planes(case)["alb"])


@pytest.mark.parametrize("seed", [4, 7])
@pytest.mark.parametrize("peel", [False, True])
def test_k6_plain_matches_k1_plain(seed, peel):
    """K6 and K1 (plain versions) on the same inputs: the 22 planes
    bit-identical, with and without a peel plane."""
    c = _case(seed)
    clip, tris, uv, nrm, tan, tri_mat, state, _, ts, _, tb = c
    inp = raster_inputs(ts, tb[0], tb[2], tb[1], torch.from_numpy(tris),
                        torch.from_numpy(uv), torch.from_numpy(nrm),
                        torch.from_numpy(tri_mat),
                        {k: torch.from_numpy(v) for k, v in state["materials"].items()},
                        TX, W, H, torch.from_numpy(tan))
    if peel:
        inp["peel"] = raster_shade_reference(**inp)[0].contiguous()
    a = raster_shade_reference(**inp)
    b = raster_shade_2p_reference(**inp)
    assert (b[1] >= 0).float().mean() > 0.05
    assert torch.equal(a, b)


def test_k6_ties_keep_the_first_entry():
    """Two identical triangles tie on every pixel: the first entry wins
    in both phases (the depth test is strict, the slots are in walk
    order)."""
    clip = np.array([[-0.6, -0.6, 0.5, 1], [0.6, -0.6, 0.5, 1],
                     [0.0, 0.6, 0.5, 1]] * 2, np.float32)
    tris = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    ts = tr.triangle_setup(torch.from_numpy(clip), torch.from_numpy(tris), W, H, TX, TY)
    bins, counts, big = tr.bin_triangles(ts, 2, TX, TY, 8, 2)
    inp = raster_inputs(ts, bins, big, counts, torch.from_numpy(tris),
                        torch.zeros(6, 2), torch.zeros(6, 3),
                        torch.zeros(2, dtype=torch.int32),
                        dict(packed10=torch.zeros(1, 12)), TX, W, H, torch.zeros(6, 4))
    visf = raster_shade_2p_reference(**inp)[1]
    assert (visf == 0).sum() > 1000 and (visf == 1).sum() == 0


def test_k6_cuda_wrapper_refuses_cpu_tensors(case):
    clip, tris, uv, nrm, tan, tri_mat, state, _, ts, _, tb = case
    inp = raster_inputs(ts, tb[0], tb[2], tb[1], torch.from_numpy(tris),
                        torch.from_numpy(uv), torch.from_numpy(nrm),
                        torch.from_numpy(tri_mat),
                        {k: torch.from_numpy(v) for k, v in state["materials"].items()},
                        TX, W, H, torch.from_numpy(tan))
    before = raster_shade_2p_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        raster_shade_2p_cuda(**inp)
    assert raster_shade_2p_cuda.launches == before


def test_k6_cuda_wrapper_refuses_deep_bins():
    """A bin depth whose flags would not fit a block's shared memory is
    refused before anything launches."""
    bins = torch.zeros((8, 30000), dtype=torch.int32)
    before = raster_shade_2p_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        raster_shade_2p_cuda(torch.zeros((1, 64)), bins, torch.zeros(8, dtype=torch.int32),
                             torch.zeros(8, dtype=torch.int32), TX, W, H)
    assert raster_shade_2p_cuda.launches == before
