"""The bench frame through RenderContext.render over two frames, with
the temporal SSAO history, the two-phase raster (K6) and depth of field,
against the JAX package's RenderContext.render (CPU, 256x128); and the
bench frame's CPU path launching no kernel.  Tolerances and scene as
tests/test_torch_bench_frame.py.
"""

import datum_tpu.ops.raster_pallas as jrp
import numpy as np
import pytest
import torch

from datum_tpu.scenes import datumtest_scene as jax_datumtest_scene

import test_torch_bench_frame as bench_t
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)
from datum_tpu_torch.ops import _kernels
from datum_tpu_torch.ops.raster_blend_cuda import raster_blend_cuda
from datum_tpu_torch.ops.raster_cuda import raster_shade_2p_cuda, raster_shade_cuda
from datum_tpu_torch.ops.raster_depth_cuda import raster_depth_cuda
from datum_tpu_torch.ops.shade_cuda import shade_deferred_cuda, shade_epilogue_cuda
from datum_tpu_torch.scenes import datumtest_scene

BENCH, FOG_DENSITY = bench_t.BENCH, bench_t.FOG_DENSITY


@pytest.fixture(autouse=True)
def _one_depth_tile_a_step(monkeypatch):
    """The JAX depth raster walks one tile a grid step (layout only)."""
    monkeypatch.setattr(jrp, "DEPTH_TILES_PER_STEP", 1)


def test_bench_temporal_two_phase_dof_render_matches_jax():
    """Two bench frames through RenderContext.render with ssao_temporal,
    the two-phase raster (K6 on the opaque and the lit layer, on both
    sides) and depth of field (focus 14, width 4): the second frame
    reprojects the first's AO after the camera moved.  Each frame's image
    is held to the frame tolerances, and the port's AO history to the JAX
    package's within 1e-3."""
    kw = dict(BENCH, ssao_temporal=True, raster_two_phase=True,
              enable_depth_of_field=True)
    jctx, jcam, jparams, jmake = jax_datumtest_scene(pallas_interpret=True, **kw)
    tctx, tcam, tparams, tmake = datumtest_scene(device="cpu", **kw)
    for params, cam in ((jparams, jcam), (tparams, tcam)):
        params.fogdensity = FOG_DENSITY
        cam.set_depth_of_field(4.0, 14.0)
    for t, step in ((0.3, 0.0), (0.4, 0.15)):
        for cam in (jcam, tcam):
            cam.position = cam.position + np.float32([step, 0.5 * step, 0.0])
        a = np.asarray(jctx.render(jcam, jmake(t), jparams)).astype(np.float32)
        b = tctx.render(tcam, tmake(t), tparams).astype(np.float32)
        assert b.shape == (128, 256, 3) and b.mean() > 10
        assert np.abs(a - b).mean() <= 0.5
        assert np.sqrt(((a - b) ** 2).mean()) <= 2.0
        assert tctx.bin_overflow == jctx.bin_overflow == 0
        ao_j = np.asarray(jctx._ao_prev["ao"])
        ao_t = tctx._ao_prev["ao"].numpy()
        assert ao_t.shape == ao_j.shape == (64, 128, 2)
        np.testing.assert_allclose(ao_t, ao_j, atol=1e-3, rtol=0)
    assert tctx._ao_prev["_cfg"] == (256, 128)


def test_cpu_bench_frame_takes_the_plain_path():
    """The bench frame (at the bench's shadow bins, which overflow here),
    with K1 and with K6, on CPU tensors: no kernel launches, nothing is
    built; it returns the AO history."""
    kernels = (raster_shade_cuda, raster_shade_2p_cuda, shade_deferred_cuda,
               raster_depth_cuda, raster_blend_cuda, shade_epilogue_cuda)
    before = [k.launches for k in kernels]
    for two_phase in (False, True):
        out = bench_t._frame(**dict(BENCH, shadow_bin_capacity=128,
                                    raster_two_phase=two_phase))
        assert out["image"].float().mean() > 10
        assert torch.isfinite(out["luminance"]) and int(out["bin_overflow"]) == 0
        assert out["ao_prev"]["ao"].shape == (64, 128, 2)
    assert [k.launches for k in kernels] == before
    assert _kernels._LIBRARY is None, "a CPU frame must not build the kernels"
