"""The deferred (non-megakernel) frame of the port against the JAX
package's frame (CPU): `__graft_entry__.py::entry()`'s config —
FrameConfig's defaults, use_pallas=False (the scan raster, the XLA
lighting and blend), the nearest filter, material maps, 4 sun cascades
with ESM — at 256x128, also with PCF shadows.  check_against_jax is
shared with tests/test_torch_k5_frame.py and test_torch_k7_frame.py
(which also holds this config at 200x100 and test_golden.py's
statistics).

One state (the JAX package's, through convert.to_torch) goes through
both frames.  The config is cut to size: 4x3 spheres at detail 8, the
cascades at 256 with shadow bins of 320 and main bins of 128 (none
overflows: where bins overflow, the jitted JAX frame and the eager port
keep different entries, ROADMAP Queue 3).  Tolerances: u8 image mean
|d| <= 0.5 levels and RMSE < 2/255, vis equal on >= 99.9% of pixels,
luminance within rel 1e-4, bin_overflow equal (0).
"""

import jax
import numpy as np
import pytest
import torch

import datum_tpu.ops.raster_pallas as jrp
from datum_tpu.render import frame as jax_frame
from datum_tpu.render.types import make_sceneset as jax_make_sceneset
from datum_tpu.scenes import datumtest_scene as jax_datumtest_scene

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu_torch.ops.raster_mxu_cuda import raster_mxu_cuda
from datum_tpu_torch.ops.raster_v1_cuda import raster_v1_cuda
from datum_tpu_torch.render.frame import attach_host_expansion, render_frame

# entry()'s scene and config, cut to size (see the module docstring)
ENTRY = dict(width=256, height=128, sphere_detail=8, grid=(4, 3), n_point_lights=4,
             max_vertices=4096, max_triangles=4096, bin_capacity=128, big_capacity=32,
             shadow_res=256, shadow_bin_capacity=320)


def check_against_jax(scene_kw, fog_density=None, t=0.3):
    """Render scene_kw through both packages from one state and hold the
    port's frame to the JAX frame (the module docstring's tolerances).
    Returns the port's output."""
    ctx, camera, params, make_rl = jax_datumtest_scene(pallas_interpret=True, **scene_kw)
    cfg = ctx.config
    if fog_density is not None:
        params.fogdensity = fog_density
    rl = make_rl(t)
    ss = jax_make_sceneset(camera, params, point_lights=rl.point_lights,
                           spot_lights=rl.spot_lights)
    draws = rl.draw_arrays(cfg.max_instances, ctx.default_material)
    ctx.expand_host(draws)
    if cfg.max_particle_quads > 0:
        draws["forward"] = rl.forward_arrays(cfg.max_particle_quads, camera)
    if cfg.max_translucent_draws > 0:
        draws["translucent"] = rl.translucent_arrays(cfg.max_translucent_draws,
                                                     ctx.default_material)
    if cfg.max_decals_active > 0:
        draws["decals"] = rl.decal_arrays(cfg.max_decals_active)
    mp = pytest.MonkeyPatch()
    mp.setattr(jrp, "DEPTH_TILES_PER_STEP", 1)     # layout only; compiles faster
    try:
        ref = jax.tree.map(np.asarray, jax_frame.render_frame(
            cfg, ctx.device_state(), draws, ss))
    finally:
        mp.undo()
    pdraws = dict(draws)
    if "translucent" in draws:
        pdraws["translucent"] = dict(draws["translucent"])
    attach_host_expansion(ctx.pool, pdraws, cfg.max_vertices, cfg.max_triangles,
                          cfg.max_translucent_tris)
    state = jax.tree.map(np.asarray, ctx.device_state())
    out = render_frame(cfg, state, pdraws, ss, device="cpu")
    a = ref["image"].astype(np.float32)
    b = out["image"].numpy().astype(np.float32)
    assert b.shape == (cfg.height, cfg.width, 3) and out["image"].dtype == torch.uint8
    assert b.mean() > 10, "black frame"
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) < 2.0
    lum_a, lum_b = float(ref["luminance"]), float(out["luminance"])
    assert abs(lum_b - lum_a) <= 1e-4 * abs(lum_a), (lum_a, lum_b)
    assert int(ref["bin_overflow"]) == int(out["bin_overflow"]) == 0
    assert (ref["vis"] == out["vis"].numpy()).mean() >= 0.999
    return out


@pytest.mark.parametrize("shadow_mode", ["esm", "pcf"])
def test_entry_frame_matches_jax_frame(shadow_mode):
    """use_pallas=False: K5 and K7 never launch."""
    before = raster_v1_cuda.launches, raster_mxu_cuda.launches
    check_against_jax(dict(ENTRY, shadow_mode=shadow_mode))
    assert (raster_v1_cuda.launches, raster_mxu_cuda.launches) == before
