"""The K7 frame, entry()'s config at 200x100 and test_golden.py's
statistics through the port (CPU), with tests/test_torch_deferred_frame.py's
check against the JAX package's frame (u8 mean |d| <= 0.5 levels, RMSE <
2/255, vis equal on >= 99.9%, luminance within rel 1e-4, bin_overflow 0):

- the K7 frame: raster_kernel='mxu' with material maps off and the
  nearest filter (K7, `raster_shade_mxu` in interpret mode, then
  `gbuffer_from_planes`), at 256x64 with main bins of 256 (at 128 the
  jitted JAX frame overflows one entry, the eager port none);
- entry()'s config at 200x100, a size that is no tile multiple: the
  frame pads to 256x128 and crops the image and the luminance.
"""

import numpy as np

from test_torch_deferred_frame import ENTRY, check_against_jax
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu_torch.ops.raster_mxu_cuda import raster_mxu_cuda
from datum_tpu_torch.render.frame import render_frame
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import datumtest_scene

K7_FRAME = dict(ENTRY, height=64, bin_capacity=256, use_pallas=True,
                raster_kernel="mxu", enable_material_maps=False,
                texture_filter="nearest", enable_shadows=False)


def test_k7_frame_matches_jax_frame():
    check_against_jax(K7_FRAME)
    assert raster_mxu_cuda.launches == 0


def test_entry_frame_at_200x100_matches_jax_frame():
    check_against_jax(dict(ENTRY, width=200, height=100))


def test_golden_statistics_through_the_port():
    """tests/test_golden.py's config and statistics, rendered by the port
    (its own datumtest_scene and host side) on the CPU."""
    ctx, camera, params, make_rl = datumtest_scene(
        width=256, height=128, sphere_detail=10, grid=(4, 3), n_point_lights=4,
        max_vertices=1 << 13, max_triangles=1 << 13, max_instances=16,
        bin_capacity=256, big_capacity=16, shadow_res=256, shadow_bin_capacity=128,
        device="cpu")
    rl = make_rl(0.0)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights)
    draws = ctx.frame_draws(rl, camera)
    state = ctx.host_state()
    out = render_frame(ctx.config, state, draws, ss, device="cpu")
    img = out["image"].numpy().astype(np.float32)
    coverage = (img.max(-1) > 0).mean()
    assert 0.95 < coverage <= 1.0, f"coverage {coverage:.3f}"
    assert 25 < img.mean() < 160, f"mean brightness {img.mean():.1f}"
    centre = img[img.shape[0] // 4: img.shape[0] // 2,
                 img.shape[1] // 4: 3 * img.shape[1] // 4]
    assert centre[..., 0].mean() > centre[..., 2].mean()
    assert 0.005 < float(out["luminance"]) < 2.0
    out2 = render_frame(ctx.config, state, draws, ss, device="cpu")
    np.testing.assert_array_equal(out2["image"].numpy(), img.astype(np.uint8))
