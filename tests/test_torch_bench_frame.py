"""The bench frame (bench.py's config) in the port against the JAX
package's frame (CPU), at 256x128.

The check is tests/test_torch_frame.py's: one state goes through the JAX
package's `render_frame` (Pallas kernels in interpret mode) and the
port's (plain PyTorch versions of the kernels); u8 image mean |d| <= 0.5
levels and RMSE <= 2/255, luminance within rel 1e-4, bin_overflow
equal, vis equal on >= 99.9% of pixels.  The bench frame adds SSAO, the
froxel fog and the binned SSR to the translucent frame; it is held here
with the one-phase raster (K1), and in tests/test_torch_bench_temporal.py
with the two-phase raster (K6) and depth of field over two frames of
RenderContext.render with the temporal SSAO history.  The scene's fog
density is 0 (the bench renders no fog); these tests give it one
(FOG_DENSITY).
"""

import dataclasses

import datum_tpu.ops.raster_pallas as jrp
import numpy as np
import pytest
import torch

import test_torch_frame as frame_t
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu_torch.render.frame import render_frame
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import datumtest_scene

SLICE, SHADOWED, TRANSLUCENT = frame_t.SLICE, frame_t.SHADOWED, frame_t.TRANSLUCENT
# the translucent frame's content with the shadowed frame's cascades,
# spot map and skybox, plus SSAO, the fog (taps at 1/8 resolution) and
# the binned SSR
BENCH = dict(SHADOWED, **{k: v for k, v in TRANSLUCENT.items() if k not in SLICE},
             enable_ssao=True, enable_fog=True, enable_ssr=True, fog_sample_scale=8)
FOG_DENSITY = np.float32([0.6, 0.65, 0.7, 0.04])


@pytest.fixture(autouse=True)
def _one_depth_tile_a_step(monkeypatch):
    """The JAX depth raster walks one tile a grid step here (layout only,
    bit-identical; 16 a step compiles ~15x longer in interpret mode)."""
    monkeypatch.setattr(jrp, "DEPTH_TILES_PER_STEP", 1)


def test_bench_frame_matches_jax_frame():
    """Sun cascades, spot map, skybox, the lit glass and water layer,
    particles, decals, SSAO, fog and SSR (K1)."""
    frame_t._check_against_jax(BENCH, FOG_DENSITY)


def test_render_context_defaults_to_the_card():
    """RenderContext.render draws on the card unless told otherwise; with
    params.scale 0.5 it renders the frame at half the viewport and blits
    it back by nearest integer indices (the JAX package's render: every
    output pixel (y, x) is frame pixel (y // 2, x // 2))."""
    ctx, cam, params, make_rl = datumtest_scene(**SLICE)
    assert ctx.device == torch.device("cuda")
    ctx, cam, params, make_rl = datumtest_scene(device="cpu", **SLICE)
    params.scale = 0.5
    rl = make_rl(0.0)
    img = ctx.render(cam, rl, params)
    assert img.shape == (SLICE["height"], SLICE["width"], 3) and img.dtype == np.uint8
    half = dataclasses.replace(ctx.config, width=SLICE["width"] // 2,
                               height=SLICE["height"] // 2)
    ss = make_sceneset(cam, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights)
    small = render_frame(half, ctx.host_state(), ctx.frame_draws(rl, cam), ss,
                         device="cpu")["image"].numpy()
    assert small.mean() > 10
    np.testing.assert_array_equal(img, small.repeat(2, 0).repeat(2, 1))


def _frame(**kw):
    ctx, camera, params, make_rl = datumtest_scene(device="cpu", **kw)
    params.fogdensity = FOG_DENSITY
    if ctx.config.enable_depth_of_field:
        camera.set_depth_of_field(4.0, 14.0)
    rl = make_rl(0.3)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights)
    return render_frame(ctx.config, ctx.host_state(), ctx.frame_draws(rl, camera), ss,
                        device="cpu")


def test_post_passes_change_the_frame():
    """Each of the fog (with a density), SSR and DoF moves some pixels by
    2 levels or more, and SSAO (ambient only) some by 1 or more: none is
    dropped silently.  The opaque slice with the skybox, for speed."""
    post = dict(SLICE, skybox=True, skybox_size=32, enable_ssao=True, enable_fog=True,
                enable_ssr=True, fog_sample_scale=8)
    full = _frame(**post)["image"].float()
    for off, levels, n in ((dict(enable_ssao=False), 1, 50),
                           (dict(enable_fog=False), 2, 5),
                           (dict(enable_ssr=False), 2, 5),
                           (dict(enable_depth_of_field=True), 2, 5)):
        other = _frame(**dict(post, **off))["image"].float()
        assert ((full - other).abs() >= levels).sum() >= n, off


def test_bench_port_runs_without_jax():
    """The bench frame (cascades, spot map, skybox, the lit layer,
    particles, decals, SSAO, fog, SSR) with the two-phase raster and DoF,
    through RenderContext.render twice (temporal SSAO), with jax and the
    JAX package made unimportable."""
    frame_t._run_without_jax(
        "import numpy as np\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from datum_tpu_torch.scenes import datumtest_scene\n"
        "ctx, cam, params, make_rl = datumtest_scene(width=128, height=64,"
        " sphere_detail=8, grid=(3, 2), n_point_lights=4, skybox=True,"
        " skybox_size=16, max_vertices=1024, max_triangles=1024,"
        " bin_capacity=64, big_capacity=16, use_pallas=True,"
        " texture_filter='mip_half', shadow_res=256, shadow_far_res=128,"
        " shadow_slice_blend=0.25, max_spot_shadows=1, spot_shadow_res=128,"
        " max_translucent_draws=2, max_translucent_tris=1024,"
        " translucent_lit_scale=2, max_particle_quads=512,"
        " max_decals_active=2, decal_textures=False,"
        " enable_ssao=True, ssao_temporal=True, enable_fog=True,"
        " enable_ssr=True, fog_sample_scale=8, enable_depth_of_field=True,"
        " raster_two_phase=True, device='cpu')\n"
        "cam.set_depth_of_field(4.0, 14.0)\n"
        "params.fogdensity = np.float32([0.6, 0.65, 0.7, 0.04])\n"
        "for t in (0.0, 0.1):\n"
        "    img = ctx.render(cam, make_rl(t), params)\n"
        "assert img.shape == (64, 128, 3) and float(img.mean()) > 10\n"
        "assert ctx._ao_prev is not None\n")
