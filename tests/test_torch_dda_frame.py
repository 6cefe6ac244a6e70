"""The frame with the DDA SSR and the analytic fog planes in the port
against the JAX package's frame (CPU), at 256x128 with the sky, on the
megakernel and on the deferred branch, from one state (the JAX
package's, through convert.to_torch): u8 image mean |d| <= 0.5 levels,
RMSE <= 2/255, luminance within rel 1e-4.  The ops themselves are held
in tests/test_torch_post_extras.py.
"""

import dataclasses

import jax
import numpy as np
import pytest

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)
from test_torch_post_extras import FOG_PLANES, SMALL
from datum_tpu.render import frame as jax_frame
from datum_tpu.render.types import make_sceneset as jax_make_sceneset
from datum_tpu.scenes import datumtest_scene as jax_datumtest_scene

from datum_tpu_torch.render.frame import attach_host_expansion, render_frame


# the small frame with the sky, the DDA SSR and two fog planes
DDA = dict(SMALL, skybox=True, skybox_size=16, enable_ssr=True, ssr_mode="dda",
           max_fog_planes=2)


@pytest.mark.parametrize("use_shade_kernel", [True, False], ids=["megakernel", "deferred"])
def test_dda_fog_plane_frame_matches_jax_frame(use_shade_kernel):
    """The frame with the DDA SSR and the fog planes (after K2 on the
    megakernel branch; after the fog, before the blend passes on the
    deferred one) against the JAX frame from one state: u8 mean |d| <=
    0.5 levels, RMSE <= 2/255, luminance within rel 1e-4."""
    ctx, cam, params, make_rl = jax_datumtest_scene(
        pallas_interpret=True, use_shade_kernel=use_shade_kernel, **DDA)
    cfg = ctx.config
    rl = make_rl(0.3)
    for p in FOG_PLANES:
        rl.push_fogplane(**p)
    ss = jax_make_sceneset(cam, params, point_lights=rl.point_lights,
                           spot_lights=rl.spot_lights)
    draws = rl.draw_arrays(cfg.max_instances, ctx.default_material)
    ctx.expand_host(draws)
    draws["fogplanes"] = rl.fogplane_arrays(cfg.max_fog_planes)
    ref = jax.tree.map(np.asarray, jax_frame.render_frame(cfg, ctx.device_state(), draws, ss))
    pdraws = dict(draws)
    attach_host_expansion(ctx.pool, pdraws, cfg.max_vertices, cfg.max_triangles,
                          cfg.max_translucent_tris)
    out = render_frame(cfg, jax.tree.map(np.asarray, ctx.device_state()), pdraws, ss,
                       device="cpu")
    a = ref["image"].astype(np.float32)
    b = out["image"].numpy().astype(np.float32)
    assert b.mean() > 10
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) <= 2.0
    lum_a, lum_b = float(ref["luminance"]), float(out["luminance"])
    assert abs(lum_b - lum_a) <= 1e-4 * abs(lum_a), (lum_a, lum_b)
    plain = render_frame(dataclasses.replace(cfg, max_fog_planes=0, enable_ssr=False),
                         jax.tree.map(np.asarray, ctx.device_state()), pdraws, ss,
                         device="cpu")["image"].numpy().astype(np.float32)
    assert np.abs(b - plain).mean() > 1.0, "the fog planes and SSR moved nothing"
