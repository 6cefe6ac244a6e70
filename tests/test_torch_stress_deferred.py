"""A small stress frame on the deferred path through the port against
the JAX package's frame (CPU): tests/test_torch_stress_frame.py's scene
(a 24^2-cell geomorphed terrain, 3x2 spheres, 16 point lights clustered
at 8 a tile) with FrameConfig's defaults — use_pallas=False (the scan
raster, the XLA lighting, clustered lights without depth bounds), the
nearest filter, 4 ESM cascades (at 128) — and the terrain's morph end
moved past its farthest vertex (no cell collapses; ROADMAP Queue 3).
Bins do not overflow.  Tolerances: u8 mean |d| <= 0.5 levels, RMSE <
2/255, vis equal on >= 99.9%, luminance within rel 1e-4, bin_overflow
0.
"""

import jax
import numpy as np
import torch

from datum_tpu.render import frame as jax_frame
from datum_tpu.render.types import make_sceneset as jax_make_sceneset
from datum_tpu.scenes import stress_scene as jax_stress_scene

from test_torch_stress_frame import MORPH

from datum_tpu_torch.render import frame as frame_mod
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import stress_scene

SMALL = dict(width=256, height=128, terrain_n=24, sphere_detail=8, grid=(3, 2),
             n_point_lights=16, skybox_size=16, max_vertices=2048, max_triangles=2048,
             tile_light_capacity=8, shadow_res=128, shadow_bin_capacity=1024,
             bin_capacity=512, big_capacity=16, bin_max_span=8)


def test_small_stress_frame_matches_jax_frame():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jctx, jcam, jparams, jmk = jax_stress_scene(**SMALL)
        jrl = jmk(0.3)
        jrl.draws[0]["morph"] = MORPH
        jss = jax_make_sceneset(jcam, jparams, point_lights=jrl.point_lights)
        jd = jrl.draw_arrays(jctx.config.max_instances, jctx.default_material)
        jctx.expand_host(jd)
        ref = jax.tree.map(np.asarray, jax_frame.render_frame(
            jctx.config, jctx.device_state(), jd, jss))
        ctx, cam, params, mk = stress_scene(device="cpu", **SMALL)
        rl = mk(0.3)
        rl.draws[0]["morph"] = MORPH
        ss = make_sceneset(cam, params, point_lights=rl.point_lights)
        out = frame_mod.render_frame(ctx.config, ctx.host_state(),
                                     ctx.frame_draws(rl, cam), ss, device="cpu")
    finally:
        torch.set_num_threads(threads)
    a = ref["image"].astype(np.float32)
    b = out["image"].numpy().astype(np.float32)
    assert b.shape == (128, 256, 3) and b.mean() > 10
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) < 2.0
    assert (ref["vis"] == out["vis"].numpy()).mean() >= 0.999
    lum_a, lum_b = float(ref["luminance"]), float(out["luminance"])
    assert abs(lum_b - lum_a) <= 1e-4 * abs(lum_a)
    assert int(ref["bin_overflow"]) == int(out["bin_overflow"]) == 0
