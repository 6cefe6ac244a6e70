"""The K5 frame through the port against the JAX package's frame (CPU),
with tests/test_torch_deferred_frame.py's check (u8 mean |d| <= 0.5
levels, RMSE < 2/255, vis equal on >= 99.9%, luminance within rel 1e-4,
bin_overflow 0): use_pallas with the bilinear filter and material maps
(K5, `raster_pallas`, then `resolve_gbuffer(lam=)`), with a translucent
draw and particles (two K4 passes), decals, SSAO, fog at a density, one
perspective spot map (K3) and the binned SSR, at 256x128.  The JAX
kernels run in Pallas interpret mode; on the CPU the port's wrappers run
their plain versions (no launch).
"""

import numpy as np

from test_torch_deferred_frame import ENTRY, check_against_jax
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu_torch.ops.raster_v1_cuda import raster_v1_cuda

K5_FRAME = dict(ENTRY, use_pallas=True, texture_filter="bilinear",
                enable_material_maps=True, max_translucent_draws=2,
                max_translucent_tris=2048, max_particle_quads=512, max_decals_active=2,
                enable_ssao=True, enable_fog=True, enable_ssr=True, max_spot_shadows=1,
                spot_shadow_mode="perspective", spot_shadow_res=128,
                forward_bin_capacity=256, forward_big_capacity=16, enable_shadows=False)
FOG_DENSITY = np.float32([0.6, 0.65, 0.7, 0.04])


def test_k5_frame_matches_jax_frame():
    check_against_jax(K5_FRAME, fog_density=FOG_DENSITY)
    assert raster_v1_cuda.launches == 0
