"""The dense stress frame and the megakernel golden through the port
(CPU).

- A small stress frame (profiling/bench_stress.py::run_dense's config at
  256x128: a 24^2-cell geomorphed terrain, 3x2 spheres, 16 point lights
  clustered at 8 a tile, early-z on, 4 ESM cascades at 128 in one stack,
  bins that do not overflow) through the port's plain path and the JAX
  package's frame (Pallas in interpret mode): u8 mean |d| <= 0.5 levels,
  RMSE < 2/255, vis equal on >= 99.9% of pixels, luminance within rel
  1e-4, bin_overflow equal.  The terrain draw's morph ends beyond its
  farthest vertex here: past the morph end every vertex snaps to its
  4x4-cell block's coarse corner, the triangles inside a block collapse
  to a point, and those cover pixels by rounding noise, which the jitted
  JAX frame and the eager port round apart (ROADMAP Queue 3).
- The early-z bounds of the port (ops/raster_cuda.early_z_bounds) lie
  above every fragment of a stress cascade stack with collapsed cells;
  the TPU kernels' bound (the triangle's largest vertex depth) does not.
- tools/megakernel_golden.py's config rendered by the port's golden
  script (datum_tpu_torch/tools/megakernel_golden.py): RMSE < 2/255
  against tests/golden/megakernel.png.
"""

from pathlib import Path

import datum_tpu.ops.raster_pallas as jrp
import jax
import numpy as np
import pytest
import torch

from datum_tpu.render import frame as jax_frame
from datum_tpu.render.types import make_sceneset as jax_make_sceneset
from datum_tpu.scenes import stress_scene as jax_stress_scene

import test_torch_frame as frame_t
from test_torch_cluster import fragment_depth_max
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops import _kernels
from datum_tpu_torch.ops import shadow as shadow_ops
from datum_tpu_torch.ops.raster_cuda import _entry_ids, early_z_bounds, raster_shade_cuda
from datum_tpu_torch.ops.raster_depth_cuda import raster_depth_cuda
from datum_tpu_torch.ops.shade_cuda import shade_deferred_cuda
from datum_tpu_torch.render import frame as frame_mod
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import stress_scene

GOLDEN = Path(__file__).resolve().parent / "golden" / "megakernel.png"
STRESS = dict(width=256, height=128, terrain_n=24, sphere_detail=8, grid=(3, 2),
              n_point_lights=16, skybox_size=16, max_vertices=2048, max_triangles=2048,
              tile_light_capacity=8, raster_early_z=True, shadow_res=128,
              shadow_bin_capacity=1024, bin_capacity=512, big_capacity=16,
              bin_max_span=8, use_pallas=True, enable_material_maps=True,
              texture_filter="mip_half", shadow_factor_scale=4)
MORPH = np.float32([18.0, 80.0])      # (begin, end): no cell collapses


@pytest.fixture(scope="module")
def frames():
    """(JAX frame, port frame) of the small stress frame at t = 0.3."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jrp, "DEPTH_TILES_PER_STEP", 1)     # layout only; compiles faster
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jctx, jcam, jparams, jmk = jax_stress_scene(pallas_interpret=True, **STRESS)
        jrl = jmk(0.3)
        jrl.draws[0]["morph"] = MORPH
        jss = jax_make_sceneset(jcam, jparams, point_lights=jrl.point_lights,
                                spot_lights=jrl.spot_lights)
        jd = jrl.draw_arrays(jctx.config.max_instances, jctx.default_material)
        jctx.expand_host(jd)
        ref = jax.tree.map(np.asarray, jax_frame.render_frame(
            jctx.config, jctx.device_state(), jd, jss))
        ctx, cam, params, mk = stress_scene(device="cpu", **STRESS)
        rl = mk(0.3)
        rl.draws[0]["morph"] = MORPH
        ss = make_sceneset(cam, params, point_lights=rl.point_lights,
                           spot_lights=rl.spot_lights)
        out = frame_mod.render_frame(ctx.config, ctx.host_state(),
                                     ctx.frame_draws(rl, cam), ss, device="cpu")
    finally:
        torch.set_num_threads(threads)
        mp.undo()
    return ref, out


def test_stress_frame_matches_jax_frame(frames):
    ref, out = frames
    a = ref["image"].astype(np.float32)
    b = out["image"].numpy().astype(np.float32)
    assert b.shape == (128, 256, 3) and b.mean() > 10
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) < 2.0
    assert (ref["vis"] == out["vis"].numpy()).mean() >= 0.999
    lum_a, lum_b = float(ref["luminance"]), float(out["luminance"])
    assert abs(lum_b - lum_a) <= 1e-4 * abs(lum_a)
    assert int(ref["bin_overflow"]) == int(out["bin_overflow"]) == 0


def test_stress_frame_takes_the_plain_path_on_the_cpu(frames):
    """The CPU frame launched no kernel and built no library."""
    _, out = frames
    assert torch.isfinite(out["luminance"])
    assert [k.launches for k in (raster_shade_cuda, shade_deferred_cuda,
                                 raster_depth_cuda)] == [0, 0, 0]
    assert _kernels._LIBRARY is None


def test_early_z_bounds_hold_on_collapsed_cells():
    """A stress cascade stack at 256 with the scene's own morph range:
    far triangles collapse to a point, and their depth planes are
    rounding noise.  Every fragment stays
    under the port's bound; the TPU kernels' bound (the suffix max of each
    triangle's largest vertex depth, setup["zbound"]) is exceeded."""
    ctx, cam, params, mk = stress_scene(
        width=512, height=256, terrain_n=128, sphere_detail=16, n_point_lights=16,
        skybox=False, bin_capacity=1024, big_capacity=128, bin_max_span=8,
        use_pallas=True, texture_filter="mip_half", shadow_res=256,
        shadow_bin_capacity=256, device="cpu")
    rl = mk(0.3)
    s = to_torch(make_sceneset(cam, params, point_lights=rl.point_lights,
                               spot_lights=rl.spot_lights), "cpu")
    d = to_torch(ctx.frame_draws(rl, cam), "cpu")
    ex, _, _, _, _, wp = frame_mod._vertex_stage(ctx.config, ctx.device_state("cpu"),
                                                 d, s)
    (st,) = shadow_ops.cascade_stacks(wp, ex["tris"], s["mainlight"]["shadowview"],
                                      res=256)
    bins, _, big = shadow_ops.bin_stack(st, 256, 128)
    rows, tx = st["setup"]["row16"], st["tiles_x"]
    frag = fragment_depth_max(rows, bins, big, tx, st["res"], st["height"])
    port = early_z_bounds(rows, bins, big, tx, st["res"], st["height"])
    assert (frag > 0).sum() > 1000 and (frag <= port).all()
    ids = _entry_ids(bins, big)
    zb = torch.where(ids >= 0, st["setup"]["zbound"][ids.clamp(min=0).long()],
                     torch.zeros(()))
    tpu = torch.flip(torch.cummax(torch.flip(zb, [1]), 1).values, [1])
    assert (frag > tpu).sum() > 0


def test_megakernel_golden_through_the_port():
    """datum_tpu/tools/megakernel_golden.py's frame (clusters, the spot
    map, SSAO, fog, SSR, particles, the lit glass and water at half
    resolution, decals), rendered by the port's golden script (which
    raises on a bin overflow)."""
    from PIL import Image

    from datum_tpu_torch.tools.megakernel_golden import render_megakernel_frame

    img = render_megakernel_frame("cpu").astype(np.float32) / 255.0
    gold = np.asarray(Image.open(GOLDEN).convert("RGB")).astype(np.float32) / 255.0
    assert img.shape == gold.shape
    assert float(np.sqrt(np.mean((img - gold) ** 2))) < 2.0 / 255.0


def test_stress_port_runs_without_jax():
    """The stress scene (terrain geomorph, clusters, early-z) with jax and
    the JAX package made unimportable."""
    frame_t._run_without_jax(
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from datum_tpu_torch.scenes import stress_scene\n"
        "ctx, cam, params, make_rl = stress_scene(width=128, height=64, terrain_n=16,"
        " sphere_detail=8, grid=(2, 2), n_point_lights=16, skybox=False,"
        " max_vertices=1024, max_triangles=1024, bin_capacity=256, big_capacity=16,"
        " use_pallas=True, texture_filter='mip_half', shadow_res=128,"
        " raster_early_z=True, tile_light_capacity=8, device='cpu')\n"
        "img = ctx.render(cam, make_rl(0.0), params)\n"
        "assert img.shape == (64, 128, 3) and float(img.mean()) > 10\n")
