"""The port's frame against the JAX package's frame (CPU).

One state — the JAX package's device state, draws and sceneset, mapped
to numpy — goes through both `datum_tpu.render.frame.render_frame`
(Pallas kernels in interpret mode) and the port's `render_frame`
(convert.to_torch, plain PyTorch versions of the kernels on the CPU),
for the opaque slice, the shadowed, sky-lit frame and the translucent
frame (1 and 2 lit layers); tests/test_torch_bench_frame.py holds the
bench frame with the same check.  Tolerances:
u8 image mean |d| <= 0.5 levels and RMSE <= 2/255, luminance within rel
1e-4, bin_overflow equal, vis equal on >= 99.9% of pixels.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import datum_tpu.ops.raster_pallas as jrp
import jax
import numpy as np
import pytest
import torch

from datum_tpu.render import frame as jax_frame
from datum_tpu.render.types import make_sceneset as jax_make_sceneset
from datum_tpu.scenes import datumtest_scene as jax_datumtest_scene

from datum_tpu_torch.ops import _kernels
from datum_tpu_torch.ops.raster_blend_cuda import raster_blend_cuda
from datum_tpu_torch.ops.raster_cuda import raster_shade_cuda
from datum_tpu_torch.ops.raster_depth_cuda import raster_depth_cuda
from datum_tpu_torch.ops.shade_cuda import shade_deferred_cuda, shade_epilogue_cuda
from datum_tpu_torch.render.frame import attach_host_expansion, render_frame
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import datumtest_scene

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "datum_tpu_torch"
SLICE = dict(width=256, height=128, sphere_detail=8, grid=(4, 3),
             n_point_lights=8, skybox=False, max_vertices=2048,
             max_triangles=2048, bin_capacity=128, big_capacity=16,
             bin_max_span=8, use_pallas=True, enable_material_maps=True,
             texture_filter="mip_half", enable_shadows=False)
# the shadowed, sky-lit frame: sun cascades (near at 256, far at 128,
# slice blend), one parabolic spot map and the procedural skybox.  The
# shadow bins must not overflow here: the kept triangles of a saturated
# bin follow the sort key, whose bbox and depth band move with the ulps
# that XLA's fused setup gives the jitted JAX frame.
SHADOWED = dict(SLICE, skybox=True, skybox_size=32, enable_shadows=True,
                shadow_mode="esm", shadow_res=256, shadow_far_res=128,
                shadow_slice_blend=0.25, shadow_bin_capacity=1024,
                max_spot_shadows=1, spot_shadow_mode="parabolic",
                spot_shadow_res=128)
# the translucent frame: the glass sphere and the water patch on a lit
# layer at half resolution, the 256-particle cloud and two decals.  The
# forward bins must not overflow here (as the shadow bins above).
TRANSLUCENT = dict(SLICE, max_translucent_draws=2, max_translucent_tris=2048,
                   translucent_lit=True, translucent_lit_layers=1,
                   translucent_lit_scale=2, max_particle_quads=512,
                   max_decals_active=2, decal_textures=False,
                   forward_bin_capacity=256, forward_big_capacity=16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while a test runs (the port's other test
    modules import this fixture): the port's plain versions issue thousands
    of small ops, and with several test workers each op's thread team
    waits on descheduled threads (the bench tests took ~10x longer with
    two workers than alone; ~2x with one thread).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_against_jax(scene_kw, fog_density=None):
    ctx, camera, params, make_rl = jax_datumtest_scene(pallas_interpret=True,
                                                       **scene_kw)
    cfg = ctx.config
    if fog_density is not None:
        params.fogdensity = fog_density
    if cfg.enable_depth_of_field:
        camera.set_depth_of_field(4.0, 14.0)       # focus on the sphere wall
    rl = make_rl(0.3)
    ss = jax_make_sceneset(camera, params, point_lights=rl.point_lights,
                           spot_lights=rl.spot_lights)
    # the draws tree as the JAX package's RenderContext.render builds it
    draws = rl.draw_arrays(cfg.max_instances, ctx.default_material)
    ctx.expand_host(draws)
    if cfg.max_particle_quads > 0:
        draws["forward"] = rl.forward_arrays(cfg.max_particle_quads, camera)
    if cfg.max_translucent_draws > 0:
        draws["translucent"] = rl.translucent_arrays(cfg.max_translucent_draws,
                                                     ctx.default_material)
    if cfg.max_decals_active > 0:
        draws["decals"] = rl.decal_arrays(cfg.max_decals_active)
    ref = jax.tree.map(np.asarray, jax_frame.render_frame(
        cfg, ctx.device_state(), draws, ss))

    # the port expands the translucent draws on the host as well
    pdraws = dict(draws)
    if "translucent" in draws:
        pdraws["translucent"] = dict(draws["translucent"])
    attach_host_expansion(ctx.pool, pdraws, cfg.max_vertices, cfg.max_triangles,
                          cfg.max_translucent_tris)
    state = jax.tree.map(np.asarray, ctx.device_state())
    out = render_frame(cfg, state, pdraws, ss, device="cpu")
    a = ref["image"].astype(np.float32)
    b = out["image"].numpy().astype(np.float32)
    assert b.shape == (128, 256, 3) and out["image"].dtype == torch.uint8
    assert b.mean() > 10, "black frame"
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) <= 2.0
    lum_a, lum_b = float(ref["luminance"]), float(out["luminance"])
    assert abs(lum_b - lum_a) <= 1e-4 * abs(lum_a), (lum_a, lum_b)
    assert int(ref["bin_overflow"]) == int(out["bin_overflow"])
    assert (ref["vis"] == out["vis"].numpy()).mean() >= 0.999


def test_slice_frame_matches_jax_frame():
    _check_against_jax(SLICE)


def test_shadowed_skylit_frame_matches_jax_frame(monkeypatch):
    """The JAX depth raster runs one tile per grid step here: the tiles a
    grid step walks (DEPTH_TILES_PER_STEP) are TPU layout and move no
    value, but interpret mode compiles ~15x longer at 16."""
    monkeypatch.setattr(jrp, "DEPTH_TILES_PER_STEP", 1)
    _check_against_jax(SHADOWED)


def test_translucent_frame_matches_jax_frame():
    """Glass sphere, water patch (absorption and refraction), particles
    and decals, lit layer at half resolution."""
    _check_against_jax(TRANSLUCENT)


def test_translucent_two_lit_layers_matches_jax_frame():
    """translucent_lit_layers=2: the glass sphere's back face is the
    second peeled layer (K1 peel_depth, the tr2 planes), and the WBOIT
    residual is peeled behind it."""
    _check_against_jax(dict(TRANSLUCENT, translucent_lit_layers=2))


def test_translucent_unlit_matches_jax_frame():
    """translucent_lit=False: no lit layer; every translucent triangle
    goes into the merged WBOIT stream beside the particles, unpeeled."""
    _check_against_jax(dict(TRANSLUCENT, translucent_lit=False))


def _port_frame(t=0.0, **over):
    ctx, camera, params, make_rl = datumtest_scene(device="cpu", **dict(SLICE, **over))
    rl = make_rl(t)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights)
    return render_frame(ctx.config, ctx.host_state(),
                        ctx.frame_draws(rl, camera), ss, device="cpu")


def test_cpu_frame_takes_the_plain_path():
    k1, k2 = raster_shade_cuda.launches, shade_deferred_cuda.launches
    out = _port_frame()
    assert out["image"].float().mean() > 10
    assert torch.isfinite(out["luminance"])
    assert (raster_shade_cuda.launches, shade_deferred_cuda.launches) == (k1, k2)
    assert _kernels._LIBRARY is None, "a CPU frame must not build the kernels"


def test_cpu_shadowed_frame_takes_the_plain_path():
    before = (raster_shade_cuda.launches, shade_deferred_cuda.launches,
              raster_depth_cuda.launches)
    out = _port_frame(**SHADOWED)
    assert out["image"].float().mean() > 10
    assert torch.isfinite(out["luminance"]) and int(out["bin_overflow"]) == 0
    assert (raster_shade_cuda.launches, shade_deferred_cuda.launches,
            raster_depth_cuda.launches) == before
    assert _kernels._LIBRARY is None, "a CPU frame must not build the kernels"


def test_cpu_translucent_frame_takes_the_plain_path():
    kernels = (raster_shade_cuda, shade_deferred_cuda, raster_depth_cuda,
               raster_blend_cuda, shade_epilogue_cuda)
    before = [k.launches for k in kernels]
    out = _port_frame(**TRANSLUCENT)
    assert out["image"].float().mean() > 10
    assert torch.isfinite(out["luminance"]) and int(out["bin_overflow"]) == 0
    assert [k.launches for k in kernels] == before
    assert _kernels._LIBRARY is None, "a CPU frame must not build the kernels"


def test_translucents_particles_and_decals_change_the_frame():
    """Each of the lit glass/water layer, the particle cloud and the
    decals moves some pixels by 2 levels or more: none is dropped
    silently."""
    full = _port_frame(**TRANSLUCENT)["image"].float()
    for off in (dict(max_translucent_draws=0), dict(max_particle_quads=0),
                dict(max_decals_active=0)):
        other = _port_frame(**dict(TRANSLUCENT, **off))["image"].float()
        assert ((full - other).abs() >= 2).sum() >= 5, off


def test_shadows_and_sky_change_the_frame():
    """Each of the sun cascades, the spot map and the skybox moves some
    pixels by 2 levels or more: none is dropped silently."""
    full = _port_frame(**SHADOWED)["image"].float()
    for off in (dict(enable_shadows=False), dict(max_spot_shadows=0),
                dict(skybox=False)):
        other = _port_frame(**dict(SHADOWED, **off))["image"].float()
        assert ((full - other).abs() >= 2).sum() >= 5, off


def test_frames_move_with_time():
    a, b = _port_frame(0.0)["image"], _port_frame(1.5)["image"]
    assert (a != b).any()


_NO_JAX = (
    "loaded = [m for m, v in sys.modules.items() if v is not None and"
    " (m.startswith('jax') or m == 'datum_tpu' or"
    " m.startswith('datum_tpu.'))]\n"
    "assert not loaded, loaded\n"
    "print('ok')\n")


def _run_without_jax(code):
    """Run code in a fresh interpreter with jax and the JAX package made
    unimportable, then check that neither was loaded."""
    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['datum_tpu'] = None\n" + code)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code + _NO_JAX], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


def test_port_runs_without_jax():
    """Import the port, build the scene and render with jax and the JAX
    package made unimportable, as on the machine with the card."""
    _run_without_jax(
        "from datum_tpu_torch.scenes import datumtest_scene\n"
        "from datum_tpu_torch.render.types import make_sceneset\n"
        "from datum_tpu_torch.render.frame import render_frame\n"
        "ctx, cam, params, make_rl = datumtest_scene(width=128, height=64,"
        " sphere_detail=8, grid=(3, 2), n_point_lights=4, skybox=False,"
        " max_vertices=1024, max_triangles=1024, bin_capacity=64,"
        " big_capacity=16, use_pallas=True, texture_filter='mip_half',"
        " enable_shadows=False)\n"
        "rl = make_rl(0.0)\n"
        "ss = make_sceneset(cam, params, point_lights=rl.point_lights,"
        " spot_lights=rl.spot_lights)\n"
        "draws = rl.draw_arrays(ctx.config.max_instances, ctx.default_material)\n"
        "ctx.expand_host(draws)\n"
        "out = render_frame(ctx.config, ctx.device_state('cpu'), draws, ss,"
        " device='cpu')\n"
        "assert out['image'].shape == (64, 128, 3)\n"
        "assert float(out['image'].float().mean()) > 10\n")


def test_shadowed_skylit_port_runs_without_jax():
    """The shadowed, sky-lit frame (skybox bake, cascades, spot map,
    environment) with jax and the JAX package made unimportable."""
    _run_without_jax(
        "from datum_tpu_torch.scenes import datumtest_scene\n"
        "from datum_tpu_torch.render.types import make_sceneset\n"
        "from datum_tpu_torch.render.frame import render_frame\n"
        "ctx, cam, params, make_rl = datumtest_scene(width=128, height=64,"
        " sphere_detail=8, grid=(3, 2), n_point_lights=4, skybox=True,"
        " skybox_size=16, max_vertices=1024, max_triangles=1024,"
        " bin_capacity=64, big_capacity=16, use_pallas=True,"
        " texture_filter='mip_half', shadow_res=256, shadow_far_res=128,"
        " shadow_slice_blend=0.25, max_spot_shadows=1, spot_shadow_res=128,"
        " device='cpu')\n"
        "rl = make_rl(0.0)\n"
        "ss = make_sceneset(cam, params, point_lights=rl.point_lights,"
        " spot_lights=rl.spot_lights)\n"
        "draws = rl.draw_arrays(ctx.config.max_instances, ctx.default_material)\n"
        "ctx.expand_host(draws)\n"
        "out = render_frame(ctx.config, ctx.device_state('cpu'), draws, ss,"
        " device='cpu')\n"
        "assert out['image'].shape == (64, 128, 3)\n"
        "assert float(out['image'].float().mean()) > 10\n")


def test_translucent_port_runs_without_jax():
    """The translucent frame (lit glass/water layers, particles, decals)
    with jax and the JAX package made unimportable: the port uses its own
    host math and its own env-BRDF LUT."""
    _run_without_jax(
        "from datum_tpu_torch.scenes import datumtest_scene\n"
        "from datum_tpu_torch.render.types import make_sceneset\n"
        "from datum_tpu_torch.render.frame import render_frame\n"
        "ctx, cam, params, make_rl = datumtest_scene(width=128, height=64,"
        " sphere_detail=8, grid=(3, 2), n_point_lights=4, skybox=True,"
        " skybox_size=16, max_vertices=1024, max_triangles=1024,"
        " bin_capacity=64, big_capacity=16, use_pallas=True,"
        " texture_filter='mip_half', enable_shadows=False,"
        " max_translucent_draws=2, max_translucent_tris=1024,"
        " translucent_lit_layers=2, translucent_lit_scale=2,"
        " max_particle_quads=512, max_decals_active=2, decal_textures=False,"
        " forward_bin_capacity=256, device='cpu')\n"
        "rl = make_rl(0.0)\n"
        "ss = make_sceneset(cam, params, point_lights=rl.point_lights,"
        " spot_lights=rl.spot_lights)\n"
        "out = render_frame(ctx.config, ctx.device_state('cpu'),"
        " ctx.frame_draws(rl, cam), ss, device='cpu')\n"
        "assert out['image'].shape == (64, 128, 3)\n"
        "assert float(out['image'].float().mean()) > 10\n")


def _sources(suffix=".py"):
    """The package's own sources (not what a build left in _build/)."""
    return sorted(p for p in PKG.rglob(f"*{suffix}")
                  if "_build" not in p.relative_to(PKG).parts)


@pytest.mark.parametrize("pattern", [
    r"^\s*(import jax|from jax)\b",
    r"torch\.compile",
    r"scaled_dot_product_attention",
    r"^\s*try\s*:",
], ids=["no-jax", "no-torch-compile", "no-sdpa", "no-try"])
def test_port_sources_avoid(pattern):
    rx = re.compile(pattern, re.M)
    hits = [str(p.relative_to(REPO)) for p in _sources() if rx.search(p.read_text())]
    assert not hits, hits


def test_kernel_sources_note_what_they_replace():
    for name, pallas in (("raster_shade.cu", "_raster_shade_kernel"),
                         ("raster_shade_2p.cu", "_raster_shade_kernel_2p"),
                         ("shade.cu", "_shade_kernel"),
                         ("raster_depth.cu", "_depth_kernel"),
                         ("raster_blend.cu", "_blend_kernel"),
                         ("shade_epilogue.cu", "_shade_kernel")):
        text = (PKG / "csrc" / name).read_text()
        assert pallas in text
        assert re.search(r"Replaces the (epilogue of the )?Pallas kernel", text)
        assert "extern \"C\" int" in text and "cudaGetLastError" in text
    assert set(_kernels.SOURCES) == {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert "-fmad=false" in _kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
