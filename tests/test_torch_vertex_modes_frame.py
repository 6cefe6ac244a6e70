"""The animated vertex stage's frames in the port against the JAX
package's (CPU): tests/test_fastpath_vertexmodes.py's scene (a rigged
2-bone column, a wind-bent foliage quad and a 16x16 ocean beside a
floor; its _cfg and _scene imported unedited) at 256x128, on the
megakernel branch (K1 and K2's plain versions; the JAX Pallas kernels in
interpret mode) and the deferred branch (use_pallas off: the scan raster
and the XLA lighting), and a translucent Water on the lit layer.

One state (the JAX package's, through convert.to_torch) and one
sceneset go through both frames.  Tolerances: u8 image RMSE <= 2/255 and
mean |d| <= 0.5 levels, vis equal on >= 99.9% of pixels, luminance
within rel 1e-4.  The bent, t=2 frame must move each third of the
port's frame by the JAX test's thresholds (actor > 0.003, foliage >
0.003, ocean > 0.001 mean |d|).  The port's own host build of the scene
(its RenderContext, RenderList, Ocean) gives the JAX host's state and
draws exactly and its dynamic-vertex slab within atol/rtol 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest

from test_fastpath_vertexmodes import _cfg, _scene
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)
from datum_tpu.render import frame as jax_frame
from datum_tpu.render.types import make_sceneset as jax_make_sceneset

from datum_tpu_torch.ops.common import FrameConfig
from datum_tpu_torch.render.frame import attach_host_expansion, render_frame



def _port_cfg(jcfg):
    """The port's FrameConfig with the JAX config's values."""
    return FrameConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(FrameConfig)})


def _jax_inputs(cfg, ctx, cam, params, rl):
    """(numpy state, draws, sceneset) as the JAX package's
    RenderContext.render builds them."""
    ss = jax_make_sceneset(cam, params, point_lights=rl.point_lights,
                           spot_lights=rl.spot_lights, probes=rl.probes)
    draws = rl.draw_arrays(cfg.max_instances, ctx.default_material,
                           max_palettes=cfg.max_palettes, max_bones=cfg.max_bones)
    ctx.expand_host(draws)
    if cfg.max_translucent_draws > 0:
        draws["translucent"] = rl.translucent_arrays(cfg.max_translucent_draws,
                                                     ctx.default_material)
    draws["dyn"] = rl.oceans[0].vertex_data(cfg.max_dynamic_vertices, cam.position)
    return (jax.tree.map(np.asarray, ctx.device_state()),
            jax.tree.map(np.asarray, draws), ss)


def _both(cfg, ctx, state, draws, ss):
    ref = jax.tree.map(np.asarray, jax_frame.render_frame(cfg, state, draws, ss))
    pd = dict(draws)
    attach_host_expansion(ctx.pool, pd, cfg.max_vertices, cfg.max_triangles,
                          cfg.max_translucent_tris)
    return ref, render_frame(cfg, state, pd, ss, device="cpu")


def _check(ref, out):
    a = ref["image"].astype(np.float32)
    b = out["image"].numpy().astype(np.float32)
    assert b.shape == (128, 256, 3) and b.mean() > 10
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) <= 2.0
    lum_a, lum_b = float(ref["luminance"]), float(out["luminance"])
    assert abs(lum_b - lum_a) <= 1e-4 * abs(lum_a), (lum_a, lum_b)
    assert (ref["vis"] == out["vis"].numpy()).mean() >= 0.999
    assert int(out["bin_overflow"]) == 0


@pytest.mark.parametrize("fast", [True, False], ids=["megakernel", "deferred"])
def test_vertex_modes_frame_matches_jax_frame(fast):
    cfg = _cfg(fast)
    ctx, cam, params, rl = _scene(cfg, False, 0.0)
    ref, out = _both(cfg, ctx, *_jax_inputs(cfg, ctx, cam, params, rl))
    _check(ref, out)


def test_bent_frame_moves_each_region():
    """tests/test_fastpath_vertexmodes.py's check (b) on the port's
    megakernel frames: the bent, t=2 frame against the rest frame moves
    the actor's third, the foliage's and the ocean's."""
    cfg = _cfg(True)
    imgs = []
    for bent, t in ((False, 0.0), (True, 2.0)):
        ctx, cam, params, rl = _scene(cfg, bent, t)
        state, draws, ss = _jax_inputs(cfg, ctx, cam, params, rl)
        attach_host_expansion(ctx.pool, draws, cfg.max_vertices, cfg.max_triangles,
                              cfg.max_translucent_tris)
        imgs.append(render_frame(cfg, state, draws, ss, device="cpu")["image"]
                    .numpy().astype(np.float32) / 255.0)
    d = np.abs(imgs[1] - imgs[0]).mean(-1)
    third = d.shape[1] // 3
    assert d[:, :third].mean() > 0.003
    assert d[:, third:2 * third].mean() > 0.003
    assert d[:, 2 * third:].mean() > 0.001


def _water_scene(cfg):
    """A floor, a sphere half under water and a translucent Water pushed
    with push_water(translucent=True): the first ocean, so the slab moves
    its grid (JAX package's host classes)."""
    from datum_tpu.math import Transform
    from datum_tpu.render import Camera, RenderContext, RenderList, RenderParams
    from datum_tpu.render import primitives
    from datum_tpu.render.water import Water, push_water

    ctx = RenderContext(cfg)
    sv, si = primitives.unit_sphere(12, 6)
    ball = ctx.add_mesh(sv, si)
    pv, pi = primitives.plane(20.0, 4.0)
    floor = ctx.add_mesh(pv, pi)
    red = ctx.add_material(color=(0.85, 0.3, 0.2, 1), roughness=0.5)
    grey = ctx.add_material(color=(0.6, 0.6, 0.65, 1), roughness=0.9)
    wmat = ctx.add_water_material(color=(0.6, 0.8, 1.0, 0.35))
    water = Water(ctx, grid=24, patch_size=8.0, ripple=2e-3, flow=(0.2, 0.1))
    water.update(1.5)
    cam = Camera()
    cam.set_projection(np.radians(60), 2.0)
    cam.lookat(np.array([0.0, 3.0, 9.0]), np.array([0.0, 0.5, 0.0]),
               np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=cfg.width, height=cfg.height)
    params.sundirection = np.array([-0.3, -0.8, -0.4], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    params.sunintensity = np.array([3.5, 3.4, 3.2], np.float32)
    rl = RenderList()
    rl.push_mesh(floor, Transform.identity(), grey)
    rl.push_mesh(ball, Transform.translation([0.5, 0.3, 0.0]), red)
    push_water(rl, water, Transform.translation([-4.0, 0.4, -4.0]), wmat,
               translucent=True)
    return ctx, cam, params, rl


def test_translucent_water_on_the_lit_layer_matches_jax_frame():
    """push_water(translucent=True): the Water's slab-patched grid goes
    through the lit translucent layer (K1 with alpha_in_alb, its plane
    assembly and K2's plain versions, the depth-aware transmission and the
    refraction) against the JAX megakernel frame."""
    # forward bins of 512: at 256x128 the grid's 1,152 triangles fall
    # in a few tiles, and the default 64 would drop most of them
    cfg = dataclasses.replace(_cfg(True), max_translucent_draws=2,
                              max_translucent_tris=2048, enable_skinning=False,
                              enable_foliage=False, forward_bin_capacity=512)
    ctx, cam, params, rl = _water_scene(cfg)
    state, draws, ss = _jax_inputs(cfg, ctx, cam, params, rl)
    assert int(draws["translucent"]["count"]) == 1 and int(draws["count"]) == 2
    ref, out = _both(cfg, ctx, state, draws, ss)
    _check(ref, out)
    # the water covers rows 56-88, columns ~48-208: without it the frame
    # differs there
    rl.translucents.clear()
    state0, draws0, ss0 = _jax_inputs(cfg, ctx, cam, params, rl)
    attach_host_expansion(ctx.pool, draws0, cfg.max_vertices, cfg.max_triangles,
                          cfg.max_translucent_tris)
    out0 = render_frame(cfg, state0, draws0, ss0, device="cpu")
    d = (out["image"].float() - out0["image"].float()).abs().mean(-1)
    assert d[56:88, 64:192].mean() > 5.0


def _port_scene(cfg, bent, t):
    """tests/test_fastpath_vertexmodes.py::_scene built from the port's
    own host classes."""
    from datum_tpu_torch.math import Transform
    from datum_tpu_torch.render import primitives
    from datum_tpu_torch.render.camera import Camera
    from datum_tpu_torch.render.context import RenderContext
    from datum_tpu_torch.render.ocean import Ocean, OceanParams, render_ocean_surface
    from datum_tpu_torch.render.renderlist import RenderList
    from datum_tpu_torch.render.types import RenderParams

    ctx = RenderContext(cfg, device="cpu")
    sv, si = primitives.unit_sphere(12, 6)
    pos = sv["position"] * np.array([0.8, 2.2, 0.8], np.float32)
    sv = dict(sv, position=pos)
    rig = np.zeros(len(pos), dtype=[("bone", np.int32, 4), ("weight", np.float32, 4)])
    rig["bone"][:, 0] = (pos[:, 1] > 0.0)
    rig["weight"][:, 0] = 1.0
    actor = ctx.add_mesh(sv, si, rig=rig)
    qv, qi = primitives.unit_quad()
    blade = ctx.add_mesh(dict(qv, position=qv["position"] * 2.0), qi)
    pv, pi = primitives.plane(20.0, 4.0)
    floor = ctx.add_mesh(pv, pi)
    mat = ctx.add_material(color=(0.85, 0.3, 0.2, 1), roughness=0.5)
    green = ctx.add_material(color=(0.2, 0.8, 0.3, 1), roughness=0.8)
    grey = ctx.add_material(color=(0.6, 0.6, 0.65, 1), roughness=0.9)
    water = ctx.add_water_material()
    ocean = Ocean(ctx, grid=16, patch_size=6.0,
                  params=OceanParams(amplitude=2e-3, choppiness=1.2))
    ocean.update(1.0 + t)
    palette = np.stack([Transform.identity().flat(),
                        Transform.rotation([0, 0, 1.0], 0.9 if bent else 0.0).flat()
                        ]).astype(np.float32)
    cam = Camera()
    cam.set_projection(np.radians(60), 2.0)
    cam.lookat(np.array([0.0, 3.0, 10.0]), np.array([0.0, 1.0, 0.0]),
               np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=cfg.width, height=cfg.height)
    params.sundirection = np.array([-0.3, -0.8, -0.4], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    params.sunintensity = np.array([3.5, 3.4, 3.2], np.float32)
    params.ambientintensity = 0.5
    rl = RenderList()
    rl.push_mesh(floor, Transform.identity(), grey)
    rl.push_actor(actor, Transform.translation([-4.0, 2.2, 0.0]), mat, palette)
    rl.push_foliage(blade, Transform.translation([0.0, 1.0, 2.0]), green,
                    wind=(2.5 * t, 0.0, 0.0, 0.8), bendscale=(0, 0.35, 0))
    render_ocean_surface(ocean, rl, Transform.translation([4.5, 0.2, 2.0]), water)
    return ctx, cam, params, rl


@pytest.mark.parametrize("bent,t", [(False, 0.0), (True, 2.0)], ids=["rest", "bent"])
def test_port_host_build_matches_jax_host(bent, t):
    """The port's host build of the scene: its state (pool with the rig
    rows, the materials, the water LUT texture) and its frame_draws (the
    palettes, the wind rows, the host expansion) equal the JAX host's;
    its slab (computed on the context's device) agrees within atol/rtol
    1e-5, offset and count exact; and its frame matches the JAX frame."""
    from datum_tpu_torch.render.types import make_sceneset

    jcfg = _cfg(False)
    jctx, jcam, jparams, jrl = _scene(jcfg, bent, t)
    jstate, jdraws, jss = _jax_inputs(jcfg, jctx, jcam, jparams, jrl)
    ctx, cam, params, rl = _port_scene(_port_cfg(jcfg), bent, t)
    state = ctx.host_state()
    for k in ("attr12", "bone_idx", "bone_wt", "triangles", "mesh_vtx_offset"):
        np.testing.assert_array_equal(state["geometry"][k], jstate["geometry"][k], k)
    np.testing.assert_array_equal(state["textures"], jstate["textures"])
    for k in ("color", "roughness", "albedomap", "packed10"):
        np.testing.assert_array_equal(state["materials"][k], jstate["materials"][k], k)
    draws = ctx.frame_draws(rl, cam)
    for k in ("mesh", "world", "material", "count", "wind", "bendscale",
              "detailbendscale", "palettes", "palette_id", "src_v", "vtx_draw", "tris"):
        np.testing.assert_array_equal(draws[k], jdraws[k], k)
    dyn, jdyn = draws["dyn"], jdraws["dyn"]
    assert (int(dyn["offset"]), int(dyn["count"])) == (int(jdyn["offset"]),
                                                       int(jdyn["count"])) == (99, 289)
    for k in ("positions", "normals", "texcoords"):
        np.testing.assert_allclose(dyn[k].numpy(), jdyn[k], atol=1e-5, rtol=1e-5)
    ss = make_sceneset(cam, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights, probes=rl.probes)
    ref = jax.tree.map(np.asarray, jax_frame.render_frame(jcfg, jstate, jdraws, jss))
    out = render_frame(ctx.config, ctx.device_state("cpu"), draws, ss, device="cpu")
    _check(ref, out)
