"""The port's device sprite and text pass against the JAX package (CPU).

- `ops/sprite_pass.py::composite_sprites` (the plain version on CPU
  tensors) against the JAX `composite_sprites` on the instance sets of
  tests/test_sprite_pass.py and on seeded random sets with rotated,
  offscreen, degenerate and inactive-tail sprites: atol 1e-5 on the
  [0, 1] floats (XLA on the CPU may contract the blend and the bilinear
  lerps into FMAs; the port rounds each operation);
- `RenderList.push_sprite` / `push_text` / `sprite_arrays` and
  `RenderContext.overlay_info` equal to the JAX package's, exactly;
- 256x128 frames with sprites and text through `RenderContext.render`
  on the megakernel and the deferred branch against the JAX frame (RMSE
  < 2/255, mean |d| <= 0.5 levels), the port's frame equal to its own
  frame without sprites outside the sprite windows, and a
  `params.scale=0.5` frame whose sprites composite after the blit, in
  display coordinates.
"""

import jax
import numpy as np
import pytest
import torch

from datum_tpu.ops.common import FrameConfig as JaxFrameConfig
from datum_tpu.ops.sprite_pass import composite_sprites as jax_composite_sprites
from datum_tpu.render import Camera as JaxCamera
from datum_tpu.render import RenderContext as JaxRenderContext
from datum_tpu.render import RenderList as JaxRenderList
from datum_tpu.render import RenderParams as JaxRenderParams
from datum_tpu.render.sprite import Font as JaxFont
from datum_tpu.math import Transform as JaxTransform
from datum_tpu.scenes import datumtest_scene as jax_datumtest_scene

from test_sprite_pass import make_inst
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.math import Transform
from datum_tpu_torch.ops.common import FrameConfig
from datum_tpu_torch.ops.sprite_pass import (composite_sprites,
                                             composite_sprites_reference)
from datum_tpu_torch.render.camera import Camera
from datum_tpu_torch.render.context import RenderContext
from datum_tpu_torch.render.renderlist import RenderList
from datum_tpu_torch.render.sprite import Font
from datum_tpu_torch.render.types import RenderParams
from datum_tpu_torch.scenes import datumtest_scene

ATOL = 1e-5


def _both(rgb, inst, atlas, region):
    want = np.asarray(jax_composite_sprites(rgb, inst, atlas, region=region))
    got = composite_sprites(torch.from_numpy(rgb), to_torch(inst, "cpu"),
                            torch.from_numpy(atlas), region)
    assert got.dtype == torch.float32 and got.shape == rgb.shape
    return want, got.numpy()


def _rotated(c=np.cos(0.4), s=np.sin(0.4)):
    return [
        ((40, 30), (24, 0), (0, 16), (2, 2), (30, 18), (1, 1, 1, 1)),
        ((90, 40), (20 * c, 20 * s), (-12 * s, 12 * c), (10, 4), (40, 28),
         (0.9, 0.5, 0.2, 0.6)),
        ((-8, -5), (20, 0), (0, 20), (0, 0), (20, 20), (1, 1, 1, 0.8)),
        ((150, 88), (20, 0), (0, 20), (0, 0), (20, 20), (1, 1, 1, 1)),
    ]


def test_matches_jax_on_the_reference_sets(rng):
    """tests/test_sprite_pass.py's four sprites: axis-aligned, rotated
    and tinted, and two clamped at the image edges."""
    atlas = rng.rand(32, 48, 4).astype(np.float32)
    rgb = rng.rand(96, 160, 3).astype(np.float32)
    want, got = _both(rgb, make_inst(_rotated()), atlas, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(got - rgb).max() > 0.1


@pytest.mark.parametrize("order", ["red_blue", "blue_red"])
def test_draw_order_matches_jax(order):
    """Overlapping opaque sprites: the last pushed wins."""
    atlas = np.zeros((4, 8, 4), np.float32)
    atlas[:, :4] = [1, 0, 0, 1]
    atlas[:, 4:] = [0, 0, 1, 1]
    rgb = np.zeros((64, 64, 3), np.float32)
    red = ((10, 10), (20, 0), (0, 20), (0, 0), (4, 4), (1, 1, 1, 1))
    blue = ((15, 15), (20, 0), (0, 20), (4, 0), (8, 4), (1, 1, 1, 1))
    prims = [red, blue] if order == "red_blue" else [blue, red]
    want, got = _both(rgb, make_inst(prims), atlas, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    top = 2 if order == "red_blue" else 0
    assert got[20, 20, top] > 0.9 and got[20, 20, 2 - top] < 0.1


def test_inactive_tail_matches_jax():
    """Garbage past count in the padded tail renders nothing."""
    atlas = np.ones((4, 4, 4), np.float32)
    rgb = np.zeros((64, 64, 3), np.float32)
    inst = make_inst([((8, 8), (16, 0), (0, 16), (0, 0), (4, 4), (1, 1, 1, 1))])
    inst["origin"][4] = (30, 30)
    inst["axis_x"][4] = (16, 0)
    inst["axis_y"][4] = (0, 16)
    inst["uv1"][4] = (4, 4)
    inst["tint"][4] = (1, 1, 1, 1)
    want, got = _both(rgb, inst, atlas, 32)
    np.testing.assert_array_equal(got, want)
    assert got[38, 38].max() == 0.0 and got[12, 12].min() > 0.9


def _random_inst(rng, S, count, w, h, aw, ah):
    """Seeded sprites: rotated and scaled rects anywhere around the image
    (some fully offscreen), atlas rects partly outside the atlas, every
    fifth degenerate (zero or parallel axes), garbage past count."""
    inst = dict(origin=np.zeros((S, 2), np.float32), axis_x=np.zeros((S, 2), np.float32),
                axis_y=np.zeros((S, 2), np.float32), uv0=np.zeros((S, 2), np.float32),
                uv1=np.zeros((S, 2), np.float32), tint=np.zeros((S, 4), np.float32),
                count=np.int32(count))
    for i in range(S):
        rot = rng.uniform(-np.pi, np.pi)
        sx, sy = rng.uniform(2, 40, 2)
        c, s = np.cos(rot), np.sin(rot)
        ax, ay = np.array([sx * c, sx * s]), np.array([-sy * s, sy * c])
        if i % 5 == 3:
            ay = ax * rng.choice([0.0, 0.5])          # degenerate
        inst["origin"][i] = rng.uniform([-60, -60], [w + 20, h + 20])
        inst["axis_x"][i], inst["axis_y"][i] = ax, ay
        u0 = rng.uniform([-4, -4], [aw, ah])
        inst["uv0"][i] = u0
        inst["uv1"][i] = u0 + rng.uniform(1, 24, 2)
        inst["tint"][i] = rng.uniform(0, 1.2, 4)
    return inst


@pytest.mark.parametrize("seed,S,count,region", [(0, 24, 18, 64), (1, 16, 16, 48),
                                                 (2, 32, 40, 96), (3, 8, 0, 64)])
def test_random_sets_match_jax(seed, S, count, region):
    rng = np.random.RandomState(seed)
    h, w = 96, 160
    atlas = rng.rand(40, 64, 4).astype(np.float32)
    rgb = rng.rand(h, w, 3).astype(np.float32)
    inst = _random_inst(rng, S, count, w, h, 64, 40)
    want, got = _both(rgb, inst, atlas, region)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if count == 0:
        np.testing.assert_array_equal(got, rgb)


def test_degenerate_sprite_paints_nothing():
    """inv_det = 0 would map every window pixel to (u, v) = (0, 0): the
    |det| test keeps it out of the blend."""
    atlas = np.ones((4, 4, 4), np.float32)
    rgb = np.full((64, 64, 3), 0.25, np.float32)
    inst = make_inst([((20, 20), (16, 0), (8, 0), (0, 0), (4, 4), (1, 1, 1, 1)),
                      ((20, 20), (1e-5, 0), (0, 1e-5), (0, 0), (4, 4), (1, 1, 1, 1))])
    got = composite_sprites_reference(torch.from_numpy(rgb), to_torch(inst, "cpu"),
                                      torch.from_numpy(atlas), 32).numpy()
    np.testing.assert_array_equal(got, rgb)


def test_region_larger_than_the_image_raises():
    rgb = torch.zeros((32, 64, 3))
    inst = to_torch(make_inst([]), "cpu")
    with pytest.raises(ValueError, match="overlay region"):
        composite_sprites(rgb, inst, torch.ones((4, 4, 4)), 48)


# ------------------------------------------------ render list and atlas

def _push_hud(rl, sid_icon, sid_layered, sid_panel, big=True):
    rl.push_sprite((8, 8, 16, 16), sid_icon)
    rl.push_sprite((40, 6, 24, 12), sid_layered, layer=3, tint=(1, 0.8, 0.6, 0.9))
    rl.push_sprite((80, 20, 20, 14), sid_icon, rotation=0.7)
    if big:
        rl.push_sprite((5, 7, 300, 90), sid_panel, tint=(1, 1, 1, 0.5), rotation=0.3)
    rl.push_text("FPS: 60.0 (A-Z/09%)", (8, 100), tint=(1, 1, 0.2, 1))
    rl.push_text("x2 scale", (120, 40), scale=2)


def _hud_images(rng):
    icon = rng.randint(0, 256, (16, 16, 4)).astype(np.uint8)
    layered = rng.randint(0, 256, (4 * 8, 12, 4)).astype(np.uint8)   # 4 layers
    panel = rng.rand(20, 90, 3).astype(np.float32)                     # RGB float
    return icon, layered, panel


def _fill_ctx(ctx, images, font):
    icon, layered, panel = images
    ids = (ctx.add_sprite(icon), ctx.add_sprite(layered, layers=4), ctx.add_sprite(panel))
    if font is not None:
        ctx.set_overlay_font(font)
    return ids


def _assert_tree_equal(a, b, path="root"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=path)


def _without_glyph_fn(info):
    info = dict(info)
    if "font" in info:
        f = dict(info["font"])
        fn = f.pop("glyph_index")
        assert [fn(c) for c in "AZ09 .%?a"] == [
            JaxFont.builtin().glyph_index(c) for c in "AZ09 .%?a"]
        info["font"] = f
    return info


@pytest.mark.parametrize("font", ["builtin", "none"])
def test_overlay_info_equals_jax(rng, font):
    """The shelf-packed atlas (a panel wider than the 64-px minimum), the
    sprite rects and layers and the font's glyph table."""
    images = _hud_images(rng)
    jctx = JaxRenderContext(JaxFrameConfig(max_overlay_sprites=8))
    tctx = RenderContext(FrameConfig(max_overlay_sprites=8), device="cpu")
    jf = JaxFont.builtin() if font == "builtin" else None
    tf = Font.builtin() if font == "builtin" else None
    _fill_ctx(jctx, images, jf)
    _fill_ctx(tctx, images, tf)
    assert ("font" in tctx.overlay_info()) == (font == "builtin")
    _assert_tree_equal(_without_glyph_fn(jctx.overlay_info()),
                       _without_glyph_fn(tctx.overlay_info()))
    atlas = np.asarray(jax.tree.map(np.asarray, jctx.device_state())["overlay_atlas"])
    np.testing.assert_array_equal(atlas, tctx.host_state()["overlay_atlas"])


def test_empty_overlay_atlas_equals_jax():
    jctx = JaxRenderContext(JaxFrameConfig(max_overlay_sprites=4))
    tctx = RenderContext(FrameConfig(max_overlay_sprites=4), device="cpu")
    _assert_tree_equal(jctx.overlay_info(), tctx.overlay_info())


@pytest.mark.parametrize("S,region", [(64, 128), (64, 48), (6, 128), (0, 128)])
def test_sprite_arrays_equal_jax(rng, S, region):
    """Icons, a layered sprite, a rotated icon, a panel larger than the
    region (split into chunks), two lines of text; the count capped at S."""
    images = _hud_images(rng)
    jctx = JaxRenderContext(JaxFrameConfig(max_overlay_sprites=max(S, 1)))
    tctx = RenderContext(FrameConfig(max_overlay_sprites=max(S, 1)), device="cpu")
    jids = _fill_ctx(jctx, images, JaxFont.builtin())
    tids = _fill_ctx(tctx, images, Font.builtin())
    jrl, trl = JaxRenderList(), RenderList()
    _push_hud(jrl, *jids)
    _push_hud(trl, *tids)
    trl.push_sprite((1, 1, 4, 4), 99)             # an unknown id is skipped
    jrl.push_sprite((1, 1, 4, 4), 99)
    a = jrl.sprite_arrays(jctx.overlay_info(), S, region)
    b = trl.sprite_arrays(tctx.overlay_info(), S, region)
    _assert_tree_equal(a, b)
    assert int(b["count"]) <= S
    if S == 64 and region == 48:
        assert int(b["count"]) > 30     # the panel splits into many chunks


# --------------------------------------------------------------- frames

SLICE = dict(width=256, height=128, sphere_detail=8, grid=(4, 3), n_point_lights=8,
             skybox=False, max_vertices=2048, max_triangles=2048, bin_capacity=128,
             big_capacity=16, bin_max_span=8, use_pallas=True,
             enable_material_maps=True, texture_filter="mip_half",
             enable_shadows=False, max_overlay_sprites=96, overlay_region=64)


def _windows(inst, region, w, h):
    """A mask of every pixel some live sprite's window covers."""
    mask = np.zeros((h, w), bool)
    for i in range(int(inst["count"])):
        o, ax, ay = inst["origin"][i], inst["axis_x"][i], inst["axis_y"][i]
        xs = [o[0], o[0] + ax[0], o[0] + ay[0], o[0] + ax[0] + ay[0]]
        ys = [o[1], o[1] + ax[1], o[1] + ay[1], o[1] + ax[1] + ay[1]]
        sx = int(np.clip(np.round((min(xs) + max(xs)) / 2 - region / 2), 0, w - region))
        sy = int(np.clip(np.round((min(ys) + max(ys)) / 2 - region / 2), 0, h - region))
        # one pixel more each side: f64 here, f32 in the pass
        mask[max(sy - 1, 0):sy + region + 1, max(sx - 1, 0):sx + region + 1] = True
    return mask


def _close(a, b):
    a, b = a.astype(np.float32), b.astype(np.float32)
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) <= 2.0


def test_megakernel_frame_with_sprites_matches_jax(rng):
    """The bench scene's slice on the megakernel branch with a HUD of
    icons, a layered and a rotated sprite, a split panel and text."""
    images = _hud_images(rng)
    jctx, jcam, jparams, jmake = jax_datumtest_scene(pallas_interpret=True, **SLICE)
    tctx, tcam, tparams, tmake = datumtest_scene(device="cpu", **SLICE)
    jids = _fill_ctx(jctx, images, JaxFont.builtin())
    tids = _fill_ctx(tctx, images, Font.builtin())
    jrl, trl = jmake(0.3), tmake(0.3)
    _push_hud(jrl, *jids)
    _push_hud(trl, *tids)
    want = np.asarray(jctx.render(jcam, jrl, jparams))
    got = tctx.render(tcam, trl, tparams)
    assert got.shape == (128, 256, 3) and got.dtype == np.uint8
    _close(want, got)
    plain = tctx.render(tcam, tmake(0.3), tparams)
    assert (got != plain).any(axis=-1).sum() > 500       # the HUD draws
    inst = trl.sprite_arrays(tctx.overlay_info(), 96, 64)
    outside = ~_windows(inst, 64, 256, 128)
    assert outside.sum() > 500
    np.testing.assert_array_equal(got[outside], plain[outside])


def _triangle_scene(Ctx, Cam, RL, Params, Tf, cfg, device=None):
    ctx = Ctx(cfg) if device is None else Ctx(cfg, device=device)
    icon = np.zeros((16, 16, 4), np.uint8)
    icon[:, :, 1] = 255
    icon[:, :, 3] = 255
    icon[4:8, 4:12, 0] = 200
    sid = ctx.add_sprite(icon)
    ctx.set_overlay_font()
    mesh = ctx.add_mesh(dict(position=np.array([[-1.5, -1, 0], [1.5, -1, 0],
                                                [0, 1.5, 0]], np.float32),
                             normal=np.tile([0, 0, 1.0], (3, 1))), np.array([0, 1, 2]))
    mat = ctx.add_material(color=(1.0, 0.2, 0.1, 1))
    cam = Cam()
    cam.set_projection(np.radians(60), cfg.width / cfg.height)
    cam.lookat(np.array([0.0, 1.0, 5.0]), np.array([0.0, 0.0, 0.0]),
               np.array([0.0, 1.0, 0.0]))
    rl = RL()
    rl.push_mesh(mesh, Tf.identity(), mat)
    rl.push_sprite((8, 8, 16, 16), sid)
    rl.push_sprite((200, 90, 16, 16), sid, rotation=0.5, tint=(1, 1, 1, 0.7))
    rl.push_text("FPS 60", (8, 100), tint=(1, 1, 0.2, 1))
    params = Params(width=cfg.width, height=cfg.height)
    params.sundirection = np.array([0, -0.3, -1.0], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    return ctx, cam, rl, params


# tests/test_sprite_pass.py's deferred frame (FrameConfig's default path)
DEFERRED = dict(width=256, height=128, max_vertices=1024, max_triangles=1024,
                max_instances=8, bin_capacity=64, big_capacity=8, enable_shadows=False,
                enable_ssao=False, enable_ssr=False, enable_bloom=False,
                max_overlay_sprites=8, overlay_region=64)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_deferred_frame_with_sprites_matches_jax(scale):
    """The deferred branch (scan raster) with an icon, a rotated icon and
    text; at params.scale 0.5 the frame renders at 128x64 and the
    sprites composite after the nearest blit, at display coordinates and
    size."""
    jargs = _triangle_scene(JaxRenderContext, JaxCamera, JaxRenderList,
                            JaxRenderParams, JaxTransform, JaxFrameConfig(**DEFERRED))
    targs = _triangle_scene(RenderContext, Camera, RenderList, RenderParams,
                            Transform, FrameConfig(**DEFERRED), device="cpu")
    jargs[3].scale = scale
    targs[3].scale = scale
    want = np.asarray(jargs[0].render(*jargs[1:]))
    got = targs[0].render(*targs[1:])
    assert got.shape == (128, 256, 3)
    _close(want, got)
    patch = got[92:104, 202:214] if scale == 1.0 else got[10:22, 10:22]
    assert patch[..., 1].mean() > 120
    assert targs[0].last_depth.shape == ((128, 256) if scale == 1.0 else (64, 128))


def test_sprite_capacity_is_accepted_and_checked():
    """A sprite count of 0 or below skips the pass (the frame's `> 0`
    tests, as in the JAX package): the frames are equal.  A window below
    1 with sprites raises in the sprite pass."""
    def frame(**over):
        args = _triangle_scene(RenderContext, Camera, RenderList, RenderParams,
                               Transform, FrameConfig(**dict(DEFERRED, **over)),
                               device="cpu")
        return args[0].render(*args[1:])
    np.testing.assert_array_equal(frame(max_overlay_sprites=-1),
                                  frame(max_overlay_sprites=0))
    with pytest.raises(ValueError, match="overlay region 0"):
        frame(overlay_region=0)


def test_resize_keeps_pools_and_resets_depth():
    """resize: the pools and the overlay atlas carry over, the next
    frame renders at the new size, the depth plane resets."""
    targs = _triangle_scene(RenderContext, Camera, RenderList, RenderParams,
                            Transform, FrameConfig(**DEFERRED), device="cpu")
    ctx = targs[0]
    ctx.render(*targs[1:])
    atlas = ctx.overlay_info()["atlas"]
    ctx.resize(192, 96)
    assert ctx.last_depth is None and ctx.config.width == 192
    targs[3].width, targs[3].height = 192, 96
    img = ctx.render(*targs[1:])
    assert img.shape == (96, 192, 3) and ctx.last_depth.shape == (96, 192)
    assert ctx.overlay_info()["atlas"] is atlas
    ctx.resize(192, 96)                           # same size: nothing resets
    assert ctx.last_depth is not None
