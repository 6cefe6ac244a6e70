"""The port's debug layer and host overlays against the JAX package's
(CPU; numpy host code in both, held exactly).

- the event ring (push, wrap-around, block_times over frames), the
  module-level helpers (frame markers, timed blocks, gpu_block,
  statistics, gauges, the value menu, log_once) and the binary dump,
  which must load both ways: the port's dump through the JAX package's
  load_debuglog and the JAX dump through the port's (the bytes equal);
- render_debug_overlay and debug_menu_adjust: equal u8 images;
- render/sprite.py: the builtin font, glyph indices, from_asset, a
  layered Sprite, blit_sprite and draw_text (kerned advance tables,
  scale 2): equal u8 images;
- every render/overlay.py draw (lines, wireframe, gizmo, outline, path
  in screen and world space, fill, bound), with and without a depth
  plane at the frame's size and at half of it: equal u8 images;
- render_fallback: equal images.
"""

import numpy as np
import pytest

from datum_tpu.debug import debug as jdebug
from datum_tpu.debug import overlay as jdoverlay
from datum_tpu.math import bound as jbound
from datum_tpu.math import transform as jtf
from datum_tpu.math.matrix import perspective_proj
from datum_tpu.render import context as jcontext
from datum_tpu.render import overlay as joverlay
from datum_tpu.render import primitives as jprim
from datum_tpu.render import sprite as jsprite

from datum_tpu_torch.debug import debug
from datum_tpu_torch.debug import overlay as doverlay
from datum_tpu_torch.math import bound
from datum_tpu_torch.math import transform as tf
from datum_tpu_torch.render import context
from datum_tpu_torch.render import overlay
from datum_tpu_torch.render import sprite

# ------------------------------------------------------------ the ring


def _fill(m, log, n=40):
    """A fixed event sequence with fixed timestamps: frames, nested
    timed blocks, device pass times."""
    t = 100.0
    for f in range(n):
        log.frame += 1
        log.push(m.ENTRY_FRAME, "frame", timestamp=t)
        for name, dur in (("update", 0.002), ("render", 0.011), ("shadows", 0.003)):
            log.push(m.ENTRY_BEGIN, name, timestamp=t, color=(1, 0.5, 0))
            t += dur * (1 + 0.1 * (f % 3))
            log.push(m.ENTRY_END, name, timestamp=t)
        log.push(m.ENTRY_GPU, "K1 raster", timestamp=t, extra=0.0042 + 1e-4 * f)
        t += 0.001


@pytest.mark.parametrize("size", [4096, 64])
def test_ring_and_block_times_equal_jax(size):
    """The ring at its default size and wrapped (64 entries for 320
    pushes): block_times over 1 and 5 frames equal."""
    a, b = jdebug.DebugLog(size), debug.DebugLog(size)
    _fill(jdebug, a)
    _fill(debug, b)
    assert a.tail == b.tail == 320 and a.entries == b.entries
    for back in (1, 5):
        assert a.block_times(back) == b.block_times(back)
    assert set(b.block_times(1)) == {"update", "render", "shadows", "K1 raster"}


def test_dump_loads_both_ways(tmp_path):
    a, b = jdebug.DebugLog(), debug.DebugLog()
    _fill(jdebug, a)
    _fill(debug, b)
    b.push(debug.ENTRY_STAT, "x" * 80, timestamp=1.0)       # a name past 63 bytes
    a.push(jdebug.ENTRY_STAT, "x" * 80, timestamp=1.0)
    pa, pb = tmp_path / "jax.bin", tmp_path / "port.bin"
    jdebug.stream_debuglog(str(pa), a)
    debug.stream_debuglog(str(pb), b)
    assert pa.read_bytes() == pb.read_bytes()
    from_port = jdebug.load_debuglog(str(pb))
    from_jax = debug.load_debuglog(str(pa))
    assert from_port == from_jax == debug.load_debuglog(str(pb))
    assert len(from_jax) == 321 and from_jax[-1]["name"] == "x" * 63
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="not a debuglog dump"):
        debug.load_debuglog(str(bad))


def test_module_helpers_equal_jax(monkeypatch, capsys):
    """frame_marker, timed_block (also when its body raises),
    begin/end_timed_block, gpu_block, statistic_hit, resource_use, the
    value menu and log_once on fresh global logs."""
    seen = []
    for m in (jdebug, debug):
        log = m.DebugLog()
        monkeypatch.setattr(m, "g_debuglog", log)
        monkeypatch.setattr(m, "_logged_once", set())
        m.frame_marker()
        with m.timed_block("update", color=(0, 1, 0)):
            pass
        with pytest.raises(KeyError):
            with m.timed_block("render"):
                raise KeyError("x")
        m.begin_timed_block("post")
        m.end_timed_block("post")
        m.gpu_block("K2 shade", 0.0031)
        m.statistic_hit("draws", 3)
        m.statistic_hit("draws")
        m.resource_use("raster.bin_overflow", 12, 160)
        v = m.debug_menu_value("exposure", 1.5)
        m.set_debug_menu_value("exposure", 2.0)
        v2 = m.debug_menu_value("exposure", 9.0)
        m.log_once("raster: 12 pairs dropped")
        m.log_once("raster: 12 pairs dropped")
        seen.append(([(e[0], e[1], e[3], e[4], e[5]) for e in log.entries[:log.tail]],
                     log.statistics, log.gauges, log.menu_values, v, v2, log.frame,
                     sorted(log.block_times(1))))
    assert seen[0] == seen[1]
    assert capsys.readouterr().out == "raster: 12 pairs dropped\n" * 2


def test_debug_overlay_equals_jax():
    """The overlay of a filled log (block bars, gauges, the value menu
    with a selection moved and values adjusted) on a seeded frame."""
    imgs = []
    for m, dm in ((jdebug, jdoverlay), (debug, doverlay)):
        log = m.DebugLog()
        _fill(m, log, 12)
        log.gauges["raster.bin_overflow"] = (12, 160)
        log.gauges["pool.vertices"] = (31000, 65536)
        log.menu_values.update(exposure=1.5, fog=0.0, ssao=0.8)
        names = [dm.debug_menu_adjust(1, log=log), dm.debug_menu_adjust(0, 0.5, log=log),
                 dm.debug_menu_adjust(5, -0.25, log=log)]
        img = np.random.RandomState(5).randint(0, 256, (160, 320, 3)).astype(np.uint8)
        dm.render_debug_overlay(img, fps=59.94, log=log)
        imgs.append((img, names, dict(log.menu_values)))
    np.testing.assert_array_equal(imgs[1][0], imgs[0][0])
    assert imgs[0][1:] == imgs[1][1:]
    assert dm.debug_menu_adjust(log=debug.DebugLog()) is None


# ------------------------------------------------------------- sprites

def test_builtin_font_equals_jax():
    a, b = jsprite.Font.builtin(), sprite.Font.builtin()
    for k in ("atlas", "x", "y", "width", "height", "offsetx", "offsety", "advance"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        assert getattr(b, k).dtype == getattr(a, k).dtype
    assert (a.glyphcount, a.ascent, a.descent, a.leading) == (
        b.glyphcount, b.ascent, b.descent, b.leading)
    chars = "".join(chr(c) for c in range(32, 127))
    assert [a.glyph_index(c) for c in chars] == [b.glyph_index(c) for c in chars]


def _baked_font(m, rng):
    """A decoded font asset dict (baked-TTF layout: negative offsety, a
    kerned per-pair advance table) and its atlas."""
    n = 6
    dec = dict(glyphcount=n, x=np.arange(n, dtype=np.uint16) * 7,
               y=np.zeros(n, np.uint16), width=np.full(n, 6, np.uint16),
               height=np.full(n, 9, np.uint16), offsetx=np.array([0, 1, 0, -1, 0, 1], np.int16),
               offsety=np.full(n, -7, np.int16),
               advance=rng.randint(5, 9, (n, n)).astype(np.uint8),
               ascent=7, descent=2, leading=1)
    atlas = rng.randint(0, 256, (9, 7 * n, 4)).astype(np.uint8)
    f = m.Font.from_asset(dec, atlas)
    f.charmap = {c: i + 1 for i, c in enumerate("abcde")}
    return f


@pytest.mark.parametrize("scale", [1, 2])
def test_draw_text_and_blits_equal_jax(scale):
    frames = []
    for m in (jsprite, sprite):
        r = np.random.RandomState(9)
        img = r.randint(0, 256, (96, 200, 3)).astype(np.uint8)
        font = m.Font.builtin()
        w1 = m.draw_text(img, font, "FPS: 59.9 (A-Z/09%)", 4, 6, tint=(1, 1, 0.3, 1),
                         scale=scale)
        w2 = m.draw_text(img, font, "lower case?", -8, 40, scale=scale)   # clipped left
        baked = _baked_font(m, r)
        w3 = m.draw_text(img, baked, "abcxe", 150, 90, tint=(0.5, 1, 1, 0.8), scale=scale)
        spr = m.Sprite(r.rand(4 * 10, 12, 4).astype(np.float32), layers=4, pivot=(0.5, 0.5))
        m.blit_sprite(img, spr.layer(6), 190, -3, tint=(1, 0.5, 0.5, 0.7))
        m.blit_sprite(img, spr.layer(1), 60, 60)
        m.blit_sprite(img, spr.layer(2), 500, 500)                 # off the frame
        frames.append((img, (w1, w2, w3), spr.image, spr.height, spr.width))
    np.testing.assert_array_equal(frames[1][0], frames[0][0])
    assert frames[0][1:2] == frames[1][1:2]
    np.testing.assert_array_equal(frames[1][2], frames[0][2])
    assert frames[0][3:] == frames[1][3:]


def test_render_fallback_equals_jax():
    for tick in (0, 25, 47):
        np.testing.assert_array_equal(context.render_fallback(320, 180, tick),
                                      jcontext.render_fallback(320, 180, tick))


# ------------------------------------------------------------ overlays

def _vp(eye=(0, 0, 6.0)):
    view = np.asarray(jtf.Transform.lookat(
        np.asarray(eye, np.float32), np.zeros(3, np.float32),
        np.array([0, 1, 0], np.float32)).matrix(), np.float32)
    proj = np.asarray(perspective_proj(np.radians(60), 2.0, 0.1), np.float32)
    return proj @ np.linalg.inv(view)


def _depth(h, w):
    """A reverse-Z scene depth plane: a near wall on the left, a far
    slope on the right."""
    d = np.zeros((h, w), np.float32)
    d[:, : w // 2] = 10.0
    d[:, w // 2:] = np.linspace(0.0, 0.05, w - w // 2, dtype=np.float32)
    return d


def _draw_all(m, tmod, bmod, prim, depth):
    h, w = 128, 256
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    vp = _vp()
    t = tmod.Transform.translation([0.3, -0.2, 0.5]) * tmod.Transform.rotation(
        [0.2, 1.0, 0.1], 0.6)
    cv, ci = prim.unit_cube()
    sv, si = prim.unit_sphere(8, 4)
    m.draw_lines(img, rng.uniform(-3, 3, (12, 2, 3)), vp, (255, 0, 0), 0.7, depth=depth)
    m.draw_lines(img, [[[0, 0, 2], [0, 0, 8]]], vp, depth=depth)     # crosses the eye
    m.draw_wireframe(img, cv["position"], ci, t, vp, depth=depth)
    m.draw_outline(img, sv["position"], si, t, vp, campos=[0, 0, 6.0], depth=depth)
    m.draw_gizmo(img, t, vp, size=1.5, depth=depth)
    m.draw_path(img, rng.uniform(-2, 2, (7, 3)), vp, (0, 255, 255), 0.5, closed=True,
                depth=depth)
    m.draw_path(img, [[5, 5], [250, 7], [128, 120], [-20, 60]], color=(255, 255, 0),
                closed=True)
    m.draw_fill(img, [[10, 10], [90, 14], [70, 60], [30, 50], [40, 30]], (0, 128, 255),
                0.6)
    m.draw_bound(img, bmod.Bound3([-1, -0.5, -1], [1.2, 0.7, 0.3]), vp, depth=depth)
    m.draw_line_2d(img, -10.0, 3.3, 300.0, 90.7, (9, 9, 9))
    return img


@pytest.mark.parametrize("depth", ["none", "full", "half"])
def test_overlay_draws_equal_jax(depth):
    dp = {"none": None, "full": _depth(128, 256), "half": _depth(64, 128)}[depth]
    a = _draw_all(joverlay, jtf, jbound, jprim, dp)
    from datum_tpu_torch.render import primitives
    b = _draw_all(overlay, tf, bound, primitives, dp)
    np.testing.assert_array_equal(b, a)
    plain = _draw_all(overlay, tf, bound, primitives, None)
    assert (b != plain).any() == (depth != "none")
