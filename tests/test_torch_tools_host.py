"""The port's last host tools against the JAX package's (CPU, numpy only
on both sides; the JAX tools import no jax):

- tools/assetembed.py: embed_image's text equal to the JAX function's,
  u8 and f32 images, Python and C; its command line (the PNG read with
  zlib) equal to the JAX tool's on the same RGB and RGBA PNGs (there
  read with PIL, converted to RGBA);
- examples/common.py's PNG reader and writer: RGB and RGBA round trips,
  and the reader on PIL-written PNGs (every filter type PIL picks);
- tools/debugviewer.py: the HTML equal to the JAX tool's on a dump
  written by the port's debug ring and on one written by the JAX ring.
  The tools colour a block by hash(name), and Python salts str hashes
  per process, so the two tools are compared inside one process.

The golden scripts (megakernel_golden, stress_golden, update_goldens)
are held through the tests that already render and hold their frames:
tests/test_torch_stress_frame.py::test_megakernel_golden_through_the_port,
tests/test_torch_stress_golden.py and the example tests call the
scripts' render functions.  Here: their default output lands in the
directory given, never in tests/golden/, and update_goldens names the
pack apps it leaves out.
"""

import numpy as np
import pytest
from PIL import Image

from datum_tpu.debug import debug as jdebug
from datum_tpu.tools import assetembed as jembed
from datum_tpu.tools import debugviewer as jviewer

from datum_tpu_torch.debug import debug
from datum_tpu_torch.examples.common import read_png, write_png
from datum_tpu_torch.tools import assetembed, debugviewer

RNG = np.random.default_rng(7)


@pytest.mark.parametrize("lang", ["py", "c"])
@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_embed_image_equals_jax(lang, kind):
    img = RNG.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    if kind == "f32":
        img = RNG.random((6, 3, 4), dtype=np.float32) * 1.2 - 0.1    # clipped ends too
    assert (assetembed.embed_image(img, name="logo", lang=lang)
            == jembed.embed_image(img, name="logo", lang=lang))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(channels, tmp_path):
    img = RNG.integers(0, 256, (19, 23, channels), dtype=np.uint8)
    write_png(tmp_path / "a.png", img)
    back = read_png(tmp_path / "a.png")
    assert back.dtype == np.uint8 and np.array_equal(back, img)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_read_png_of_pil(mode, tmp_path):
    """PIL's encoder picks a filter per row (smooth gradients and noise
    give it reason to use all five)."""
    h, w = 40, 33
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([(xx * 7) % 256, (yy * 5 + xx) % 256, (xx * yy) % 256,
                    RNG.integers(0, 256, (h, w))], -1).astype(np.uint8)
    img[::3] = RNG.integers(0, 256, img[::3].shape, dtype=np.uint8)
    img = img[..., :len(mode)]
    Image.fromarray(img, mode).save(tmp_path / "p.png", optimize=True)
    assert np.array_equal(read_png(tmp_path / "p.png"), img)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("out", ["logo.py", "logo.h"])
def test_assetembed_command_equals_jax(channels, out, tmp_path):
    img = RNG.integers(0, 256, (8, 12, channels), dtype=np.uint8)
    write_png(tmp_path / "in.png", img)
    assetembed.main([str(tmp_path / "in.png"), str(tmp_path / out), "fallback"])
    rgba = np.asarray(Image.open(tmp_path / "in.png").convert("RGBA"))
    want = jembed.embed_image(rgba, name="fallback",
                              lang="c" if out.endswith(".h") else "py")
    assert (tmp_path / out).read_text() == want


def _fill(m, log):
    """Frames with nested blocks (an END that closes an inner one
    unmatched), device passes and a frame without blocks."""
    t = 10.0
    for f in range(4):
        log.frame += 1
        log.push(m.ENTRY_FRAME, "frame", timestamp=t)
        if f == 3:
            log.push(m.ENTRY_GPU, "K2 shade", timestamp=t, extra=0.004)
            continue
        log.push(m.ENTRY_BEGIN, "render", timestamp=t)
        for name, dur in (("shadows", 0.003), ("raster <K1>", 0.002 + 1e-4 * f)):
            log.push(m.ENTRY_BEGIN, name, timestamp=t)
            t += dur
            log.push(m.ENTRY_END, name, timestamp=t)
        log.push(m.ENTRY_BEGIN, "never closed", timestamp=t)
        t += 0.001
        log.push(m.ENTRY_END, "render", timestamp=t)
        log.push(m.ENTRY_GPU, "K1 raster", timestamp=t, extra=0.0042)
        t += 0.002


@pytest.mark.parametrize("ring", ["port", "jax"])
def test_debugviewer_html_equals_jax(ring, tmp_path):
    m = debug if ring == "port" else jdebug
    log = m.DebugLog()
    _fill(m, log)
    path = str(tmp_path / "dump.gltd")
    m.stream_debuglog(path, log)
    html = debugviewer.render_html(debug.load_debuglog(path), title=path)
    assert html == jviewer.render_html(jdebug.load_debuglog(path), title=path)
    assert html.count("<rect") == 3 * 3 + 4 and "K2 shade" in html   # 3 spans, 1 pass a frame
    debugviewer.main([path, str(tmp_path / "out.html")])
    assert (tmp_path / "out.html").read_text() == html


def test_golden_scripts_write_where_told(tmp_path, monkeypatch, capsys):
    """update_goldens writes OUT_DIR/<name>.png (the renders stubbed: the
    frames are held by the tests named in the module docstring) and
    leaves out the pack apps without their packs, saying so."""
    from datum_tpu_torch.tools import megakernel_golden, stress_golden, update_goldens

    frame = RNG.integers(0, 256, (4, 6, 3), dtype=np.uint8)
    rendered = []

    def fake_example(name, out_path, device="cuda", pack=None):
        rendered.append((name, device, pack))
        write_png(out_path, frame)

    monkeypatch.setattr(update_goldens, "render_example", fake_example)
    monkeypatch.setattr(megakernel_golden, "render_megakernel_frame", lambda d: frame)
    monkeypatch.setattr(stress_golden, "render", lambda d: (frame, {}))
    out = tmp_path / "goldens"
    assert update_goldens.main([str(out), "--cpu", "--teapot-pack", "t.pack"]) == 0
    names = list(update_goldens.EXAMPLES) + ["teapot", "megakernel", "stress"]
    assert sorted(p.stem for p in out.iterdir()) == sorted(names)
    assert all(np.array_equal(read_png(out / f"{n}.png"), frame) for n in names)
    assert ("teapot", "cpu", "t.pack") in rendered and len(rendered) == 9
    assert "left out (no --<name>-pack given): character" in capsys.readouterr().out
    assert megakernel_golden.main([str(tmp_path / "mk"), "--cpu"]) == 0
    assert np.array_equal(read_png(tmp_path / "mk" / "megakernel.png"), frame)
