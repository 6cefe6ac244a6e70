"""chip_smoke.py's helpers that run without a card (CPU; no jax): the
PNG decoder it uses (datum_tpu_torch/examples/common.py::read_png: the
card's machine has no PIL) against PIL, on the
committed goldens (the 1920x1080 TPU frame among them) and on an image
written with every PNG filter type; and `tpu_default_matmuls`, which
rounds the port's f32 matmul operands to bf16 while it is active and
puts torch back as it was."""

import struct
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from datum_tpu_torch.examples.common import read_png

PIL_Image = pytest.importorskip("PIL.Image")

GOLDENS = ("datumtest_1080_tpu.png", "stress.png", "datumtest.png", "megakernel.png")


@pytest.mark.parametrize("name", GOLDENS)
def test_read_png_rgb_matches_pil_on_the_goldens(name):
    path = f"tests/golden/{name}"
    img = read_png(path)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    assert np.array_equal(img, np.asarray(PIL_Image.open(path).convert("RGB")))


def _png_with_filters(img, filters):
    """The bytes of an 8-bit RGB PNG of img (h, w, 3) u8 whose row y is
    filtered with filters[y] (0 none, 1 sub, 2 up, 3 average, 4 Paeth)."""
    h, w, _ = img.shape
    x = img.astype(np.int32).reshape(h, 3 * w)
    left = np.concatenate([np.zeros((h, 3), np.int32), x[:, :-3]], 1)
    up = np.concatenate([np.zeros((1, 3 * w), np.int32), x[:-1]], 0)
    upleft = np.concatenate([np.zeros((h, 3), np.int32), up[:, :-3]], 1)
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = [np.zeros_like(x), left, up, (left + up) // 2, paeth]
    rows = [bytes([f]) + ((x[y] - preds[f][y]) & 255).astype(np.uint8).tobytes()
            for y, f in enumerate(filters)]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_read_png_rgb_every_filter(tmp_path):
    """Random pixels and smooth gradients under rows of each filter type
    in turn: the decoder and PIL both give the image back."""
    rng = np.random.RandomState(0)
    h, w = 37, 29
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img[h // 2:] = (np.arange(w)[None, :, None] * 9 + np.arange(h - h // 2)[:, None, None]
                    * 5 + np.array([0, 80, 160])).astype(np.uint8)
    path = tmp_path / "filters.png"
    path.write_bytes(_png_with_filters(img, [y % 5 for y in range(h)]))
    assert np.array_equal(read_png(str(path)), img)
    assert np.array_equal(np.asarray(PIL_Image.open(path).convert("RGB")), img)


def test_tpu_default_matmuls_rounds_f32_operands_to_bf16():
    """Inside the block torch.matmul, torch.einsum and @ give the exact
    f32 product of the bf16-rounded operands (f64 products of bf16
    values sum exactly here); outside, torch is as it was."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((5, 7), generator=g) + 1.0
    b = torch.rand((7, 3), generator=g) + 1.0
    rounded = (a.to(torch.bfloat16).double() @ b.to(torch.bfloat16).double()).float()
    exact = a @ b
    assert not torch.equal(exact, rounded)
    saved = torch.matmul, torch.einsum, torch.Tensor.__matmul__
    with chip_smoke.tpu_default_matmuls():
        for out in (a @ b, torch.matmul(a, b), torch.einsum("ij,jk->ik", a, b),
                    torch.einsum("ij,jk->ik", [a, b])):
            torch.testing.assert_close(out, rounded, atol=1e-6, rtol=1e-6)
        ints = torch.ones((2, 2), dtype=torch.int64)
        assert torch.equal(ints @ ints, torch.full((2, 2), 2))
    assert (torch.matmul, torch.einsum, torch.Tensor.__matmul__) == saved
    assert torch.equal(a @ b, exact)
