"""The benchmark's copy of K5's and K4's roofline arithmetic
(framebench/roofline_raster.py) gives chip_smoke.py's bounds on the same
inputs."""

import chip_smoke as cs
import pytest
import torch

from framebench import roofline, roofline_raster


def _inputs(n_tiles=510, cap=160, big=64, width=1920, height=1088, seed=0):
    g = torch.Generator().manual_seed(seed)
    return dict(rows=torch.rand((4096, 16), generator=g),
                bins=torch.randint(0, 4096, (n_tiles, cap), generator=g, dtype=torch.int32),
                counts=torch.randint(0, cap + 1, (n_tiles,), generator=g, dtype=torch.int32),
                big_ids=torch.randint(-1, 500, (big,), generator=g, dtype=torch.int32),
                tiles_x=15, width=width, height=height)


def _ms(b):
    return b[0] * 1e3, b[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k5(seed):
    inp = _inputs(seed=seed)
    px = inp["width"] * inp["height"]
    want = cs.bound(cs._nbytes(*(inp[k] for k in ("rows", "bins", "counts", "big_ids")))
                    + 4 * px * 4,
                    cs._walked(inp) * 4096 * cs.OPS_WALK_K5 + px * cs.OPS_K5_PIXEL)
    assert _ms(roofline_raster.k5_bound(inp)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("seed,soft", [(0, False), (1, True), (2, True)])
def test_k4(seed, soft):
    g = torch.Generator().manual_seed(seed + 10)
    inp = dict(_inputs(cap=64, big=32, seed=seed),
               rows=torch.rand((1024, 40), generator=g),
               opaque_depth=torch.rand((1088, 1920), generator=g), soft=soft,
               peel=None, tile0=0)
    px = inp["width"] * inp["height"]
    want = cs.bound(cs._nbytes(*(inp[k] for k in ("rows", "bins", "counts", "big_ids",
                                                  "opaque_depth"))) + 5 * px * 4,
                    cs._walked(inp) * 4096 * cs.OPS_WALK_BLEND)
    assert _ms(roofline_raster.k4_bound(inp)) == pytest.approx(want, rel=1e-12)


def test_constants_and_shared_pieces():
    assert (roofline_raster.OPS_WALK_K5, roofline_raster.OPS_K5_PIXEL) == (
        cs.OPS_WALK_K5, cs.OPS_K5_PIXEL)
    assert roofline_raster.OPS_WALK_BLEND == cs.OPS_WALK_BLEND
    assert roofline_raster.bound is roofline.bound
    assert roofline_raster.walked is roofline.walked
