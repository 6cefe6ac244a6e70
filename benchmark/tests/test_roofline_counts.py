"""The benchmark's copy of the roofline arithmetic gives chip_smoke.py's
bounds on the same inputs."""

import chip_smoke as cs
import pytest
import torch

from framebench import roofline


def _raster_inputs(n_tiles=60, cap=160, big=64, width=1920, height=1088, seed=0):
    g = torch.Generator().manual_seed(seed)
    big_ids = torch.randint(-1, 500, (big,), generator=g, dtype=torch.int32)
    return dict(rows=torch.rand((4096, 24), generator=g),
                bins=torch.randint(0, 4096, (n_tiles, cap), generator=g, dtype=torch.int32),
                counts=torch.randint(0, cap + 1, (n_tiles,), generator=g, dtype=torch.int32),
                big_ids=big_ids, tiles_x=15, width=width, height=height, peel=None,
                szb=None, tile0=0)


def _shade_inputs(h=1088, w=1920, lights=(8, 1, 0, 0), clusters=False, ao=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    inp = dict(f32_planes=torch.rand((2, h, w), generator=g),
               planes=torch.rand((17, h, w), generator=g).to(torch.bfloat16),
               ao=torch.rand((h, w), generator=g).to(torch.bfloat16) if ao else None,
               spotsf=(torch.rand((lights[1], h, w), generator=g).to(torch.bfloat16)
                       if ao and lights[1] else None),
               counts=torch.tensor(lights, dtype=torch.int32),
               cl_lists=None, cl_counts=None)
    if clusters:
        inp["cl_lists"] = torch.randint(0, 128, (h // 16, w // 128, 64), generator=g,
                                        dtype=torch.int32)
        inp["cl_counts"] = torch.randint(0, 65, (h // 16, w // 128), generator=g,
                                         dtype=torch.int32)
    return inp


def _ms(b):
    return b[0] * 1e3, b[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1(seed):
    inp = _raster_inputs(seed=seed)
    px = inp["width"] * inp["height"]
    want = cs.bound(cs._nbytes(*(inp[k] for k in ("rows", "bins", "counts", "big_ids")))
                    + 22 * px * 4,
                    cs._walked(inp) * 4096 * cs.OPS_WALK_DEPTH + px * cs.OPS_K1_PIXEL)
    assert _ms(roofline.k1_bound(inp)) == pytest.approx(want, rel=1e-12)
    assert roofline.k1_bound(dict(inp, szb=torch.zeros(1))) is None


def test_k2_dense_and_lit_layer():
    inp = _shade_inputs()
    px = 1088 * 1920
    n = int(inp["counts"][0]) + int(inp["counts"][1])
    want = cs.bound(cs._nbytes(inp["f32_planes"], inp["planes"], inp["ao"], inp["spotsf"])
                    + 3 * px * 4, px * (cs.OPS_K2_PIXEL + cs.OPS_K2_LIGHT * n))
    assert _ms(roofline.k2_bound(inp)) == pytest.approx(want, rel=1e-12)
    lit = _shade_inputs(h=544, w=960, ao=False)
    lpx = 544 * 960
    want = cs.bound(cs._nbytes(lit["f32_planes"], lit["planes"]) + 3 * lpx * 4,
                    lpx * (cs.OPS_K2_PIXEL + cs.OPS_K2_LIGHT * n))
    assert _ms(roofline.k2_bound(lit)) == pytest.approx(want, rel=1e-12)


def test_k2_clustered():
    inp = _shade_inputs(lights=(128, 0, 0, 0), clusters=True, ao=False)
    px = 1088 * 1920
    walked = int(inp["cl_counts"].sum()) * 16 * 128
    want = cs.bound(cs._nbytes(inp["f32_planes"], inp["planes"], inp["ao"],
                               inp["cl_lists"], inp["cl_counts"]) + 3 * px * 4,
                    px * cs.OPS_K2_PIXEL + walked * cs.OPS_K2_LIGHT)
    assert _ms(roofline.k2_bound(inp)) == pytest.approx(want, rel=1e-12)


def test_peaks():
    assert (roofline.HBM_BYTES_PER_S, roofline.FP32_OPS_PER_S) == (cs.HBM_BYTES_PER_S,
                                                                   cs.FP32_OPS_PER_S)
