"""The least time K1 and K2 could take on the card, from their inputs.

The peaks are NVIDIA's data sheet for one H100 SXM at 700 W: 3.35 TB/s
of HBM and 67 TFLOP/s of FP32 outside the tensor cores.  A kernel's
bound is the larger of its bytes over the first and its FP32 operations
over the second: each input byte read once and each output byte written
once, and the operations these inputs need (an fma counts 2), counted
from the kernels' sources as chip_smoke.py counts them (this is a copy
of that arithmetic).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per (pixel, walked entry) and per pixel: a plane
# fma(a, xn, b*yn) + c is 4; K1 walks 4 planes + s; its epilogue
# evaluates ~22 planes and a divide; K2 spends ~200 a pixel on the
# surface, IBL and SH terms, ~60 a light and ~75 an SH probe
OPS_WALK_DEPTH = 18
OPS_K1_PIXEL = 110
OPS_K2_PIXEL, OPS_K2_LIGHT, OPS_K2_PROBE = 200, 60, 75
K1_PLANES = 22
TILE_PIXELS = 32 * 128
SHADE_ROWS, SUBTILE_W = 16, 128


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def walked(inp):
    """Valid entries a raster kernel walks, summed over tiles: the valid
    big-list entries for every tile plus each tile's bin count."""
    n_tiles = inp["bins"].shape[0]
    return int((inp["big_ids"] >= 0).sum()) * n_tiles + int(inp["counts"].sum())


def bound(n_bytes, n_ops):
    """(seconds, "bytes" | "operations"): the larger of the two least times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(inp):
    """K1 (raster_shade) on raster_inputs' dict: the triangle rows, bins
    and lists read, 22 f32 planes written; the walk and the epilogue.
    None with early-z, whose walk depends on the depth it writes."""
    if inp.get("szb") is not None:
        return None
    px = inp["width"] * inp["height"]
    return bound(nbytes(inp["rows"], inp["bins"], inp["counts"], inp["big_ids"])
                 + K1_PLANES * px * 4,
                 walked(inp) * TILE_PIXELS * OPS_WALK_DEPTH + px * OPS_K1_PIXEL)


def k2_bound(inp):
    """K2 (shade_deferred) on shade_inputs' dict: the planes, the AO and
    spot factors and the light lists read, the f32 hdr written; a
    pixel's terms, its lights (dense: every point and spot light;
    clustered: its sub-tile's list and every spot) and its SH probes."""
    _, h, w = inp["f32_planes"].shape
    px = h * w
    counts = [int(c) for c in inp["counts"].tolist()]
    n_bytes = nbytes(inp["f32_planes"], inp["planes"], inp.get("ao"), inp.get("spotsf"),
                     inp.get("cl_lists"), inp.get("cl_counts")) + 3 * px * 4
    if inp.get("cl_lists") is None:
        lights = px * (counts[0] + counts[1])
    else:
        lights = (int(inp["cl_counts"].sum()) * SHADE_ROWS * SUBTILE_W
                  + px * counts[1])
    return bound(n_bytes, px * OPS_K2_PIXEL + lights * OPS_K2_LIGHT
                 + px * counts[3] * OPS_K2_PROBE)
