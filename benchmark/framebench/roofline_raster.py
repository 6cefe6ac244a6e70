"""The least time K5 and K4 could take on the card, from their inputs.

The deferred branch's rasters beside framebench.roofline's K1 and K2,
with its peaks, `walked` and `bound`: each input byte read once and each
output byte written once, and the FP32 operations these inputs need (an
fma counts 2), counted from the kernels' sources as chip_smoke.py counts
them (this is a copy of that arithmetic).
"""

from __future__ import annotations

from .roofline import TILE_PIXELS, bound, nbytes, walked

# FP32 operations per (pixel, walked entry) and per pixel: K5 walks K3's
# 4 planes + s, 18, and spends ~16 a pixel on the winner's barycentrics;
# K4 also takes the barycentrics, 4 (6 where soft) interpolations of 5,
# the soft falloff, the weight and the 5 accumulators, 80 an entry
OPS_WALK_K5, OPS_K5_PIXEL = 18, 16
OPS_WALK_BLEND = 80
K5_PLANES, K4_PLANES = 4, 5


def k5_bound(inp):
    """K5 (raster_v1) on raster_v1_inputs' dict: the triangle rows, bins
    and lists read, depth, the id and two barycentrics written; the walk
    and the barycentrics."""
    px = inp["width"] * inp["height"]
    return bound(nbytes(inp["rows"], inp["bins"], inp["counts"], inp["big_ids"])
                 + K5_PLANES * px * 4,
                 walked(inp) * TILE_PIXELS * OPS_WALK_K5 + px * OPS_K5_PIXEL)


def k4_bound(inp):
    """K4 (raster_blend) on blend_inputs' dict: the rows, bins, lists and
    the opaque depth read, the 5 f32 accumulation planes written; the
    walk."""
    px = inp["width"] * inp["height"]
    return bound(nbytes(inp["rows"], inp["bins"], inp["counts"], inp["big_ids"],
                        inp["opaque_depth"]) + K4_PLANES * px * 4,
                 walked(inp) * TILE_PIXELS * OPS_WALK_BLEND)
