"""Bloom: luma threshold + box-gaussian at quarter resolution
(counterpart of datum_tpu/ops/bloom.py)."""

from __future__ import annotations

import torch

from .blur import downsample2, gaussian_blur, resize_up_dense
from .common import constant
from .composite import tonemap

CUTOFF = 11.2
SIGMA = 8.0
RADIUS = 16


def bloom_seed(quarter):
    """Luma-thresholded, tonemapped bloom seed at reduced resolution."""
    w = constant((0.299, 0.587, 0.114), quarter.dtype, quarter.device)
    luma = quarter @ w
    t = torch.clamp(luma - CUTOFF, 0.0, 1.0)
    t = t * t * (3.0 - 2.0 * t)   # smoothstep(0,1, luma-cutoff)
    return tonemap(quarter * t[..., None])


def bloom(hdr, strength=1.0, upsample=True):
    """hdr (H, W, 3) -> blurred tonemapped overflow; upsample=False
    returns the quarter-res result for the caller to upsample."""
    return bloom_quarter(downsample2(downsample2(hdr)), strength, upsample)


def bloom_quarter(quarter, strength=1.0, upsample=True):
    """bloom from the quarter-res image (hdr downsampled twice); the
    tile-sharded frame gathers its bands' quarter-res rows into it."""
    blurred = gaussian_blur(bloom_seed(quarter), SIGMA * 0.5)
    if not upsample:
        return blurred * strength
    return resize_up_dense(blurred, quarter.shape[0] * 4,
                           quarter.shape[1] * 4) * strength
