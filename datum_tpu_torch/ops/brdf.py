"""BRDF helpers (counterpart of datum_tpu/ops/brdf.py; outside the shade
kernel the port needs only these)."""

from __future__ import annotations

import torch


def normalize(v, eps=1e-12):
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))


def specular_dominant_direction(n, r, roughness):
    """Roughness-bent reflection lookup direction (n, r (..., 3);
    roughness (...,))."""
    smooth = 1.0 - roughness
    f = smooth * (torch.sqrt(smooth) + roughness)
    return n + (r - n) * f[..., None]
