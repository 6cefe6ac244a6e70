"""BRDF helpers (counterpart of datum_tpu/ops/brdf.py; the slice needs
only `normalize` outside the shade kernel)."""

from __future__ import annotations

import torch


def normalize(v, eps=1e-12):
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))
