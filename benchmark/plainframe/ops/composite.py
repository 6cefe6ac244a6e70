"""Tonemap + color grade + final composite (counterpart of
datum_tpu/ops/composite.py).  Plain element-wise torch: the numerics
follow the reference post chain (SSR add, DoF mix, bloom add, uncharted2
filmic with 2x pre-exposure and white point 11.2, the 3D-LUT grade —
exact trilinear or its polynomial fit — and the sRGB encode)."""

from __future__ import annotations

import numpy as np
import torch

from .common import srgb_encode


def filmic_uncharted2(color):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    x = torch.clamp(color, min=0.0)
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def _filmic_white(x=11.2):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


_WHITE = _filmic_white()


def tonemap(color):
    """Default tonemap (reference: camera.inc tonemap)."""
    return filmic_uncharted2(2.0 * color) * (1.0 / _WHITE)


def color_grade(lut, color):
    """Exact 3D-LUT grade with trilinear sampling.  lut (S, S, S, 3)
    indexed [b, g, r]; color (..., 3) in [0, 1]."""
    s = lut.shape[0]
    c = torch.clamp(color, 0.0, 1.0) * (s - 1)
    c0 = torch.floor(c).to(torch.int64)
    c1 = torch.clamp(c0 + 1, max=s - 1)
    f = c - c0
    r0, g0, b0 = c0.unbind(-1)
    r1, g1, b1 = c1.unbind(-1)
    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]

    def L(b, g, r):
        return lut[b, g, r]

    c00 = L(b0, g0, r0) * (1 - fr) + L(b0, g0, r1) * fr
    c01 = L(b0, g1, r0) * (1 - fr) + L(b0, g1, r1) * fr
    c10 = L(b1, g0, r0) * (1 - fr) + L(b1, g0, r1) * fr
    c11 = L(b1, g1, r0) * (1 - fr) + L(b1, g1, r1) * fr
    c0_ = c00 * (1 - fg) + c01 * fg
    c1_ = c10 * (1 - fg) + c11 * fg
    return c0_ * (1 - fb) + c1_ * fb


def _poly_terms(degree):
    """Monomial exponent triples (i, j, k) with i+j+k <= degree."""
    return [(i, j, k) for i in range(degree + 1)
            for j in range(degree + 1 - i)
            for k in range(degree + 1 - i - j)]


def fit_lut_poly(lut, degree=4):
    """Least-squares polynomial fit of a [b, g, r]-indexed 3D grading LUT
    (host numpy, the JAX package's fit).  Returns (coeffs (T, 3) f32,
    max_abs_err)."""
    lut = np.asarray(lut, np.float32)
    s = lut.shape[0]
    g = np.linspace(0.0, 1.0, s, dtype=np.float32)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")     # lut is [b, g, r]
    terms = _poly_terms(degree)
    A = np.stack([(r ** i) * (gg ** j) * (b ** k)
                  for (i, j, k) in terms], -1).reshape(-1, len(terms))
    y = lut.reshape(-1, 3)
    coeffs, *_ = np.linalg.lstsq(A, y, rcond=None)
    err = float(np.abs(A @ coeffs - y).max())
    return coeffs.astype(np.float32), err


def color_grade_poly(coeffs, color):
    """Polynomial grading transfer (see fit_lut_poly); color in [0,1]
    (..., 3), coeffs (T, 3) tensor; the degree follows from T."""
    degree = 1
    while len(_poly_terms(degree)) != coeffs.shape[0]:
        degree += 1
        if degree > 8:
            raise ValueError("coeffs length matches no degree <= 8")
    c = torch.clamp(color, 0.0, 1.0)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    rp = [torch.ones_like(r), r]
    gp = [torch.ones_like(g), g]
    bp = [torch.ones_like(b), b]
    for _ in range(degree - 1):
        rp.append(rp[-1] * r)
        gp.append(gp[-1] * g)
        bp.append(bp[-1] * b)
    out = [torch.zeros_like(r) for _ in range(3)]
    for t, (i, j, k) in enumerate(_poly_terms(degree)):
        m = rp[i] * gp[j] * bp[k]
        for ch in range(3):
            out[ch] = out[ch] + coeffs[t, ch] * m
    return torch.clamp(torch.stack(out, -1), 0.0, 1.0)


def composite(hdr, exposure, *, bloom=None, bloom_strength=0.0, ssr=None,
              dof_blur=None, dof_amount=None, lut=None, lut_poly=None,
              glow=None):
    """Combine HDR color and the effects, tonemap, grade -> sRGB display
    RGB in [0, 1], in the reference composite pass's order: SSR add
    (ssr (H, W, 4): rgb * a), DoF mix, bloom add, exposure, tonemap, LUT
    grade (the polynomial when given, else the exact trilinear lut).

    glow: the pre-combined additive term (SSR * weight + bloom summed at
    quarter resolution, one shared upsample), valid only with DoF off,
    where the two adds commute."""
    color = hdr
    if glow is not None:
        color = color + glow
    if ssr is not None:
        color = color + ssr[..., :3] * ssr[..., 3:4]
    if dof_blur is not None and dof_amount is not None:
        color = color + (dof_blur - color) * dof_amount[..., None]
    if bloom is not None:
        color = color + bloom * bloom_strength
    color = tonemap(color * exposure)
    if lut_poly is not None:
        color = color_grade_poly(lut_poly, color)
    elif lut is not None:
        color = color_grade(lut, color)
    return srgb_encode(color)


def to_u8_image(rgb):
    return torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
