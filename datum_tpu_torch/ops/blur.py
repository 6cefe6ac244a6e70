"""Box downsamples, cumsum box-gaussian, the shifted-add gaussian and
static-matrix upsamples (counterpart of datum_tpu/ops/blur.py, the
subset the port runs).  The numpy matrix builders `_up2_matrix`, `_updense_matrix` and
`_resample_matrix` are copied verbatim: the weights are the contract,
and the JAX module cannot be imported where jax is absent.

The upsamples are two plain f32 matmuls (torch.matmul, TF32 off on the
card — see render.frame.render_frame)."""

from __future__ import annotations

import numpy as np
import torch

from .common import device_cached


def downsample_pool(img, p: int, reduce="mean"):
    """p x p box downsample of (H, W) or (H, W, C).

    reduce: 'mean' | 'first' (the top-left texel of each cell, for id
    planes).  The mean sums the window in row-major order, as the JAX
    reduce_window does."""
    if p <= 1:
        return img
    h, w = img.shape[:2]
    img = img[:h - h % p, :w - w % p]
    if reduce == "first":
        return img[::p, ::p]
    if reduce != "mean":
        raise ValueError(f"unknown reduce {reduce!r}")
    acc = None
    for dy in range(p):
        for dx in range(p):
            t = img[dy::p, dx::p]
            acc = t if acc is None else acc + t
    return acc / (p * p)


def downsample2(img):
    """2x box downsample (for half-res effect chains)."""
    return downsample_pool(img, 2)


def box_blur_1d(img, r: int, axis: int):
    """O(1)-per-radius box blur via cumulative sums (edge-clamped), on
    (H, W) or (H, W, C) along axis 0 or 1."""
    if r <= 0:
        return img
    n = img.shape[axis]
    first = img.narrow(axis, 0, 1)
    last = img.narrow(axis, n - 1, 1)
    x = torch.cat([first.repeat_interleave(r + 1, axis), img,
                   last.repeat_interleave(r, axis)], dim=axis)
    c = torch.cumsum(x, dim=axis)
    hi = c.narrow(axis, 2 * r + 1, n)
    lo = c.narrow(axis, 0, n)
    return (hi - lo) / (2 * r + 1)


def gaussian_blur(img, sigma: float):
    """Gaussian approximated by 3 box-blur passes with mixed radii whose
    total variance is closest to sigma^2 (the JAX package's rule)."""
    r = max(int((np.sqrt(1.0 + 4.0 * sigma * sigma) - 1.0) / 2.0), 1)
    target = 3.0 * sigma * sigma
    best_k = min(range(4), key=lambda k: abs(
        (3 - k) * r * (r + 1) + k * (r + 1) * (r + 2) - target))
    out = img
    for i in range(3):
        ri = r + 1 if i < best_k else r
        out = box_blur_1d(box_blur_1d(out, ri, 1), ri, 0)
    return out


def gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def shifted_gaussian_blur(img, sigma: float, radius: int = 3):
    """Separable gaussian of (H, W) or (H, W, C) as explicit shifted adds
    (edge-clamped), rows first, taps summed left to right as in the JAX
    package.  Cancellation-free, unlike the cumsum box chain: the ESM
    maps it blurs reach e^20."""
    k = gaussian_kernel(sigma, radius)
    for axis in (0, 1):
        n = img.shape[axis]
        x = torch.cat([img.narrow(axis, 0, 1).repeat_interleave(radius, axis),
                       img,
                       img.narrow(axis, n - 1, 1).repeat_interleave(radius, axis)],
                      dim=axis)
        acc = None
        for j in range(2 * radius + 1):
            term = x.narrow(axis, j, n) * float(k[j])
            acc = term if acc is None else acc + term
        img = acc
    return img


def _up2_matrix(n: int) -> np.ndarray:
    """(n, 2n) matrix of the half-pixel 2x upsample weights."""
    m = np.zeros((n, 2 * n), np.float32)
    i = np.arange(n)
    m[i, 2 * i] += 0.75
    m[np.maximum(i - 1, 0), 2 * i] += 0.25
    m[i, 2 * i + 1] += 0.75
    m[np.minimum(i + 1, n - 1), 2 * i + 1] += 0.25
    return m


def _updense_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) matrix composing iterated-2x rounds (the exact
    weights of the old upsample2_dense chain) plus a final bilinear for
    any non-pow2 remainder (what jax.image.resize 'linear' computed)."""
    m = np.eye(n_in, dtype=np.float32)
    n = n_in
    while n * 2 <= n_out:
        m = m @ _up2_matrix(n)
        n *= 2
    if n != n_out:
        m = m @ _resample_matrix(n, n_out)
    return m


def _resample_matrix(n_in: int, n_out: int, nearest: bool = False):
    """(n_in, n_out) static interpolation matrix: out = in @ M.  Pixel
    centers of both grids span the same NDC range (align_corners=False);
    bilinear weights, or one-hot rows for nearest.  Resampling as a
    matmul keeps arbitrary-ratio resizes on the MXU with zero gathers."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = np.clip(src - np.floor(src), 0.0, 1.0)
    f = np.where(src < 0, 0.0, np.where(src > n_in - 1, 1.0, f))
    m = np.zeros((n_in, n_out), np.float32)
    if nearest:
        nn = np.where(f < 0.5, i0, i1)
        m[nn, np.arange(n_out)] = 1.0
    else:
        m[i0, np.arange(n_out)] += (1.0 - f).astype(np.float32)
        m[i1, np.arange(n_out)] += f.astype(np.float32)
    return m


def _nearest_matrix(n_in: int, n_out: int):
    return _resample_matrix(n_in, n_out, nearest=True)


@device_cached(maxsize=64)
def _matrix(build, n_in, n_out, transpose, device, dtype):
    """A static resample matrix as a tensor, built once per shape and
    device: the eager frame would otherwise rebuild (and re-upload) the
    same numpy matrices every frame.  Callers only read it."""
    m = build(n_in, n_out)
    m = np.ascontiguousarray(m.T if transpose else m)
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def resize_up_dense(img, out_h, out_w):
    """Upsample (h, w) or (h, w, c) to (out_h, out_w) with iterated-2x
    half-pixel weights, as two static-matrix products."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    my = _matrix(_updense_matrix, h, out_h, True, img.device, img.dtype)
    mx = _matrix(_updense_matrix, w, out_w, False, img.device, img.dtype)
    if img.ndim == 2:
        return (my @ img) @ mx
    out = torch.einsum("Oh,hwc->Owc", my, img)
    return torch.einsum("Owc,wW->OWc", out, mx)


def resize_up_dense_batch(stack, out_h, out_w):
    """Bilinear resample of a channel-first (N, h, w) stack to
    (N, out_h, out_w) as two static-matrix products."""
    h, w = stack.shape[1], stack.shape[2]
    if (h, w) == (out_h, out_w):
        return stack
    my = _matrix(_resample_matrix, h, out_h, True, stack.device, stack.dtype)
    mx = _matrix(_resample_matrix, w, out_w, False, stack.device, stack.dtype)
    out = torch.matmul(my, stack)                           # (N, O, w)
    return torch.matmul(out, mx)                            # (N, O, W)


def resize_matmul(img, out_h, out_w, nearest: bool = False):
    """Dense (h, w) or (h, w, c) -> (out_h, out_w[, c]) resample as two
    static-matrix products (bilinear, or nearest with one-hot rows); any
    up or down ratio per axis."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    build = _nearest_matrix if nearest else _resample_matrix
    my = _matrix(build, h, out_h, True, img.device, img.dtype)
    mx = _matrix(build, w, out_w, False, img.device, img.dtype)
    if img.ndim == 2:
        return (my @ img) @ mx
    out = torch.einsum("Oh,hwc->Owc", my, img)
    return torch.einsum("Owc,wW->OWc", out, mx)
