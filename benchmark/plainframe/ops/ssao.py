"""HBAO — horizon-based ambient occlusion with a depth-weighted spatial
blur and temporal reprojection (counterpart of datum_tpu/ops/ssao.py).

Every ray walks a fixed pixel ladder (LADDER), so each tap is a static
slice of one padded position stack.  The JAX package writes the 8 rays x
7 steps as 56 sequential element-wise steps; here the 56 taps are one
batched tensor (56, H, W): the horizon `top` of each ray is a running
maximum (torch.cummax along the ladder), which is exact, and the 56
contributions are summed in one reduction, which differs from the
sequential sum in the last bits only.  Plain PyTorch: the JAX package
has no Pallas kernel for this pass.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import shifted_taps
from .lighting_pass import _inv_proj

RAYS = 8
STEPS = 4
STRENGTH = 0.1
FALLOFF = 3.0
BIAS = 0.03
BLUR_RADIUS = 2
LADDER = (1, 2, 3, 5, 8, 13, 21)     # fixed pixel radii per ray


def make_hbao_params(seed=0):
    """Noise (16, 3) + ray kernel (RAYS, 2), numpy, the JAX package's
    values for the same seed (the reference fills these from random
    vectors at init)."""
    rng = np.random.RandomState(seed)
    noise = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
    noise[:, :2] /= np.maximum(np.linalg.norm(noise[:, :2], axis=1, keepdims=True), 1e-6)
    noise[:, 2] = rng.uniform(0, 1, 16)
    angles = (np.arange(RAYS) + 0.5) / RAYS * 2 * np.pi
    kernel = np.stack([np.cos(angles), np.sin(angles)], -1).astype(np.float32)
    return dict(noise=noise, kernel=kernel)


def _ndc(n, dev):
    return (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n * 2.0 - 1.0


def _view_positions(depth, proj, width, height):
    """(H, W, 3) view-space positions of reverse-Z depth (background
    depth 0 guarded)."""
    h, w = depth.shape
    invp = _inv_proj(proj)
    yn = _ndc(height, depth.device)[:h, None]
    xn = _ndc(width, depth.device)[None, :w]
    dist = proj[2, 3] / torch.clamp(depth + proj[2, 2], min=1e-8)
    return torch.stack([invp[0, 0] * xn * dist, invp[1, 1] * yn * dist, -dist], -1)


def _view_positions_at(depth_vals, sx, sy, proj, width, height):
    invp = _inv_proj(proj)
    xn = (sx.to(torch.float32) + 0.5) / width * 2.0 - 1.0
    yn = (sy.to(torch.float32) + 0.5) / height * 2.0 - 1.0
    dist = proj[2, 3] / torch.clamp(depth_vals + proj[2, 2], min=1e-8)
    return torch.stack([invp[0, 0] * xn * dist, invp[1, 1] * yn * dist, -dist], -1)


def _taps(padded, offsets, m, h, w):
    """(len(offsets), h, w, ...) static slices of a plane padded by m."""
    return torch.stack([padded[m + dy:m + dy + h, m + dx:m + dx + w]
                        for dy, dx in offsets])


def hbao(depth, normal_enc, proj, view, *, params, prev_ao=None, prevview=None,
         invview=None):
    """depth (H, W) reverse-Z; normal_enc (H, W, 3) world normal * 0.5 +
    0.5.  Returns (H, W, 2): [ao, depth]; it is the next frame's prev_ao
    for the temporal pass (prevview = this frame's view)."""
    h, w = depth.shape
    dev = depth.device
    position = _view_positions(depth, proj, w, h)
    covered = depth > 0.0
    normal = (normal_enc * 2.0 - 1.0) @ view[:3, :3].T     # view-space normal

    kernel = np.asarray(params["kernel"])
    offsets = tuple((int(round(float(kernel[i, 1]) * r)), int(round(float(kernel[i, 0]) * r)))
                    for i in range(RAYS) for r in LADDER)   # (dy, dx), ray-major
    M = max(LADDER)
    pp = torch.nn.functional.pad(position.permute(2, 0, 1), (M, M, M, M))
    hv = _taps(pp.permute(1, 2, 0), offsets, M, h, w) - position   # (56, h, w, 3)
    hx, hy, hz = hv.unbind(-1)
    hlen = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-12))
    nx, ny, nz = normal.unbind(-1)
    inb = shifted_taps(offsets, h, w, dev)[1]
    # an out-of-bounds tap leaves the ray's horizon unchanged and adds 0
    occl = torch.where(inb, (nx * hx + ny * hy + nz * hz) / hlen,
                       torch.full_like(hlen, -torch.inf))
    n_steps = len(LADDER)
    occl = occl.reshape(RAYS, n_steps, h, w)
    top = torch.cummax(torch.cat([torch.full_like(occl[:, :1], BIAS), occl], 1),
                       dim=1).values[:, :-1]                # horizon before each step
    diff = torch.clamp(occl - top, min=0.0)
    dist = torch.clamp(hlen.reshape(RAYS, n_steps, h, w) / FALLOFF, max=1.0)
    occ_sum = (diff * (1.0 - dist * dist)).reshape(-1, h, w).sum(0)

    ao = 1.0 - torch.clamp(STRENGTH * occ_sum, max=1.0)
    ao = torch.where(covered, ao, torch.ones_like(ao))
    ao = _depth_weighted_blur(ao, depth, BLUR_RADIUS)

    if prev_ao is not None and prevview is not None and invview is not None:
        reproj = (position @ (prevview[:3, :3] @ invview[:3, :3]).T
                  + (prevview[:3, :3] @ invview[:3, 3] + prevview[:3, 3]))
        rz = torch.clamp(reproj[..., 2], max=-1e-6)
        px = 0.5 * (proj[0, 0] * reproj[..., 0] / -rz) + 0.5
        py = 0.5 * (proj[1, 1] * reproj[..., 1] / -rz) + 0.5
        sx = torch.clamp((px * w).to(torch.int32), 0, w - 1)
        sy = torch.clamp((py * h).to(torch.int32), 0, h - 1)
        prev = prev_ao[sy.long(), sx.long()]
        prevpos = _view_positions_at(prev[..., 1], sx, sy, proj, w, h)
        tw = torch.clamp(5.0 * torch.abs(prev[..., 0] - ao)
                         + 0.001 * torch.linalg.norm(prevpos - reproj, dim=-1),
                         0.1, 1.0)
        # newly revealed pixels (off-screen or behind the previous
        # camera) take the fresh AO
        onscreen = ((px >= 0.0) & (px < 1.0) & (py >= 0.0) & (py < 1.0)
                    & (reproj[..., 2] < -1e-6))
        tw = torch.where(onscreen, tw, torch.ones_like(tw))
        ao = torch.where(covered, prev[..., 0] + (ao - prev[..., 0]) * tw, ao)

    return torch.stack([ao, depth], -1)


def _depth_weighted_blur(ao, depth, radius):
    """Depth-weighted window blur over dy, dx in range(-radius, radius)
    (a 4x4 window for radius 2), edge-padded; background keeps its ao."""
    h, w = ao.shape
    offsets = [(dy, dx) for dy in range(-radius, radius)
               for dx in range(-radius, radius)]
    pad = lambda x: torch.nn.functional.pad(x[None, None], (radius,) * 4,
                                            mode="replicate")[0, 0]
    a = _taps(pad(ao), offsets, radius, h, w)
    d = _taps(pad(depth), offsets, radius, h, w)
    weight = torch.clamp(1.0 - 250.0 * torch.abs(d - depth), min=0.0)
    acc = (weight * a).sum(0)
    wsum = weight.sum(0)
    return torch.where(depth > 0, acc / torch.clamp(wsum, min=1e-6), ao)
