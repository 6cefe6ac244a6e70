"""Screen-space reflections, direction-binned dense march (counterpart
of datum_tpu/ops/ssr2.py).

Each pixel's screen-space reflection direction is quantised to K_BINS
bins; for bin k and step s the sample sits at a uniform image offset (a
static slice of one padded plane), and because 1/z is linear in screen
distance the depth test against the shifted plane is element-wise.  The
JAX package walks the 8 bins x 12 steps as 96 sequential steps; here
each bin's 12 steps are one batched tensor: `prev_above` is a running
AND along the steps (torch.cumprod of the step's test), and the first
step that crosses is the hit (the first True along the steps), which
takes the same decisions.  Plain PyTorch: the JAX package has no Pallas
kernel for this pass.
"""

from __future__ import annotations

import numpy as np
import torch

from . import brdf
from .common import constant, shifted_taps, texel_index
from .lighting_pass import _inv_proj

K_BINS = 8
STEPS = (2, 4, 7, 11, 16, 23, 32, 44, 60, 80, 104, 134)   # pixels (input res)
THICKNESS = 1.5         # acceptance band in 1/z units scaled by gradient


def ssr_binned(hdr_color, depth, normal_enc, spec_rgb, roughness, mask,
               proj, view, envbrdf_lut=None):
    """hdr_color (H, W, 3); depth (H, W) reverse-Z; normal_enc (H, W, 3)
    world normals * 0.5 + 0.5; spec_rgb (H, W, 3) and roughness (H, W)
    per pixel; mask (H, W) bool coverage.  Returns (H, W, 4): rgb
    premultiplied by the env-BRDF weight, a = strength."""
    h, w = depth.shape
    dev = depth.device
    invp = _inv_proj(proj)
    yn = ((torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2.0 - 1.0)[:, None]
    xn = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2.0 - 1.0)[None, :]
    denom = depth + proj[2, 2]
    denom = torch.where(torch.abs(denom) < 1e-7, torch.full_like(denom, 1e-7), denom)
    dist = proj[2, 3] / denom
    pos = torch.stack([invp[0, 0] * xn * dist, invp[1, 1] * yn * dist, -dist], -1)

    normal = (normal_enc * 2.0 - 1.0) @ view[:3, :3].T
    eyevec = brdf.normalize(-pos)
    refl = brdf.normalize(pos - 2.0 * (pos * normal).sum(-1, keepdim=True) * normal)
    # march only plausibly reflective pixels (the reference's fade criteria)
    active = (roughness < 0.4) & mask & (refl[..., 2] < -0.02)

    def to_screen(p):
        zc = torch.clamp(-p[..., 2], min=1e-6)
        return ((proj[0, 0] * p[..., 0] / zc * 0.5 + 0.5) * w,
                (proj[1, 1] * p[..., 1] / zc * 0.5 + 0.5) * h)

    p1 = pos + refl * 0.25
    sx0, sy0 = to_screen(pos)
    sx1, sy1 = to_screen(p1)
    ddx, ddy = sx1 - sx0, sy1 - sy0
    dlen = torch.sqrt(torch.clamp(ddx * ddx + ddy * ddy, min=1e-12))
    # a reflection collinear with the view ray cannot be marched on screen
    active = active & (dlen > 1e-3)
    ux, uy = ddx / dlen, ddy / dlen
    # 1/z gradient per unit of screen distance
    iz0 = 1.0 / torch.clamp(-pos[..., 2], min=1e-6)
    iz1 = 1.0 / torch.clamp(-p1[..., 2], min=1e-6)
    g = (iz1 - iz0) / dlen

    ang = torch.atan2(uy, ux)
    binf = torch.remainder(ang / (2.0 * np.pi) * K_BINS + 0.5, K_BINS)
    bin_id = torch.floor(binf).to(torch.int32)

    M = int(STEPS[-1])
    izp = torch.nn.functional.pad(iz0, (M, M, M, M))
    dp = torch.nn.functional.pad(depth, (M, M, M, M))
    cp = torch.nn.functional.pad(hdr_color.permute(2, 0, 1), (M, M, M, M))
    ii = torch.arange(h, device=dev)[:, None]
    jj = torch.arange(w, device=dev)[None, :]
    r_f = constant(STEPS, torch.float32, dev)[:, None, None]
    # the ray's 1/z and the acceptance band at every step (S, h, w)
    ray_iz = iz0 + g * r_f
    band = THICKNESS * (torch.abs(g) * r_f + 2e-3)

    hit = torch.zeros((h, w), dtype=torch.bool, device=dev)
    hit_color = torch.zeros((3, h, w), dtype=torch.float32, device=dev)
    hit_r = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for k in range(K_BINS):
        a = 2.0 * np.pi * k / K_BINS
        offs = tuple((int(round(np.sin(a) * r)), int(round(np.cos(a) * r))) for r in STEPS)
        sc_iz = torch.stack([izp[M + dy:M + dy + h, M + dx:M + dx + w] for dy, dx in offs])
        sc_d = torch.stack([dp[M + dy:M + dy + h, M + dx:M + dx + w] for dy, dx in offs])
        offs_t, inb = shifted_taps(offs, h, w, dev)
        below = sc_iz - band
        above = ray_iz > below
        # prev_above before each step: the AND of the earlier steps' tests
        prev_above = torch.cat([torch.ones_like(above[:1]),
                                torch.cumprod(above[:-1].to(torch.uint8), 0).bool()])
        crossed = (ray_iz <= sc_iz) & (ray_iz >= below) & (sc_d > 0) & inb & prev_above
        first = crossed.to(torch.uint8).argmax(0)            # first crossing step
        newhit = (bin_id == k) & crossed.any(0)
        yy = ii + offs_t[first, 0] + M
        xx = jj + offs_t[first, 1] + M
        hit_color = torch.where(newhit, cp[:, yy, xx], hit_color)
        hit_r = torch.where(newhit, r_f[:, 0, 0][first], hit_r)
        hit = hit | newhit

    # fades (the reference's ssr.comp criteria, adapted)
    maxr = float(STEPS[-1])
    distancefade = 1.0 - torch.clamp(hit_r / maxr, max=1.0)
    roughnessfade = 1.0 - torch.clamp(2.5 * roughness, max=1.0)
    anglefade = torch.clamp(-refl[..., 2] * 10.0, 0.0, 1.0)
    # screen-edge fade at the hit position
    hx = torch.clamp((jj + 0.5) / w + ux * hit_r / w, 0.0, 1.0)
    hy = torch.clamp((ii + 0.5) / h + uy * hit_r / h, 0.0, 1.0)
    edgefade = 1.0 - 10.0 * torch.clamp(
        torch.maximum(torch.abs(hx - 0.5), torch.abs(hy - 0.5)) - 0.4, 0.0, 0.1)

    ndv = torch.clamp((normal * eyevec).sum(-1), 0.0, 1.0)
    if envbrdf_lut is not None:
        s = envbrdf_lut.shape[0]
        flat = envbrdf_lut.reshape(-1, envbrdf_lut.shape[-1])
        bi = texel_index(roughness * (s - 1), s)
        bj = texel_index(ndv * (s - 1), s)
        eb = flat[(bi * s + bj).long()]
        weight = eb[..., 0:1] * spec_rgb + eb[..., 1:2]
    else:
        weight = spec_rgb

    fade = (distancefade * roughnessfade * anglefade * edgefade
            * hit.to(torch.float32) * active.to(torch.float32))
    rgb = hit_color.permute(1, 2, 0) * weight
    return torch.cat([rgb, torch.clamp(fade, 0, 1)[..., None]], -1)
