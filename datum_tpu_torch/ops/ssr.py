"""Screen-space reflections: the dense fixed-step DDA march
(counterpart of datum_tpu/ops/ssr.py, `ssr_mode="dda"`).

Every pixel marches the same way: COARSE_STEPS fixed steps along its
view-space reflection ray (roughness-bent) to MAX_DISTANCE, tapping the
depth plane at each projected step; the first step that crosses the
surface within a thickness is refined by REFINE_STEPS bisections, and
the hit colour is weighted by the env-BRDF and faded at the screen
edge, the far plane, with distance, angle and roughness.  Plain PyTorch
on every device: the JAX package runs it in XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from . import brdf
from .common import constant, texel_index
from .lighting_pass import _inv_proj

MAX_DISTANCE = 24.0
THICKNESS = 0.1
COARSE_STEPS = 48
REFINE_STEPS = 6


def _march_ts(n=COARSE_STEPS):
    """The march's step parameters, linspace(1/n, 1, n) in f32 as the
    JAX package's XLA evaluates it on the CPU:
    fma(i, 1/(n-1), (1/n) * (1 - i/(n-1))) with i/(n-1) taken as i times
    the f32 reciprocal, the last one exactly 1."""
    f32 = np.float32
    i = np.arange(n - 1, dtype=f32)
    r = f32(1) / f32(n - 1)
    head = (np.float64(f32(1.0 / n) * (f32(1) - i * r))
            + np.float64(i) * np.float64(f32(1) * r)).astype(f32)
    return [float(t) for t in head] + [1.0]


def ssr(hdr_color, depth, gbuffer, proj, view, envbrdf_lut=None):
    """(H, W, 4): rgb the BRDF-weighted reflection colour, a its strength
    (the composite adds rgb * a).  gbuffer: dict(normal (H, W, 3+)
    encoded, specular (H, W, 4) rgb + roughness, mask (H, W) bool)."""
    h, w = depth.shape
    dev = depth.device
    invp = _inv_proj(proj)
    yn = ((torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2.0 - 1.0)[:, None]
    xn = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2.0 - 1.0)[None, :]
    dist = proj[2, 3] / (depth + proj[2, 2])
    position = torch.stack([invp[0, 0] * xn * dist, invp[1, 1] * yn * dist, -dist], -1)

    roughness = gbuffer["specular"][..., 3]
    specular = gbuffer["specular"][..., :3]
    normal = (gbuffer["normal"][..., :3] * 2.0 - 1.0) @ view[:3, :3].T

    eyevec = brdf.normalize(-position + constant((0.0, 0.5, 0.0), torch.float32, dev))
    refl = brdf.normalize(
        -eyevec - 2.0 * (-eyevec * normal).sum(-1, keepdim=True) * normal)
    direction = brdf.normalize(brdf.specular_dominant_direction(normal, refl, roughness))
    active = (depth > 1 - 0.998) & (roughness < 0.4) & gbuffer["mask"]
    end = position + direction * MAX_DISTANCE

    def to_screen(p):
        zc = -p[..., 2]
        return ((proj[0, 0] * p[..., 0] / zc * 0.5 + 0.5) * w,
                (proj[1, 1] * p[..., 1] / zc * 0.5 + 0.5) * h)

    def scene_z(px, py):
        d = depth[texel_index(py, h).long(), texel_index(px, w).long()]
        return proj[2, 3] / (d + proj[2, 2]), d

    hit_t = torch.full((h, w), 2.0, dtype=torch.float32, device=dev)   # > 1: miss
    prev_hit = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for t in _march_ts():
        p = position + (end - position) * t
        px, py = to_screen(p)
        ray_z = -p[..., 2]
        sz, sd = scene_z(px, py)
        crossed = ((ray_z >= sz) & (ray_z <= sz + THICKNESS * (1 + ray_z * 0.5))
                   & (sd > 0))
        hit_t = torch.where(crossed & ~prev_hit & (hit_t > 1.5),
                            torch.full_like(hit_t, t), hit_t)
        prev_hit = prev_hit | crossed
    hit = hit_t <= 1.0

    # bisection between the step before the first crossing and it
    lo = torch.clamp(hit_t - 1.0 / COARSE_STEPS, min=0.0)
    hi = hit_t
    for _ in range(REFINE_STEPS):
        mid = 0.5 * (lo + hi)
        p = position + (end - position) * mid[..., None]
        px, py = to_screen(p)
        above = -p[..., 2] < scene_z(px, py)[0]
        lo = torch.where(above, mid, lo)
        hi = torch.where(above, hi, mid)
    t_hit = 0.5 * (lo + hi)
    p_hit = position + (end - position) * t_hit[..., None]
    px, py = to_screen(p_hit)
    hitcolor = hdr_color[texel_index(py, h).long(), texel_index(px, w).long()]

    u, v = px / w, py / h
    edgefade = 1.0 - 10.0 * torch.clamp(
        torch.maximum(torch.abs(u - 0.5), torch.abs(v - 0.5)) - 0.4, 0.0, 0.1)
    depthfade = 1.0 - 1000.0 * torch.clamp((1.0 - depth) - 0.997, min=0.0)
    distancefade = 1.0 - torch.clamp(
        torch.linalg.norm(p_hit - position, dim=-1) / MAX_DISTANCE, max=1.0)
    anglefade = 10.0 * torch.clamp(-direction[..., 2], 0.0, 0.1)
    roughnessfade = 1.0 - torch.clamp(2.5 * roughness, max=1.0)

    ndv = torch.clamp((normal * eyevec).sum(-1), 0.0, 1.0)
    if envbrdf_lut is not None:
        s = envbrdf_lut.shape[0]
        eb = envbrdf_lut[texel_index(roughness * (s - 1), s).long(),
                         texel_index(ndv * (s - 1), s).long()]
        weight = eb[..., 0:1] * specular + eb[..., 1:2]
    else:
        weight = specular
    fade = (edgefade * depthfade * distancefade * anglefade * roughnessfade
            * hit.to(torch.float32) * active.to(torch.float32))
    # on the background (depth 0, at infinity) the fades are 0 * inf =
    # NaN; the JAX frame's jitted clip returns 0 there (XLA:CPU's min and
    # max do not propagate NaN), and so does the port
    fade = torch.clamp(torch.nan_to_num(fade, nan=0.0), 0, 1)
    return torch.cat([hitcolor * weight, fade[..., None]], -1)
