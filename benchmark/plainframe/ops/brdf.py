"""PBR BRDF and light evaluators (counterpart of datum_tpu/ops/brdf.py).

Fresnel-Schlick, Smith visibility, the GGX distribution, Disney diffuse
and the main/point/spot/environment light evaluators of the deferred
(XLA) lighting pass, plus the SH-9 irradiance evaluation.  Every
function broadcasts over leading pixel dims; vectors are (..., 3).  K2
(ops/shade_cuda.py) carries its own copy of the same terms.
"""

from __future__ import annotations

import torch

PI = 3.14159265358979


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def vdot(a, b):
    return (a * b).sum(-1, keepdim=True)


def normalize(v, eps=1e-12):
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))


def make_material(albedo, emissive, metalness, reflectivity, roughness):
    """Material derivation: albedo (..., 3), the scalars (...,) or ().
    Returns dict(diffuse (..., 3), specular (..., 3), emissive,
    roughness, alpha)."""
    e = torch.as_tensor(emissive)
    metalness = torch.as_tensor(metalness)
    reflectivity = torch.as_tensor(reflectivity)
    diffuse = albedo * (1.0 - metalness[..., None])
    spec0 = (0.16 * reflectivity * reflectivity)[..., None]
    specular = spec0 + (albedo - spec0) * metalness[..., None]
    return dict(diffuse=diffuse, specular=specular, emissive=128.0 * e * e * e,
                roughness=roughness, alpha=roughness * roughness)


def fresnel_schlick(f0, f90, u):
    x = saturate(1.0 - u)
    x2 = x * x
    return f0 + (f90 - f0) * (x2 * x2 * x)


def visibility_smith(ndv, ndl, alpha):
    k = alpha / 2.0
    ggx_l = ndl * (1 - k) + k
    ggx_v = ndv * (1 - k) + k
    return 0.25 / (ggx_v * ggx_l + 1e-5)


def distribution_ggx(ndh, alpha):
    alpha2 = alpha * alpha
    f = (ndh * alpha2 - ndh) * ndh + 1.0
    return alpha2 / (f * f)


def diffuse_disney(ndv, ndl, ldh, alpha):
    energy_factor = 1.0 + alpha * (1.0 / 1.51 - 1.0)
    f90 = 0.5 * alpha + 2.0 * ldh * ldh * alpha
    return (fresnel_schlick(1.0, f90, ndl) * fresnel_schlick(1.0, f90, ndv)
            * energy_factor)


def specular_ggx(f0, f90, ndv, ndl, ldh, ndh, alpha):
    fc = fresnel_schlick(f0, f90, ldh[..., None])
    return (distribution_ggx(ndh, alpha) * visibility_smith(ndv, ndl, alpha))[..., None] * fc


def _angles(normal, eyevec, lightvec):
    halfvec = normalize(lightvec + eyevec)
    ndv = torch.clamp(vdot(normal, eyevec)[..., 0], min=0.0)
    ndl = torch.clamp(vdot(normal, lightvec)[..., 0], min=0.0)
    ndh = torch.clamp(vdot(normal, halfvec)[..., 0], min=0.0)
    ldh = saturate(vdot(lightvec, halfvec)[..., 0])
    return ndv, ndl, ndh, ldh


def _lobes(normal, eyevec, lightvec, material):
    """(ndl, Disney diffuse / pi, GGX specular / pi)."""
    ndv, ndl, ndh, ldh = _angles(normal, eyevec, lightvec)
    alpha = material["alpha"]
    fd = diffuse_disney(ndv, ndl, ldh, alpha) * (1.0 / PI)
    fr = specular_ggx(material["specular"], 1.0, ndv, ndl, ldh, ndh, alpha) * (1.0 / PI)
    return ndl, fd, fr


def main_light(normal, eyevec, material, direction, intensity, cutoff, shadowfactor):
    """The directional sun with the roughness-bent light vector: (diffuse,
    specular) (..., 3)."""
    r = 2.0 * vdot(normal, eyevec) * normal - eyevec
    ldr = vdot(-direction, r)[..., 0]
    bent = -direction + (r + direction) * material["roughness"][..., None]
    lightvec = normalize(torch.where((ldr < cutoff)[..., None], -direction, bent))
    ndl, fd, fr = _lobes(normal, eyevec, lightvec, material)
    w = (ndl * shadowfactor)[..., None]
    return w * fd[..., None] * intensity, w * fr * intensity


def _distance_falloff(position, light_pos, attenuation):
    """(lightvec, the distance attenuation without the N.L sign)."""
    tolight = light_pos - position
    dist = torch.sqrt(torch.clamp((tolight * tolight).sum(-1), min=1e-12))
    # the guard keeps padded all-zero light rows finite (1/0 * 0 = NaN)
    att = 1.0 / torch.clamp(attenuation[..., 2] + attenuation[..., 1] * dist
                            + attenuation[..., 0] * dist * dist, min=1e-9)
    dr = dist / torch.clamp(attenuation[..., 3], min=1e-6)
    dr2 = dr * dr
    falloff = saturate(1.0 - dr2 * dr2)
    return tolight / dist[..., None], att, falloff


def point_light(position, normal, eyevec, material, light_pos, intensity, attenuation):
    """Point light; attenuation (..., 4) [quadratic, linear, constant,
    range]."""
    lightvec, att, falloff = _distance_falloff(position, light_pos, attenuation)
    ndl, fd, fr = _lobes(normal, eyevec, lightvec, material)
    att = torch.sign(ndl) * att * falloff * falloff
    w = (ndl * att)[..., None]
    return w * fd[..., None] * intensity, w * fr * intensity


def spot_light(position, normal, eyevec, material, light_pos, intensity, attenuation,
               direction, cutoff, shadowfactor):
    """Spot light with a smooth cone edge."""
    lightvec, att, falloff = _distance_falloff(position, light_pos, attenuation)
    ndl, fd, fr = _lobes(normal, eyevec, lightvec, material)
    att = torch.sign(ndl) * att * falloff * falloff
    cone = vdot(direction, -lightvec)[..., 0]
    att = att * torch.clamp((cone - cutoff) / 0.05, 0.0, 1.0)
    w = (ndl * att * shadowfactor)[..., None]
    return w * fd[..., None] * intensity, w * fr * intensity


def specular_dominant_direction(n, r, roughness):
    """Roughness-bent reflection lookup direction (n, r (..., 3);
    roughness (...,))."""
    smooth = 1.0 - roughness
    f = smooth * (torch.sqrt(smooth) + roughness)
    return n + (r - n) * f[..., None]


def diffuse_dominant_direction(n, v, roughness):
    """The diffuse lookup direction bent toward the view (not unit)."""
    a = 1.02341 * roughness - 1.51174
    b = -0.511705 * roughness + 0.755868
    f = torch.clamp(((n * v).sum(-1) * a + b) * roughness, 0.0, 1.0)
    return n + (v - n) * f[..., None]


def env_light(material, envdiffuse, envspecular, envbrdf, ambientintensity):
    """The split-sum IBL apply: (diffuse, specular)."""
    f90 = 0.8
    amb = ambientintensity[..., None]
    diffuse = envdiffuse * envbrdf[..., 2:3] * amb
    specular = envspecular * (material["specular"] * envbrdf[..., 0:1]
                              + f90 * envbrdf[..., 1:2]) * amb
    return diffuse, specular


def probe_irradiance(sh, normal):
    """9-coefficient SH irradiance: sh (..., 9, 3); normal (..., 3)."""
    x, y, z = normal[..., 0], normal[..., 1], normal[..., 2]
    basis = torch.stack([
        torch.full_like(x, PI * 0.282095),
        2.094395 * 0.488603 * y,
        2.094395 * 0.488603 * z,
        2.094395 * 0.488603 * x,
        0.785398 * 1.092548 * x * y,
        0.785398 * 1.092548 * y * z,
        0.785398 * 0.315392 * (3 * z * z - 1),
        0.785398 * 1.092548 * z * x,
        0.785398 * 0.546274 * (x * x - y * y),
    ], dim=-1)
    return torch.clamp((basis[..., None] * sh).sum(-2), min=0.0)
