"""Procedural skybox: single-scatter atmosphere (counterpart of
datum_tpu/ops/skybox_gen.py).

O'Neil-style Rayleigh/Mie single scattering with an inverse-wavelength
tint, the sun disc from a strong Mie forward lobe, a ground hemisphere
blend and an optional normal-lit cloud layer, evaluated densely over all
six faces."""

from __future__ import annotations

import numpy as np
import torch

from .ibl import cube_dirs
from .sampling import sample_image_bilinear

OUTER_R = 1.025
INNER_R = 1.0
CAMERA_HEIGHT = 0.0001
KR = 0.0025
KM = 0.0015
KR4PI = KR * 4.0 * 3.14159265
KM4PI = KM * 4.0 * 3.14159265
SCALE = 1.0 / (OUTER_R - INNER_R)
SCALE_DEPTH = 0.25
SAMPLES = 2


def _scale_fn(cosangle):
    x = 1.0 - cosangle
    return 0.25 * torch.exp(-0.00287 + x * (0.459 + x * (3.83 + x * (-6.80 + x * 5.25))))


def _mie_phase(cosangle, g):
    return (1.5 * ((1 - g * g) / (2 + g * g)) * (1 + cosangle * cosangle)
            / torch.pow(torch.clamp(1 + g * g - 2 * g * cosangle, min=1e-4), 1.5))


def _rayleigh_phase(cosangle):
    return 0.75 + 0.75 * cosangle * cosangle


def generate_skybox(size, *, skycolor, groundcolor, sundirection, sunintensity,
                    exposure=1.0, clouds=None, cloudheight=100.0,
                    cloudcolor=(1.0, 1.0, 1.0, 0.0), device="cpu"):
    """Returns the (6, size, size, 3) f32 HDR cubemap, built on `device`.

    clouds: optional dict(density (H, W, 1+) image, normal (H, W, 3)
    image, each float in [0, 1] or u8): a cloud layer at cloudheight,
    lit by its normals, blended toward cloudcolor.rgb by the density
    times cloudcolor.a, above the horizon only."""
    f32 = dict(dtype=torch.float32, device=device)
    ray = cube_dirs(size, device)                          # (6, S, S, 3)
    skycolor = torch.as_tensor(skycolor, **f32)
    sund = torch.as_tensor(sundirection, **f32)
    sund = sund / torch.clamp(torch.linalg.norm(sund), min=1e-9)
    suni = torch.as_tensor(sunintensity, **f32)

    eyepos_y = INNER_R + CAMERA_HEIGHT
    ry = ray[..., 1]
    far = torch.sqrt(torch.clamp(
        OUTER_R ** 2 + INNER_R ** 2 * ry * ry - INNER_R ** 2, min=0.0)) - INNER_R * ry

    startangle = ry  # dot(ray, eyepos)/|eyepos| with eyepos along +y
    startdepth = torch.exp(torch.tensor(-SCALE / SCALE_DEPTH * CAMERA_HEIGHT, **f32))
    startoffset = startdepth * _scale_fn(startangle)

    samplelength = far / SAMPLES
    scaledlength = samplelength * SCALE
    sampleray = ray * samplelength[..., None]
    samplepoint = torch.tensor([0.0, eyepos_y, 0.0], **f32) + 0.5 * sampleray

    inv_wl = 1.0 / torch.pow(torch.clamp(skycolor, min=1e-3), 4.0)

    frontcolor = torch.zeros(ray.shape, **f32)
    for _ in range(SAMPLES):
        height = torch.clamp(torch.linalg.norm(samplepoint, dim=-1), min=INNER_R)
        depth = torch.exp(SCALE / SCALE_DEPTH * (INNER_R - height))
        lightangle = (-sund * samplepoint).sum(-1) / height
        cameraangle = (ray * samplepoint).sum(-1) / height
        scatter = startoffset + depth * (_scale_fn(lightangle) - _scale_fn(cameraangle))
        attenuate = torch.exp(-torch.clamp(scatter, 0, 50)[..., None]
                              * (inv_wl * KR4PI + KM4PI))
        frontcolor = frontcolor + attenuate * (depth * scaledlength)[..., None]
        samplepoint = samplepoint + sampleray

    cosangle = (-sund * -ray).sum(-1)
    c0 = frontcolor * inv_wl * KR * suni
    c1 = frontcolor * KM * suni
    sky = (c0 * _rayleigh_phase(cosangle)[..., None]
           + torch.clamp(c1 * _mie_phase(cosangle, -0.990)[..., None], 0.0, 1.0))

    ground = torch.as_tensor(groundcolor, **f32) * torch.clamp(-sund[1], min=0.0)
    skyalpha = torch.clamp(-10.0 * ry, 0.0, 1.0)[..., None]
    color = sky * (1 - skyalpha) + ground * skyalpha

    if clouds is not None:
        tiny = torch.full_like(ry, 1e-3)
        cloudpos = ray * (cloudheight / torch.where(torch.abs(ry) < 1e-3, tiny, ry))[..., None]
        clouduv = torch.remainder(0.000005 * cloudpos[..., [0, 2]], 1.0)
        img = lambda k: torch.as_tensor(np.asarray(clouds[k]), device=device)
        cn = sample_image_bilinear(img("normal"), clouduv) * 2.0 - 1.0
        cn = cn / torch.clamp(torch.linalg.norm(cn, dim=-1, keepdim=True), min=1e-6)
        cn_world = torch.stack([cn[..., 0], cn[..., 2], cn[..., 1]], -1)
        ndl = torch.clamp((cn_world * -sund).sum(-1), min=0.0)
        dens = sample_image_bilinear(img("density"), clouduv)[..., 0]
        calpha = ndl * dens * torch.clamp(10.0 * ry, 0.0, 1.0) * cloudcolor[3]
        color = color + (torch.as_tensor(cloudcolor[:3], **f32) - color) * calpha[..., None]
    return exposure * color
