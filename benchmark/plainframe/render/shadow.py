"""Cascaded shadow view setup, host numpy (counterpart of
datum_tpu/render/shadow.py).  The opaque slice renders no shadows, but
the SceneSet carries the cascade matrices, so the port builds them the
same way the JAX package does."""

from __future__ import annotations

import numpy as np

from ..math import Transform, orthographic_proj

SPLIT_LAMBDA = 0.925
SPLIT_FAR = 150.0
EXTRUSION = 1000.0
N_SLICES = 4


def frustum_slice_corners(camera, znear, zfar):
    """8 world-space corners of the camera frustum slice."""
    t = np.tan(camera.fov / 2)
    corners = []
    for z in (znear, zfar):
        hh = t * z
        hw = hh * camera.aspect
        for sx, sy in ((-1, 1), (1, 1), (1, -1), (-1, -1)):
            corners.append(np.array([sx * hw, sy * hh, -z], np.float32))
    cam2world = camera.transform()
    return cam2world.transform_point(np.stack(corners))


def prepare_shadowview(camera, lightdirection, *, width=1024, height=1024,
                       nslices=N_SLICES, split_lambda=SPLIT_LAMBDA,
                       split_far=SPLIT_FAR):
    """Returns (splits (nslices,), shadowview (nslices, 4, 4))."""
    znear = 0.1
    zfar = split_far
    ld = np.asarray(lightdirection, np.float32)
    ld = ld / max(np.linalg.norm(ld), 1e-9)

    splits = [znear]
    for i in range(1, nslices + 1):
        alpha = i / nslices
        logdist = znear * (zfar / znear) ** alpha
        uniform = znear + (zfar - znear) * alpha
        splits.append(uniform + (logdist - uniform) * split_lambda)

    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(np.dot(ld, up))) > 0.99:
        up = np.array([0.0, 0.0, 1.0], np.float32)
    snapview = Transform.lookat(np.zeros(3, np.float32), -ld, up)

    out_splits = np.zeros(nslices, np.float32)
    out_views = np.zeros((nslices, 4, 4), np.float32)
    for i in range(nslices):
        corners = frustum_slice_corners(camera, splits[i], splits[i + 1] + 1.0)
        radius = 0.5 * float(np.linalg.norm(corners[0] - corners[6]))
        centre = corners.mean(axis=0)

        # texel snap in light space to stop shimmer
        c_ls = snapview.inverse().transform_point(centre)
        texel = (2.0 * radius) / width
        c_ls[0] -= np.fmod(c_ls[0], texel)
        c_ls[1] -= np.fmod(c_ls[1], (2.0 * radius) / height)
        centre = snapview.transform_point(c_ls)

        lightpos = centre - EXTRUSION * ld
        lightview = Transform.lookat(lightpos, lightpos + ld, up)
        lightproj = orthographic_proj(-radius, radius, -radius, radius,
                                      0.1, EXTRUSION + radius)
        # Y flip to match the main projection's Vulkan-style convention
        flip = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32)
        out_splits[i] = splits[i + 1]
        out_views[i] = flip @ lightproj @ lightview.inverse().matrix()
    return out_splits, out_views
