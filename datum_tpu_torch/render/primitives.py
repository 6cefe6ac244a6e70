"""Procedural built-in meshes (counterpart of
datum_tpu/render/primitives.py, trimmed to the slice's sphere and
plane).  Vertices carry {position, texcoord, normal, tangent(xyz,w)}."""

from __future__ import annotations

import numpy as np


def _mesh(pos, uv, nrm, tan, idx):
    return dict(position=np.asarray(pos, np.float32),
                texcoord=np.asarray(uv, np.float32),
                normal=np.asarray(nrm, np.float32),
                tangent=np.asarray(tan, np.float32)), np.asarray(idx, np.int32)


def unit_sphere(segments=32, rings=16):
    """Unit sphere, lat-long parameterisation."""
    pos, uv, nrm, tan, idx = [], [], [], [], []
    for r in range(rings + 1):
        theta = np.pi * r / rings
        for s in range(segments + 1):
            phi = 2 * np.pi * s / segments
            p = [np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)]
            pos.append(p)
            uv.append([s / segments, r / rings])
            nrm.append(p)
            tan.append([-np.sin(phi), 0, np.cos(phi), 1.0])
    for r in range(rings):
        for s in range(segments):
            a = r * (segments + 1) + s
            b = a + segments + 1
            idx += [a, b, a + 1, a + 1, b, b + 1]
    return _mesh(pos, uv, nrm, tan, idx)


def plane(size=1.0, reps=1.0):
    """Ground plane in XZ facing +Y."""
    pos = [[-size, 0, -size], [size, 0, -size], [size, 0, size], [-size, 0, size]]
    uv = [[0, 0], [reps, 0], [reps, reps], [0, reps]]
    nrm = [[0, 1, 0]] * 4
    tan = [[1, 0, 0, 1]] * 4
    return _mesh(pos, uv, nrm, tan, [0, 2, 1, 0, 3, 2])
