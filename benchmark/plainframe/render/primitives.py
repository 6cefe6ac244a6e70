"""Procedural built-in meshes (counterpart of
datum_tpu/render/primitives.py): the core pack's quad, cube, cone,
hemisphere and sphere and its line lists (pairs of endpoints) and the
plane.  Vertices carry {position, texcoord,
normal, tangent(xyz,w)}."""

from __future__ import annotations

import numpy as np


def _mesh(pos, uv, nrm, tan, idx):
    return dict(position=np.asarray(pos, np.float32),
                texcoord=np.asarray(uv, np.float32),
                normal=np.asarray(nrm, np.float32),
                tangent=np.asarray(tan, np.float32)), np.asarray(idx, np.int32)


def unit_quad():
    """XY quad from (-1,-1) to (1,1), facing +Z."""
    pos = [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]
    uv = [[0, 0], [1, 0], [1, 1], [0, 1]]
    nrm = [[0, 0, 1]] * 4
    tan = [[1, 0, 0, 1]] * 4
    return _mesh(pos, uv, nrm, tan, [0, 1, 2, 0, 2, 3])


def unit_cube():
    """Axis-aligned cube [-1, 1]^3, outward normals, per-face uvs."""
    faces = [
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ]
    pos, uv, nrm, tan, idx = [], [], [], [], []
    for n, t, b in faces:
        n, t, b = np.array(n, np.float32), np.array(t, np.float32), np.array(b, np.float32)
        base = len(pos)
        for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            pos.append(n + su * t + sv * b)
            uv.append([(su + 1) / 2, (sv + 1) / 2])
            nrm.append(n)
            tan.append([*t, 1.0])
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return _mesh(pos, uv, nrm, tan, idx)


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


def unit_hemi(segments=32, rings=8):
    """Upper hemisphere of the unit sphere."""
    pos, uv, nrm, tan, idx = [], [], [], [], []
    for r in range(rings + 1):
        theta = 0.5 * np.pi * r / rings
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


def unit_cone(segments=32):
    """Cone: apex at origin, unit-radius base at z=-1 (spot-light volume)."""
    pos, uv, nrm, tan, idx = [[0, 0, 0]], [[0.5, 0.5]], [[0, 0, 1]], [[1, 0, 0, 1]], []
    for s in range(segments + 1):
        phi = 2 * np.pi * s / segments
        c, sn = np.cos(phi), np.sin(phi)
        pos.append([c, sn, -1.0])
        uv.append([s / segments, 1.0])
        n = np.array([c, sn, 1.0]) / np.sqrt(2)
        nrm.append(n.tolist())
        tan.append([-sn, c, 0, 1.0])
    for s in range(segments):
        idx += [0, 1 + s, 2 + s]
    # base cap
    base = len(pos)
    pos.append([0, 0, -1.0])
    uv.append([0.5, 0.5])
    nrm.append([0, 0, -1.0])
    tan.append([1, 0, 0, 1])
    for s in range(segments):
        idx += [base, 2 + s, 1 + s]
    return _mesh(pos, uv, nrm, tan, idx)


def plane(size=1.0, reps=1.0):
    """Ground plane in XZ facing +Y."""
    pos = [[-size, 0, -size], [size, 0, -size], [size, 0, size], [-size, 0, size]]
    uv = [[0, 0], [reps, 0], [reps, reps], [0, reps]]
    nrm = [[0, 1, 0]] * 4
    tan = [[1, 0, 0, 1]] * 4
    return _mesh(pos, uv, nrm, tan, [0, 2, 1, 0, 3, 2])


def line_cube():
    """Wireframe cube line list (pairs of endpoints)."""
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                       np.float32)
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    return corners, np.asarray(edges, np.int32)


def line_quad():
    """Unit quad outline line list (reference: core line_quad mesh)."""
    corners = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                       np.float32)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
    return corners, np.asarray(edges, np.int32)


def line_cone(segments=16):
    """Unit cone outline: base circle + 4 spokes to the apex
    (reference: core line_cone mesh)."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    base = np.stack([np.cos(ang), np.sin(ang), np.ones_like(ang)], -1)
    pos = np.concatenate([base, [[0.0, 0.0, 0.0]]], 0).astype(np.float32)
    edges = [(i, (i + 1) % segments) for i in range(segments)]
    edges += [(i, segments) for i in range(0, segments, segments // 4)]
    return pos, np.asarray(edges, np.int32)
