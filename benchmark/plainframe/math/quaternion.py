"""Quaternions as float32 ndarrays [w, x, y, z], batched over leading
dims (the part of datum_tpu/math/quaternion.py the port uses, copied)."""

from __future__ import annotations

import numpy as np

from .vec import normalize


def quat_axis_angle(axis, angle):
    axis = normalize(np.asarray(axis, np.float32))
    h = 0.5 * float(angle)
    s = np.sin(h)
    return np.concatenate([[np.cos(h)], axis * s]).astype(np.float32)


def quat_mul(a, b):
    aw, ax, ay, az = np.moveaxis(np.asarray(a, np.float32), -1, 0)
    bw, bx, by, bz = np.moveaxis(np.asarray(b, np.float32), -1, 0)
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return np.asarray(q, np.float32) * np.array([1, -1, -1, -1], np.float32)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q."""
    q = np.asarray(q, np.float32)
    v = np.asarray(v, np.float32)
    qv = q[..., 1:]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_from_axes(xaxis, yaxis, zaxis):
    """Quaternion from an orthonormal basis (columns of a rotation matrix)."""
    m = np.stack([np.asarray(xaxis, np.float32),
                  np.asarray(yaxis, np.float32),
                  np.asarray(zaxis, np.float32)], axis=-1)
    return quat_from_matrix(m)


def quat_from_matrix(m):
    m = np.asarray(m, np.float32)
    t = m[0, 0] + m[1, 1] + m[2, 2]
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([w, x, y, z], np.float32)


def quat_to_matrix(q):
    """3x3 rotation matrix (columns = rotated basis vectors)."""
    w, x, y, z = np.moveaxis(np.asarray(q, np.float32), -1, 0)
    return np.stack(
        [
            np.stack([1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w], -1),
            np.stack([2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w], -1),
            np.stack([2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y], -1),
        ],
        axis=-2,
    )


def quat_slerp(a, b, t):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    d = float(np.dot(a, b))
    if d < 0:
        b, d = -b, -d
    if d > 0.9995:
        out = a + t * (b - a)
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * theta) * a + np.sin(t * theta) * b) / np.sin(theta)
