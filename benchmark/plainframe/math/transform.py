"""Dual-quaternion rigid transforms (the part of
datum_tpu/math/transform.py the port uses, copied).

A Transform is a pair of quaternions {real, dual}: real encodes the
rotation and dual = 0.5 * t * real the translation; storage is
scalar-first [w, x, y, z], and a Transform flattens to 8 floats
[real.wxyz, dual.wxyz] (a skinning palette row)."""

from __future__ import annotations

import numpy as np

from .quaternion import (quat_axis_angle, quat_conj, quat_from_axes, quat_mul,
                         quat_rotate, quat_slerp, quat_to_matrix)
from .vec import cross, normalize


class Transform:
    __slots__ = ("real", "dual")

    def __init__(self, real, dual):
        self.real = np.asarray(real, np.float32)
        self.dual = np.asarray(dual, np.float32)

    @staticmethod
    def identity():
        return Transform([1, 0, 0, 0], [0, 0, 0, 0])

    @staticmethod
    def rotation(q_or_axis, angle=None):
        q = quat_axis_angle(q_or_axis, angle) if angle is not None else np.asarray(q_or_axis, np.float32)
        return Transform(q, [0, 0, 0, 0])

    @staticmethod
    def translation(v):
        v = np.asarray(v, np.float32)
        return Transform([1, 0, 0, 0], [0.0, 0.5 * v[0], 0.5 * v[1], 0.5 * v[2]])

    @staticmethod
    def lookat(position, target_or_orientation, up=None):
        """lookat(position, orientation) or lookat(position, target, up)."""
        position = np.asarray(position, np.float32)
        if up is None:
            orientation = np.asarray(target_or_orientation, np.float32)
        else:
            zaxis = normalize(position - np.asarray(target_or_orientation, np.float32))
            xaxis = normalize(cross(np.asarray(up, np.float32), zaxis))
            yaxis = cross(zaxis, xaxis)
            orientation = quat_from_axes(xaxis, yaxis, zaxis)
        dual = quat_mul(np.concatenate([[0.0], 0.5 * position]).astype(np.float32), orientation)
        return Transform(orientation, dual)

    @staticmethod
    def from_flat(arr):
        arr = np.asarray(arr, np.float32).reshape(8)
        return Transform(arr[:4], arr[4:])

    def flat(self):
        return np.concatenate([self.real, self.dual]).astype(np.float32)

    def translation_vec(self):
        t = 2.0 * quat_mul(self.dual, quat_conj(self.real))
        return t[1:4]

    def rotation_quat(self):
        return self.real

    def matrix(self):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = quat_to_matrix(self.real)
        m[:3, 3] = self.translation_vec()
        return m

    def __mul__(self, other):
        if isinstance(other, Transform):
            real = quat_mul(self.real, other.real)
            dual = quat_mul(self.real, other.dual) + quat_mul(self.dual, other.real)
            return Transform(real, dual)
        return self.transform_point(other)

    def transform_point(self, v):
        """Rigidly transform point(s) v, broadcasting over (..., 3)."""
        v = np.asarray(v, np.float32)
        return quat_rotate(self.real, v) + self.translation_vec()

    def conjugate(self):
        return Transform(quat_conj(self.real), self.dual * np.array([-1, 1, 1, 1], np.float32))

    def inverse(self):
        return Transform(quat_conj(self.real), quat_conj(self.dual))

    def normalized(self):
        ln = float(np.linalg.norm(self.real))
        real = self.real / ln
        dual = (self.dual * ln - self.real * (float(np.dot(self.real, self.dual)) / ln)) / (ln * ln)
        return Transform(real, dual)


def tf_lerp(t1: Transform, t2: Transform, alpha: float) -> Transform:
    """Normalised dual-quat lerp with hemisphere flip (NLERP)."""
    flip = np.copysign(1.0, float(np.dot(t1.real, t2.real)))
    real = t1.real + (flip * t2.real - t1.real) * alpha
    dual = t1.dual + (flip * t2.dual - t1.dual) * alpha
    return Transform(real, dual).normalized()


def tf_slerp(t1: Transform, t2: Transform, alpha: float) -> Transform:
    rotation = quat_slerp(t1.rotation_quat(), t2.rotation_quat(), alpha)
    translation = t1.translation_vec() + (t2.translation_vec() - t1.translation_vec()) * alpha
    return Transform.translation(translation) * Transform.rotation(rotation)


def tf_blend(t1: Transform, t2: Transform, weight: float) -> Transform:
    """Weighted accumulate for skinning palettes (un-normalised)."""
    flip = np.copysign(1.0, float(np.dot(t1.real, t2.real)))
    return Transform(t1.real + weight * flip * t2.real, t1.dual + weight * flip * t2.dual)
