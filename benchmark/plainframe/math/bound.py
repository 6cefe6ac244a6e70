"""Bounding volumes and view frusta for host-side culling (counterpart
of datum_tpu/math/bound.py, copied): the AABB (Bound3), Sphere, Plane
and the 6-plane Frustum whose tests the scene systems cull with."""

from __future__ import annotations

import numpy as np

from .vec import normalize


class Plane:
    """Plane n.x = d with unit normal n."""

    __slots__ = ("normal", "distance")

    def __init__(self, normal, distance):
        self.normal = np.asarray(normal, np.float32)
        self.distance = float(distance)

    @staticmethod
    def from_points(a, b, c):
        n = normalize(np.cross(np.subtract(b, a), np.subtract(c, a)))
        return Plane(n, float(np.dot(n, a)))

    def signed_distance(self, p):
        return np.dot(np.asarray(p, np.float32), self.normal) - self.distance


class Bound3:
    """Axis-aligned box [min, max]."""

    __slots__ = ("min", "max")

    def __init__(self, mn, mx):
        self.min = np.asarray(mn, np.float32)
        self.max = np.asarray(mx, np.float32)

    @property
    def centre(self):
        return 0.5 * (self.min + self.max)

    @property
    def halfdim(self):
        return 0.5 * (self.max - self.min)

    @property
    def radius(self):
        return float(np.linalg.norm(self.halfdim))

    def contains(self, p):
        p = np.asarray(p)
        return bool(np.all(p >= self.min) and np.all(p <= self.max))

    def intersects(self, other: "Bound3"):
        return bool(np.all(self.min <= other.max) and np.all(other.min <= self.max))

    def transformed(self, transform):
        """AABB of this box under a rigid transform."""
        corners = np.array(
            [[x, y, z] for x in (self.min[0], self.max[0])
             for y in (self.min[1], self.max[1])
             for z in (self.min[2], self.max[2])], np.float32)
        moved = transform.transform_point(corners)
        return Bound3(moved.min(axis=0), moved.max(axis=0))

    def __repr__(self):
        return f"Bound3({self.min.tolist()}, {self.max.tolist()})"


def bound_union(a: Bound3, b: Bound3) -> Bound3:
    return Bound3(np.minimum(a.min, b.min), np.maximum(a.max, b.max))


def bound_expand(b: Bound3, margin: float) -> Bound3:
    return Bound3(b.min - margin, b.max + margin)


class Sphere:
    __slots__ = ("centre", "radius")

    def __init__(self, centre, radius):
        self.centre = np.asarray(centre, np.float32)
        self.radius = float(radius)

    def intersects(self, other: "Sphere"):
        d = np.linalg.norm(self.centre - other.centre)
        return bool(d <= self.radius + other.radius)


class Frustum:
    """Six inward-facing planes: left, right, top, bottom, near, far.

    Stored as a (6, 4) array [nx, ny, nz, -d] so that a point p is
    inside when planes @ [p, 1] >= 0 for all rows.
    """

    __slots__ = ("planes",)

    def __init__(self, planes):
        self.planes = np.asarray(planes, np.float32).reshape(6, 4)

    @staticmethod
    def from_viewproj(viewproj):
        """Gribb-Hartmann plane extraction from a combined view-projection.

        Works with the renderer's reverse-Z convention: clip-space visible
        volume is -w<=x<=w, -w<=y<=w, 0<=z<=w.
        """
        m = np.asarray(viewproj, np.float32)
        rows = [
            m[3] + m[0],   # left
            m[3] - m[0],   # right
            m[3] + m[1],   # bottom
            m[3] - m[1],   # top
            m[3] - m[2],   # near  (reverse-Z: z <= w)
            m[2],          # far   (reverse-Z: z >= 0)
        ]
        planes = []
        for r in rows:
            n = np.linalg.norm(r[:3])
            planes.append(r / max(n, 1e-20))
        return Frustum(np.stack(planes))

    def contains_point(self, p):
        hp = np.append(np.asarray(p, np.float32), 1.0)
        return bool(np.all(self.planes @ hp >= 0))

    def intersects_sphere(self, centre, radius):
        hp = np.append(np.asarray(centre, np.float32), 1.0)
        return bool(np.all(self.planes @ hp >= -radius))

    def intersects_bound(self, bound: Bound3):
        """Conservative AABB test (p-vertex per plane)."""
        n = self.planes[:, :3]
        p = np.where(n >= 0, bound.max, bound.min)
        d = np.sum(n * p, axis=1) + self.planes[:, 3]
        return bool(np.all(d >= 0))

    def intersects_bounds(self, mins, maxs):
        """Vectorized AABB test over (N,3) arrays -> (N,) bool."""
        n = self.planes[:, :3]                       # (6,3)
        mins = np.asarray(mins, np.float32)          # (N,3)
        maxs = np.asarray(maxs, np.float32)
        p = np.where(n[None, :, :] >= 0, maxs[:, None, :], mins[:, None, :])  # (N,6,3)
        d = np.sum(n[None] * p, axis=2) + self.planes[None, :, 3]             # (N,6)
        return np.all(d >= 0, axis=1)
