"""Host-side math (numpy): the port's own copy of the part of
datum_tpu/math it uses — dual-quaternion transforms, quaternions, the
reverse-Z projections and the bounds and frusta the scene culls with.
A test holds it equal to the JAX package's."""

from .bound import Bound3, Frustum, Plane, Sphere, bound_expand, bound_union
from .matrix import orthographic_proj, perspective_proj
from .quaternion import quat_rotate, quat_to_matrix
from .transform import Transform

__all__ = ["Bound3", "Frustum", "Plane", "Sphere", "Transform", "bound_expand",
           "bound_union", "orthographic_proj", "perspective_proj", "quat_rotate",
           "quat_to_matrix"]
