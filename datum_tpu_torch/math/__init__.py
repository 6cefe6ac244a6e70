"""Host-side math (numpy): the port's own copy of the part of
datum_tpu/math it uses — dual-quaternion transforms, quaternions and the
reverse-Z projections.  A test holds it equal to the JAX package's."""

from .matrix import orthographic_proj, perspective_proj
from .quaternion import quat_rotate, quat_to_matrix
from .transform import Transform

__all__ = ["Transform", "orthographic_proj", "perspective_proj", "quat_rotate",
           "quat_to_matrix"]
