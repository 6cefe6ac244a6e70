"""4x4 projection matrices, column-vector convention clip = M @ v (the
part of datum_tpu/math/matrix.py the port uses, copied).

Y-flipped and reverse-Z: depth 1 at the near plane, 0 at infinity; the
depth buffer clears to 0 and the depth test is greater-than."""

from __future__ import annotations

import numpy as np


def perspective_proj(fov, aspect, znear, zfar=None):
    """Reverse-Z, Y-flipped perspective projection; zfar=None gives the
    infinite-far-plane variant of the main camera."""
    proj = np.zeros((4, 4), np.float32)
    t = np.tan(fov / 2)
    proj[0, 0] = 1.0 / (aspect * t)
    proj[1, 1] = -1.0 / t
    if zfar is None:
        proj[2, 2] = 0.0
        proj[2, 3] = znear
    else:
        proj[2, 2] = zfar / (zfar - znear) - 1.0
        proj[2, 3] = zfar * znear / (zfar - znear)
    proj[3, 2] = -1.0
    return proj


def orthographic_proj(left, right, bottom, top, znear, zfar):
    """Reverse-Z orthographic projection (the shadow cascades')."""
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 2.0 / (right - left)
    proj[1, 1] = 2.0 / (top - bottom)
    proj[2, 2] = 1.0 / (zfar - znear)
    proj[0, 3] = -(right + left) / (right - left)
    proj[1, 3] = -(top + bottom) / (top - bottom)
    proj[2, 3] = zfar / (zfar - znear)
    proj[3, 3] = 1.0
    return proj
