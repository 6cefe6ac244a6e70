"""Host camera (counterpart of datum_tpu/render/camera.py, trimmed to
what the port calls): Y-flipped reverse-Z projection, the look-at view,
the frame vectors the particle billboards face and the depth-of-field
focus."""

from __future__ import annotations

import numpy as np

from ..math import Transform, perspective_proj, quat_rotate


class Camera:
    def __init__(self):
        self.fov = np.radians(60.0)
        self.aspect = 16 / 9
        self.znear = 0.1
        self.zfar = 1000.0
        self.exposure = 1.0
        self.focalwidth = 100000.0
        self.focaldistance = 0.0
        self.position = np.zeros(3, np.float32)
        self.rotation = np.array([1, 0, 0, 0], np.float32)

    def set_projection(self, fov, aspect, znear=0.1, zfar=1000.0):
        self.fov, self.aspect, self.znear, self.zfar = fov, aspect, znear, zfar

    def set_depth_of_field(self, focalwidth, focaldistance):
        """The DoF blur ramps to full over focalwidth around focaldistance
        (view distances)."""
        self.focalwidth, self.focaldistance = focalwidth, focaldistance

    def right(self):
        return quat_rotate(self.rotation, np.array([1.0, 0, 0], np.float32))

    def up(self):
        return quat_rotate(self.rotation, np.array([0.0, 1, 0], np.float32))

    def forward(self):
        return quat_rotate(self.rotation, np.array([0.0, 0, -1], np.float32))

    def transform(self) -> Transform:
        return Transform.lookat(self.position, self.rotation)

    def view(self):
        return self.transform().inverse().matrix()

    def proj(self):
        """Infinite reverse-Z projection."""
        return perspective_proj(self.fov, self.aspect, self.znear)

    def lookat(self, *args):
        """lookat(target, up) or lookat(position, target, up)."""
        if len(args) == 3:
            self.position = np.asarray(args[0], np.float32)
            target, up = args[1], args[2]
        else:
            target, up = args
        self.rotation = Transform.lookat(self.position, np.asarray(target, np.float32),
                                         np.asarray(up, np.float32)).rotation_quat()
