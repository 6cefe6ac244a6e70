"""Host camera (counterpart of datum_tpu/render/camera.py, copied):
Y-flipped reverse-Z projection, the look-at view, the view frustum, the
fps and orbit controls composing quaternion rotations, the depth-of-field
focus and exposure adaptation toward a target luminance."""

from __future__ import annotations

import numpy as np

from ..math import Transform, perspective_proj, quat_rotate
from ..math.bound import Frustum
from ..math.quaternion import quat_axis_angle, quat_mul, quat_slerp


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

    # --- config -----------------------------------------------------------
    def set_projection(self, fov, aspect, znear=0.1, zfar=1000.0):
        self.fov, self.aspect, self.znear, self.zfar = fov, aspect, znear, zfar

    def set_exposure(self, exposure):
        self.exposure = float(exposure)

    def set_depth_of_field(self, focalwidth, focaldistance):
        """The DoF blur ramps to full over focalwidth around focaldistance
        (view distances)."""
        self.focalwidth, self.focaldistance = focalwidth, focaldistance

    # --- frame vectors ----------------------------------------------------
    def right(self):
        return quat_rotate(self.rotation, np.array([1.0, 0, 0], np.float32))

    def up(self):
        return quat_rotate(self.rotation, np.array([0.0, 1, 0], np.float32))

    def forward(self):
        return quat_rotate(self.rotation, np.array([0.0, 0, -1], np.float32))

    # --- matrices ---------------------------------------------------------
    def transform(self) -> Transform:
        return Transform.lookat(self.position, self.rotation)

    def view(self):
        return self.transform().inverse().matrix()

    def proj(self, infinite=True):
        """Reverse-Z projection: infinite, or with the far plane at zfar."""
        if infinite:
            return perspective_proj(self.fov, self.aspect, self.znear)
        return perspective_proj(self.fov, self.aspect, self.znear, self.zfar)

    def viewproj(self):
        return self.proj() @ self.view()

    def frustum(self, znear=None, zfar=None):
        proj = perspective_proj(self.fov, self.aspect,
                                znear or self.znear, zfar or self.zfar)
        return Frustum.from_viewproj(proj @ self.view())

    # --- controls ---------------------------------------------------------
    def move(self, offset):
        self.position = self.position + np.asarray(offset, np.float32)

    def offset(self, delta):
        self.position = self.position + quat_rotate(self.rotation,
                                                    np.asarray(delta, np.float32))

    def rotate(self, q):
        self.rotation = quat_mul(self.rotation, q)

    def roll(self, angle):
        self.rotate(quat_axis_angle([0, 0, 1], angle))

    def pitch(self, angle):
        self.rotate(quat_axis_angle([1, 0, 0], angle))

    def yaw(self, angle, up=None):
        if up is None:
            self.rotate(quat_axis_angle([0, 1, 0], angle))
        else:
            self.rotation = quat_mul(quat_axis_angle(up, angle), self.rotation)

    def lookat(self, *args):
        """lookat(target, up) or lookat(position, target, up)."""
        if len(args) == 3:
            self.position = np.asarray(args[0], np.float32)
            target, up = args[1], args[2]
        else:
            target, up = args
        self.rotation = Transform.lookat(self.position, np.asarray(target, np.float32),
                                         np.asarray(up, np.float32)).rotation_quat()

    def pan(self, target, dx, dy):
        speed = float(np.clip(0.1 * np.linalg.norm(self.position - target), 0.1, 10.0))
        off = speed * (dx * self.right() + dy * self.up())
        newtarget = np.asarray(target, np.float32) + off
        pos = self.position + off
        self.lookat(pos, newtarget, self.up())
        return newtarget

    def dolly(self, target, amount):
        speed = float(np.clip(0.1 * np.linalg.norm(self.position - target), 0.1, 10.0))
        self.lookat(self.position + speed * amount * self.forward(), target, self.up())

    def orbit(self, target, rotation):
        speed = float(np.clip(0.1 * np.linalg.norm(self.position - target), 0.1, 1.0))
        angle = quat_slerp(np.array([1.0, 0, 0, 0], np.float32), rotation, speed)
        angle = angle / np.linalg.norm(angle)
        t = (Transform.translation(target) * Transform.rotation(angle)
             * Transform.translation(-np.asarray(target, np.float32)))
        pos = t.transform_point(self.position)
        self.lookat(pos, np.asarray(target, np.float32), self.up())


def adapt(camera: Camera, currentluminance, targetluminance=0.18, rate=0.05):
    """Auto-exposure: move camera.exposure toward the exposure that maps
    currentluminance (the last frame's log-average) to targetluminance,
    by rate a call, clamped to [0, 8]."""
    scale = 1.0 + (targetluminance / (float(currentluminance) + 1e-3) - 1.0) * rate
    camera.set_exposure(float(np.clip(camera.exposure * scale, 0.0, 8.0)))
    return camera
