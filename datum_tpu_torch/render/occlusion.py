"""Software occlusion buffer for host-side culling (counterpart of
datum_tpu/render/occlusion.py, numpy).

A 256x144 reverse-Z depth buffer: `fill_elements` rasterises occluder
triangles at their conservative (farthest) depth, and `visible` tests a
box's nearest depth against its screen rectangle, so the test only ever
keeps a hidden object, never culls a visible one.  The port keeps the
JAX package's numpy fill; its native scanline fill computes the same
buffer (tests/test_torch_scene.py holds this one against both)."""

from __future__ import annotations

import numpy as np

WIDTH = 256
HEIGHT = 144


class OcclusionBuffer:
    def __init__(self, width=WIDTH, height=HEIGHT):
        self.width = width
        self.height = height
        self.depth = np.zeros((height, width), np.float32)   # reverse-Z: 0=far

    def clear(self):
        self.depth.fill(0.0)

    def fill_elements(self, viewproj, positions, indices):
        """Rasterize occluder triangles (positions (N, 3), indices (T*3,)
        or (T, 3)) at each triangle's farthest depth: a texel keeps the
        largest depth written to it."""
        pos = np.asarray(positions, np.float32)
        hp = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], -1)
        clip = hp @ np.asarray(viewproj, np.float32).T
        tris = np.asarray(indices, np.int32).reshape(-1, 3)
        v = clip[tris]                                       # (T, 3, 4)
        w = v[..., 3]
        ok = np.all(w > 1e-4, axis=1)
        sx = (v[..., 0] / np.maximum(w, 1e-6) * 0.5 + 0.5) * self.width
        sy = (v[..., 1] / np.maximum(w, 1e-6) * 0.5 + 0.5) * self.height
        sz = v[..., 2] / np.maximum(w, 1e-6)
        # conservative occluder depth: the triangle's farthest point
        zmin = sz.min(axis=1)
        for t in np.nonzero(ok & (zmin > 0))[0]:
            x0 = int(max(np.ceil(sx[t].min()), 0))
            x1 = int(min(np.floor(sx[t].max()), self.width - 1))
            y0 = int(max(np.ceil(sy[t].min()), 0))
            y1 = int(min(np.floor(sy[t].max()), self.height - 1))
            if x1 < x0 or y1 < y0:
                continue
            xs = np.arange(x0, x1 + 1) + 0.5
            ys = (np.arange(y0, y1 + 1) + 0.5)[:, None]
            # edge functions in screen space
            ax, ay = sx[t, 0], sy[t, 0]
            bx, by = sx[t, 1], sy[t, 1]
            cx, cy = sx[t, 2], sy[t, 2]
            e0 = (bx - ax) * (ys - ay) - (by - ay) * (xs - ax)
            e1 = (cx - bx) * (ys - by) - (cy - by) * (xs - bx)
            e2 = (ax - cx) * (ys - cy) - (ay - cy) * (xs - cx)
            inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | \
                     ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
            region = self.depth[y0:y1 + 1, x0:x1 + 1]
            np.maximum(region, np.where(inside, zmin[t], 0.0), out=region)

    def visible(self, mins, maxs, viewproj) -> bool:
        """Conservative AABB visibility vs the occluder buffer."""
        mins = np.asarray(mins, np.float32)
        maxs = np.asarray(maxs, np.float32)
        corners = np.array([[x, y, z]
                            for x in (mins[0], maxs[0])
                            for y in (mins[1], maxs[1])
                            for z in (mins[2], maxs[2])], np.float32)
        hp = np.concatenate([corners, np.ones((8, 1), np.float32)], -1)
        clip = hp @ np.asarray(viewproj, np.float32).T
        w = clip[:, 3]
        if np.any(w <= 1e-4):
            return True          # crosses the camera plane: assume visible
        sx = (clip[:, 0] / w * 0.5 + 0.5) * self.width
        sy = (clip[:, 1] / w * 0.5 + 0.5) * self.height
        sz = clip[:, 2] / w
        obj_near = float(sz.max())                  # nearest point (reverse-Z)
        x0 = int(max(np.floor(sx.min()), 0))
        x1 = int(min(np.ceil(sx.max()), self.width - 1))
        y0 = int(max(np.floor(sy.min()), 0))
        y1 = int(min(np.ceil(sy.max()), self.height - 1))
        if x1 < x0 or y1 < y0:
            return False         # entirely off screen
        rect = self.depth[y0:y1 + 1, x0:x1 + 1]
        return bool((rect < obj_near + 1e-6).any())
