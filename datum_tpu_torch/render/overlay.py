"""3D debug overlays drawn on the host into a presented u8 frame:
lines, wireframes, gizmos, silhouettes, paths, fills and boxes
(counterpart of datum_tpu/render/overlay.py, copied).

Depth testing: pass the frame's reverse-Z depth plane (z/w, larger =
nearer; `RenderContext.last_depth`, a device tensor in the port: read it
back with `.cpu().numpy()`) as ``depth=`` to any world-space draw, and
samples behind the scene surface are discarded.  z/w is affine in screen
space, so the per-sample line depth interpolates exactly.
"""

from __future__ import annotations

import numpy as np


def _project(points, viewproj, width, height):
    hp = np.concatenate([np.asarray(points, np.float32),
                         np.ones((len(points), 1), np.float32)], -1)
    clip = hp @ np.asarray(viewproj, np.float32).T
    w = clip[:, 3]
    ok = w > 1e-4
    sw = np.where(ok, w, 1.0)
    x = (clip[:, 0] / sw * 0.5 + 0.5) * width
    y = (clip[:, 1] / sw * 0.5 + 0.5) * height
    z = clip[:, 2] / sw
    return x, y, ok, z


def draw_line_2d(image, x0, y0, x1, y1, color=(255, 255, 255), alpha=1.0,
                 depth=None, z0=None, z1=None, depth_bias=2e-3):
    """Sampled line segment blit into a uint8 (H, W, 3) frame.

    depth: optional (Hd, Wd) reverse-Z scene depth plane (larger =
    nearer); samples whose interpolated z/w is farther than the scene
    surface (with a relative bias so coplanar wireframes win) are
    discarded.  The depth plane may be render-resolution while the
    image is display-resolution (FrameConfig.scale) — indices rescale.
    """
    h, w = image.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.linspace(x0, x1, n)
    ys = np.linspace(y0, y1, n)
    valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xi = xs[valid].astype(np.int32)
    yi = ys[valid].astype(np.int32)
    if depth is not None and z0 is not None:
        zs = np.linspace(np.float32(z0), np.float32(z1), n)[valid]
        dh, dw = depth.shape[:2]
        di = (yi * dh) // h if dh != h else yi
        dj = (xi * dw) // w if dw != w else xi
        scene_z = np.asarray(depth)[di, dj]
        vis = zs >= scene_z * (1.0 - depth_bias) - 1e-6
        xi, yi = xi[vis], yi[vis]
    c = np.asarray(color, np.float32)
    image[yi, xi] = np.clip(image[yi, xi] * (1 - alpha) + c * alpha,
                            0, 255).astype(np.uint8)


def draw_lines(image, segments, viewproj, color=(255, 255, 255), alpha=1.0,
               depth=None):
    """World-space line list: segments (N, 2, 3)."""
    h, w = image.shape[:2]
    segs = np.asarray(segments, np.float32).reshape(-1, 2, 3)
    x, y, ok, z = _project(segs.reshape(-1, 3), viewproj, w, h)
    x = x.reshape(-1, 2)
    y = y.reshape(-1, 2)
    z = z.reshape(-1, 2)
    ok = ok.reshape(-1, 2).all(1)
    for i in np.nonzero(ok)[0]:
        draw_line_2d(image, x[i, 0], y[i, 0], x[i, 1], y[i, 1], color, alpha,
                     depth=depth, z0=z[i, 0], z1=z[i, 1])


def draw_wireframe(image, positions, indices, transform, viewproj,
                   color=(80, 255, 120), alpha=0.8, depth=None):
    """Wireframe of a triangle mesh (edges of each triangle)."""
    pos = transform.transform_point(np.asarray(positions, np.float32))
    tris = np.asarray(indices, np.int32).reshape(-1, 3)
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    # unique undirected edges
    key = np.sort(edges, axis=1)
    _, idx = np.unique(key[:, 0].astype(np.int64) << 32 | key[:, 1], return_index=True)
    segs = pos[edges[idx]]
    draw_lines(image, segs, viewproj, color, alpha, depth=depth)


def draw_gizmo(image, transform, viewproj, size=1.0, depth=None):
    """RGB axis gizmo at a transform (reference: gizmo.vert/frag)."""
    o = transform.translation_vec()
    from ..math.quaternion import quat_rotate

    q = transform.rotation_quat()
    for axis, color in ((np.array([1.0, 0, 0]), (255, 64, 64)),
                        (np.array([0, 1.0, 0]), (64, 255, 64)),
                        (np.array([0, 0, 1.0]), (64, 128, 255))):
        tip = o + quat_rotate(q, axis * size)
        draw_lines(image, [[o, tip]], viewproj, color, 1.0, depth=depth)


def draw_outline(image, positions, indices, transform, viewproj, campos,
                 color=(255, 200, 40), alpha=1.0, depth=None):
    """Silhouette outline of a mesh (reference: outline.geom — edges
    between a front-facing and a back-facing triangle, plus boundary
    edges)."""
    pos = transform.transform_point(np.asarray(positions, np.float32))
    tris = np.asarray(indices, np.int32).reshape(-1, 3)
    a, b, c = pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]
    n = np.cross(b - a, c - a)
    front = np.einsum("ij,ij->i", n, np.asarray(campos, np.float32) - a) > 0

    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    owner_front = np.repeat(front, 3)
    key = np.sort(edges, axis=1)
    kid = key[:, 0].astype(np.int64) << 32 | key[:, 1]
    order = np.argsort(kid, kind="stable")
    kid_s, of_s, e_s = kid[order], owner_front[order], edges[order]
    sil = []
    i = 0
    while i < len(kid_s):
        j = i + 1
        while j < len(kid_s) and kid_s[j] == kid_s[i]:
            j += 1
        faces = of_s[i:j]
        if len(faces) == 1 or (faces.any() and not faces.all()):
            if faces.any():                      # only visible silhouettes
                sil.append(e_s[i])
        i = j
    if sil:
        draw_lines(image, pos[np.asarray(sil)], viewproj, color, alpha,
                   depth=depth)


def draw_path(image, points, viewproj=None, color=(255, 255, 255), alpha=1.0,
              closed=False, depth=None):
    """Polyline path (reference: path.geom overlay).  points: (N, 2)
    screen-space when viewproj is None, else (N, 3) world-space."""
    pts = np.asarray(points, np.float32)
    if viewproj is not None:
        h, w = image.shape[:2]
        x, y, ok, z = _project(pts, viewproj, w, h)
        pts = np.stack([x, y, z], -1)[ok]
    seq = list(pts) + ([pts[0]] if closed and len(pts) else [])
    for p0, p1 in zip(seq, seq[1:]):
        zz = dict(z0=p0[2], z1=p1[2]) if (viewproj is not None) else {}
        draw_line_2d(image, p0[0], p0[1], p1[0], p1[1], color, alpha,
                     depth=depth if viewproj is not None else None, **zz)


def draw_fill(image, points, color=(255, 255, 255), alpha=1.0):
    """Even-odd scanline fill of a 2D polygon in screen space
    (reference: stencilmask/stencilfill overlay pair)."""
    pts = np.asarray(points, np.float32)
    h, w = image.shape[:2]
    y_min = max(int(np.floor(pts[:, 1].min())), 0)
    y_max = min(int(np.ceil(pts[:, 1].max())), h - 1)
    c = np.asarray(color, np.float32)
    x0s, y0s = pts[:, 0], pts[:, 1]
    x1s, y1s = np.roll(x0s, -1), np.roll(y0s, -1)
    for y in range(y_min, y_max + 1):
        yc = y + 0.5
        hitmask = (y0s <= yc) != (y1s <= yc)
        if not hitmask.any():
            continue
        t = (yc - y0s[hitmask]) / (y1s[hitmask] - y0s[hitmask])
        xs = np.sort(x0s[hitmask] + t * (x1s[hitmask] - x0s[hitmask]))
        for k in range(0, len(xs) - 1, 2):
            lo = max(int(np.ceil(xs[k] - 0.5)), 0)
            hi = min(int(np.floor(xs[k + 1] - 0.5)), w - 1)
            if hi >= lo:
                image[y, lo:hi + 1] = np.clip(
                    image[y, lo:hi + 1] * (1 - alpha) + c * alpha,
                    0, 255).astype(np.uint8)


def draw_bound(image, bound, viewproj, color=(255, 220, 60), alpha=0.8,
               depth=None):
    """AABB outline (the line_cube overlay)."""
    mn, mx = bound.min, bound.max
    c = np.array([[x, y, z] for x in (mn[0], mx[0])
                  for y in (mn[1], mx[1]) for z in (mn[2], mx[2])], np.float32)
    e = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
         (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    draw_lines(image, c[np.asarray(e)], viewproj, color, alpha, depth=depth)
