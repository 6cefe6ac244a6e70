"""RenderList: the per-frame draw-building facade (counterpart of
datum_tpu/render/renderlist.py, trimmed to the opaque slice: meshes,
point lights, spot lights and the draw arrays)."""

from __future__ import annotations

import numpy as np

from datum_tpu.math import Transform


class RenderList:
    def __init__(self):
        self.draws = []          # dict(mesh, transform(3,4), material)
        self.point_lights = []
        self.spot_lights = []

    def push_mesh(self, mesh, transform, material):
        self.draws.append(dict(mesh=mesh.mesh_id, transform=_to_affine(transform),
                               material=material))

    def push_pointlight(self, position, intensity, attenuation=(1.0, 0.0, 0.0, 0.0),
                        range_=None):
        att = np.asarray(attenuation, np.float32).copy()
        if att.shape == (3,):
            att = np.append(att, range_ if range_ is not None else _attenuation_range(att))
        elif range_ is not None:
            att[3] = range_
        elif att[3] == 0:
            att[3] = _attenuation_range(att[:3])
        self.point_lights.append(dict(position=np.asarray(position, np.float32),
                                      intensity=np.asarray(intensity, np.float32),
                                      attenuation=att))

    def push_spotlight(self, position, direction, intensity, cutoff=0.7,
                       attenuation=(1.0, 0.0, 0.0, 0.0), range_=None):
        att = np.asarray(attenuation, np.float32).copy()
        if att.shape == (3,):
            att = np.append(att, range_ if range_ is not None else _attenuation_range(att))
        d = np.asarray(direction, np.float32)
        d = d / max(np.linalg.norm(d), 1e-9)
        self.spot_lights.append(dict(position=np.asarray(position, np.float32),
                                     direction=d,
                                     intensity=np.asarray(intensity, np.float32),
                                     attenuation=att, cutoff=float(cutoff)))

    def draw_arrays(self, max_draws, default_material):
        """Fixed-capacity draw arrays (the JAX package's draw_arrays
        without skinning palettes, which the slice rejects)."""
        mesh = np.zeros(max_draws, np.int32)
        world = np.zeros((max_draws, 3, 4), np.float32)
        world[:, :, :3] = np.eye(3)
        material = np.full(max_draws, default_material, np.int32)
        n = min(len(self.draws), max_draws)
        for i, d in enumerate(self.draws[:n]):
            mesh[i] = d["mesh"]
            world[i] = d["transform"]
            material[i] = d["material"]
        return dict(mesh=mesh, world=world, material=material, count=np.int32(n),
                    wind=np.zeros((max_draws, 4), np.float32),
                    bendscale=np.zeros((max_draws, 3), np.float32),
                    detailbendscale=np.zeros((max_draws, 3), np.float32),
                    morph_range=np.zeros((max_draws, 2), np.float32))


def _to_affine(transform):
    if isinstance(transform, Transform):
        return transform.matrix()[:3, :].astype(np.float32)
    m = np.asarray(transform, np.float32)
    if m.shape == (4, 4):
        return m[:3, :]
    return m.reshape(3, 4)


def _attenuation_range(att):
    """Range where the attenuated intensity falls to ~1/255."""
    q, l, c = float(att[0]), float(att[1]), float(att[2])
    if q > 1e-9:
        return (-l + np.sqrt(l * l - 4 * q * (c - 255.0))) / (2 * q)
    if l > 1e-9:
        return (255.0 - c) / l
    return 1e4
