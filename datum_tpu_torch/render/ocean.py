"""Ocean resource: a dynamic FFT-displaced grid mesh (counterpart of
datum_tpu/render/ocean.py).

The Ocean's vertices are recomputed each frame from the evolving
Phillips spectrum on the context's device (the spectrum, its
frequencies and the base grid live there), and flow into the frame's
dynamic-vertex slab (`draws["dyn"]`, render/frame.py::patch_dynamic),
which shades through the standard passes with a water material."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import ocean as ocean_ops


@dataclasses.dataclass
class OceanParams:
    """Simulation and shading parameters."""
    wind: tuple = (8.0, 4.0)
    amplitude: float = 4e-4
    choppiness: float = 1.5
    swellamplitude: float = 0.0
    swelldirection: tuple = (1.0, 0.0)
    swellwavelength: float = 40.0
    flow: tuple = (0.0, 0.0)
    seed: int = 0
    # shading
    bumpscale: tuple = (1.0, 1.0, 1.0)
    foamplane: tuple = (0.0, 1.0, 0.0, 0.0)
    foamwaveheight: float = 1.0
    foamwavescale: float = 0.0
    foamshoreheight: float = 0.1
    foamshorescale: float = 0.0
    waterdepth: float = 20.0


class Ocean:
    """Grid mesh (added to ctx's pool) + spectrum state on ctx.device."""

    def __init__(self, ctx, grid=96, patch_size=64.0, spectrum_n=64,
                 params: OceanParams | None = None, material=None):
        self.params = params or OceanParams()
        self.patch_size = patch_size
        self.time = 0.0

        # base grid (grid x grid quads over patch_size)
        xs = np.linspace(0, patch_size, grid + 1, dtype=np.float32)
        gx, gz = np.meshgrid(xs, xs, indexing="xy")
        pos = np.stack([gx, np.zeros_like(gx), gz], -1).reshape(-1, 3)
        uv = np.stack([gx / patch_size, gz / patch_size], -1).reshape(-1, 2)
        n1 = grid + 1
        a = (np.arange(grid)[:, None] * n1 + np.arange(grid)[None, :]).ravel()
        idx = np.stack([a, a + n1, a + 1, a + 1, a + n1, a + n1 + 1], -1).reshape(-1)
        self.base_positions = pos
        self.mesh = ctx.add_mesh(
            dict(position=pos, texcoord=uv,
                 normal=np.tile([0, 1, 0.0], (len(pos), 1)),
                 tangent=np.tile([1, 0, 0, 1.0], (len(pos), 1))),
            idx.astype(np.int32),
            mincorner=[0, -4, 0], maxcorner=[patch_size, 4, patch_size])
        self.vertex_offset = int(ctx.pool.mesh_vtx_offset[self.mesh.mesh_id])
        self.vertexcount = len(pos)

        self.h0 = ocean_ops.phillips_spectrum(
            spectrum_n, patch_size, self.params.wind, self.params.amplitude,
            self.params.seed)
        self.kx, self.ky, self.k, self.omega = ocean_ops.wave_frequencies(
            spectrum_n, patch_size)
        self.material = material
        self.device = ctx.device
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self._spectrum_dev = tuple(dev(a) for a in (self.h0, self.kx, self.ky, self.k,
                                                     self.omega))
        self._base_dev = dev(pos)

    def _compute(self, t, cam_pos):
        """(positions, normals, lut texcoords) of the grid at time t (an
        f32 scalar tensor), on the context's device."""
        p = self.params
        # the flow scrolls the periodic displacement field under the grid
        base = self._base_dev.clone()
        base[:, 0] += p.flow[0] * t
        base[:, 2] += p.flow[1] * t
        disp, normal = ocean_ops.ocean_maps(*self._spectrum_dev, t, p.choppiness)
        swell = (p.swellamplitude, p.swelldirection[0],
                 p.swelldirection[1], p.swellwavelength)
        pos, nrm = ocean_ops.displace_grid(base, disp, normal, self.patch_size, swell)
        pos = pos - (base - self._base_dev)     # the flow moves waves, not the mesh
        uv = ocean_ops.ocean_lut_uv(
            pos, nrm, cam_pos, p.foamplane, p.foamwaveheight, p.foamwavescale,
            p.foamshoreheight, p.foamshorescale, waterdepth=p.waterdepth)
        return pos, nrm, uv

    def update(self, dt):
        """Advance the simulation time."""
        self.time += dt

    def vertex_data(self, max_dynamic, cam_pos=(0.0, 10.0, 0.0)):
        """dict(positions, normals, texcoords (tensors on the context's
        device, padded to max_dynamic rows), offset, count (numpy
        int32)): the frame's dynamic-vertex slab.  texcoords index a
        water_color_lut texture."""
        pad = max_dynamic - self.vertexcount
        if pad < 0:
            raise ValueError("ocean grid exceeds max_dynamic_vertices")
        f32 = dict(dtype=torch.float32, device=self.device)
        pos, nrm, uv = self._compute(torch.tensor(np.float32(self.time), **f32),
                                     torch.as_tensor(np.asarray(cam_pos, np.float32),
                                                     **f32))
        padz = lambda x: torch.nn.functional.pad(x, (0, 0, 0, pad))
        return dict(positions=padz(pos), normals=padz(nrm), texcoords=padz(uv),
                    offset=np.int32(self.vertex_offset),
                    count=np.int32(self.vertexcount))


def render_ocean_surface(ocean: Ocean, renderlist, transform, material,
                         translucent=False):
    """Queue the ocean for this frame: opaque through the main draws, or
    with translucent=True through the lit translucent layer (full shade,
    depth-aware transmission, refraction)."""
    if translucent:
        renderlist.push_translucent(ocean.mesh, transform, material)
    else:
        renderlist.push_mesh(ocean.mesh, transform, material)
    renderlist.oceans.append(ocean)
