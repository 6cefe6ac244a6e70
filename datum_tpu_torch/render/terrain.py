"""Terrain LOD geomorph targets (counterpart of
datum_tpu/render/terrain.py::grid_morph_targets).

Each grid vertex gets a baked target: the vertex of its floor-snapped
coarse-grid corner.  The vertex stage (ops/geometry.terrain_morph) blends
toward it by camera distance when FrameConfig.enable_terrain_morph is
on; RenderList.push_terrain sets the distances."""

from __future__ import annotations

import numpy as np


def grid_morph_targets(pos_grid, nrm_grid, morph_grid):
    """(positions (h*w, 3), normals (h*w, 3)) of each (h, w) grid
    vertex's morph_grid-aligned coarse corner.  Grids of n*g + 1 vertices
    keep their boundary fixed (the last row and column are g-aligned)."""
    h, w = pos_grid.shape[:2]
    ii = (np.arange(h) // morph_grid) * morph_grid
    jj = (np.arange(w) // morph_grid) * morph_grid
    return (pos_grid[ii][:, jj].reshape(-1, 3),
            nrm_grid[ii][:, jj].reshape(-1, 3))
