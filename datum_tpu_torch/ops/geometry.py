"""Vertex stage: rigid vertex transform and the terrain geomorph
(counterpart of datum_tpu/ops/geometry.py::transform_vertices_rigid and
terrain_morph; skinning waits for the slice that enables it)."""

from __future__ import annotations

import torch


def terrain_morph(positions, normals, morph6, vtx_draw, world, morph_range,
                  campos):
    """Terrain LOD geomorph: each vertex moves toward its baked
    coarse-grid target by alpha = smoothstep(morphbeg, morphend, the
    horizontal (x, z) distance to the camera in the draw's local space).

    morph6: (V, 6) local position and normal deltas to the target;
    vtx_draw: (V,) draw of each vertex; world: (D, 3, 4) rigid affines;
    morph_range: (D, 2) [morphbeg, morphend], end <= 0 leaves the draw
    unmorphed; campos: (3,) world camera position.  Returns (positions,
    unit normals)."""
    R = world[:, :, :3]
    t = world[:, :, 3]
    cam_local = torch.einsum("dji,dj->di", R, campos[None, :] - t)   # R^T (c - t)
    vd = vtx_draw.long()
    cl = cam_local[vd]
    beg = morph_range[vd, 0]
    end = morph_range[vd, 1]
    dx = positions[:, 0] - cl[:, 0]
    dz = positions[:, 2] - cl[:, 2]
    d = torch.sqrt(dx * dx + dz * dz)
    tt = torch.clamp((d - beg) / torch.clamp(end - beg, min=1e-6), 0.0, 1.0)
    alpha = tt * tt * (3.0 - 2.0 * tt)
    alpha = torch.where(end > 0, alpha, torch.zeros_like(alpha))[:, None]
    positions = positions + morph6[:, :3] * alpha
    nrm = normals + morph6[:, 3:6] * alpha
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True), min=1e-9)
    return positions, nrm


def transform_vertices_rigid(positions, normals, tangents, vtx_instance,
                             inst_world, viewproj):
    """world = M_inst * p; clip = VP * world.

    positions: (V, 3); vtx_instance: (V,) int32; inst_world: (I, 3, 4);
    viewproj: (4, 4).  Returns clip (V,4), wnormal (V,3), wtangent (V,4),
    world (V,3)."""
    V = positions.shape[0]
    M = inst_world[vtx_instance.long()].reshape(V, 12).T       # (12, V)
    pT, nT, tT = positions.T, normals.T, tangents.T
    wx = M[0] * pT[0] + M[1] * pT[1] + M[2] * pT[2] + M[3]
    wy = M[4] * pT[0] + M[5] * pT[1] + M[6] * pT[2] + M[7]
    wz = M[8] * pT[0] + M[9] * pT[1] + M[10] * pT[2] + M[11]
    nx = M[0] * nT[0] + M[1] * nT[1] + M[2] * nT[2]
    ny = M[4] * nT[0] + M[5] * nT[1] + M[6] * nT[2]
    nz = M[8] * nT[0] + M[9] * nT[1] + M[10] * nT[2]
    tx = M[0] * tT[0] + M[1] * tT[1] + M[2] * tT[2]
    ty = M[4] * tT[0] + M[5] * tT[1] + M[6] * tT[2]
    tz = M[8] * tT[0] + M[9] * tT[1] + M[10] * tT[2]
    vp = viewproj
    clip = torch.stack([vp[0, 0] * wx + vp[0, 1] * wy + vp[0, 2] * wz + vp[0, 3],
                        vp[1, 0] * wx + vp[1, 1] * wy + vp[1, 2] * wz + vp[1, 3],
                        vp[2, 0] * wx + vp[2, 1] * wy + vp[2, 2] * wz + vp[2, 3],
                        vp[3, 0] * wx + vp[3, 1] * wy + vp[3, 2] * wz + vp[3, 3]],
                       dim=-1)
    world = torch.stack([wx, wy, wz], dim=-1)
    wn = torch.stack([nx, ny, nz], dim=-1)
    wtangent = torch.stack([tx, ty, tz, tT[3]], dim=-1)
    return clip, wn, wtangent, world
