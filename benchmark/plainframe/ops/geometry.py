"""Vertex stage (counterpart of datum_tpu/ops/geometry.py): the rigid
vertex transform, 4-bone dual-quaternion skinning, the terrain geomorph
and the foliage wind bends.  Plain PyTorch: the JAX package computes
them as jnp outside any Pallas kernel."""

from __future__ import annotations

import torch

from .common import fma


def quat_mul(a, b):
    """Hamilton product of quaternions (..., 4) [w, x, y, z]."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def dq_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4) [w,x,y,z]."""
    qv = q[..., 1:4]
    uv = torch.linalg.cross(qv, v, dim=-1)
    uuv = torch.linalg.cross(qv, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def dq_apply(real, dual, v):
    """Apply the dual-quaternion rigid transform (real, dual) to points v."""
    t = 2.0 * quat_mul(dual, quat_conj(real))[..., 1:4]
    return dq_rotate(real, v) + t


def skin_vertices(positions, normals, tangents, bone_idx, bone_wt,
                  palettes_flat, pal_of_vertex, max_bones):
    """4-bone dual-quat skinning with flat palette rows.

    palettes_flat: (P*B, 8); pal_of_vertex: (V,) palette of each vertex;
    bone_idx (V, 4) int, bone_wt (V, 4).  Gathers 4 palette rows a
    vertex; a row index outside the table reads the row the JAX
    package's gather reads: a negative index counts from the end (as in
    numpy), and the result is clamped into [0, P*B).  Each row joins the first row's hemisphere
    (sign(dot + 1e-20)), the weights scale the rows before the sum, and
    the blend is normalised by its real part's norm (floor 1e-8).
    Returns (positions, normals, tangents (V, 4) with w kept)."""
    n = palettes_flat.shape[0]
    row = pal_of_vertex.long()[:, None] * max_bones + bone_idx.long()
    row = torch.where(row < 0, row + n, row).clamp(0, n - 1)
    rows = palettes_flat[row]                                      # (V, 4, 8)
    ref = rows[:, 0:1, :4]
    sign = torch.sign(torch.sum(rows[..., :4] * ref, dim=-1, keepdim=True) + 1e-20)
    w = (bone_wt * sign[..., 0])[..., None]
    blended = torch.sum(rows * w, dim=1)
    real, dual = blended[:, :4], blended[:, 4:]
    ln = torch.clamp(torch.linalg.norm(real, dim=-1, keepdim=True), min=1e-8)
    real = real / ln
    dual = dual / ln
    skinned = dq_apply(real, dual, positions)
    sn = dq_rotate(real, normals)
    st = dq_rotate(real, tangents[:, :3])
    return skinned, sn, torch.cat([st, tangents[:, 3:4]], -1)


def transform_vertices_skinned(positions, normals, tangents, vtx_instance,
                               bone_idx, bone_wt, palettes, inst_world, viewproj):
    """Skinned path: p' = blend(palette)(p), then the rigid instance
    transform.  palettes: (I, B, 8) per-instance bone dual-quats (composed
    with the bind pose by the host Animator)."""
    max_bones = palettes.shape[1]
    skinned, sn, st = skin_vertices(positions, normals, tangents, bone_idx,
                                    bone_wt, palettes.reshape(-1, 8),
                                    vtx_instance, max_bones)
    return transform_vertices_rigid(skinned, sn, st, vtx_instance, inst_world,
                                    viewproj)


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


def _dot3(p, w):
    """p @ w for (V, 3) p and a (3,) w as XLA's CPU dot rounds it (the
    JAX package's result on the CPU): fma(p2, w2, fma(p1, w1, p0 * w0)),
    each fma rounded once (ops/common.py::fma).  The detail bend's
    floor-mod of phases up to ~100 turns an ulp of the phase into ~1e-4
    of displacement, so the plain f32 dot would not hold the reference."""
    return fma(p[:, 2], w[2], fma(p[:, 1], w[1], p[:, 0] * w[0]))


def wind_bend(positions, wind, scale):
    """Main foliage bend: a bend factor from the height, renormalised to
    keep each vertex's distance from the pivot (norm floor 1e-9).

    positions: (V, 3) local mesh-space positions; wind: (3,) direction *
    strength; scale: (3,) height weighting (typically (0, 1/h, 0))."""
    f32 = dict(dtype=torch.float32, device=positions.device)
    bf = _dot3(positions, torch.as_tensor(scale, **f32))
    bf = bf + 1.0
    bf = bf * bf
    bf = bf * bf - bf
    bent = positions + torch.as_tensor(wind, **f32) * bf[:, None]
    ln = torch.linalg.norm(positions, dim=-1, keepdim=True)
    bln = torch.clamp(torch.linalg.norm(bent, dim=-1, keepdim=True), min=1e-9)
    return bent / bln * ln


def wind_detail_bend(positions, world_anchor, time, wind, scale):
    """Per-vertex flutter: two incommensurate triangle waves phased by
    dot(v, vec3(sum(anchor))), the reference's exact formula, including
    its degenerate case (anchor components summing to 0: one phase for
    every vertex).  The frame's vertex stage inlines the same math in
    another rounding (render/frame.py::_foliage_bend)."""
    f32 = dict(dtype=torch.float32, device=positions.device)
    anchor_sum = torch.sum(torch.as_tensor(world_anchor, **f32))
    phase = _dot3(positions, anchor_sum.expand(3))
    w = torch.stack([(time + phase) * 1.975, (time + phase) * 0.793], -1)
    waves = torch.remainder(w, 1.0) * 2.0 - 1.0
    waves = torch.abs(torch.remainder(waves + 0.5, 1.0) * 2.0 - 1.0)
    waves = waves * waves * (3.0 - 2.0 * waves)
    wavesum = waves.sum(-1)
    hf = _dot3(positions, torch.as_tensor(scale, **f32))
    return positions + torch.as_tensor(wind, **f32) * (wavesum * hf)[:, None]
