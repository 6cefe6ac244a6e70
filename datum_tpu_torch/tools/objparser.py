"""OBJ -> pack mesh converter (counterpart of datum_tpu/tools/objparser.py).

Parses v/vt/vn/f records (negative indices count from the end), fans
polygons into triangles, deduplicates (v, vt, vn) vertices, computes
tangents, and normals where the OBJ has none; obj_to_pack writes the
mesh as an LZ4-compressed MESH asset.

    python -m datum_tpu_torch.tools.objparser IN.obj OUT.pack
"""

from __future__ import annotations

import numpy as np

from ..asset.pack import PackWriter, VERTEX_DTYPE


def parse_obj(text: str):
    """Returns (vertices VERTEX_DTYPE array, indices (K,) int32)."""
    positions, texcoords, normals = [], [], []
    vert_map: dict[tuple, int] = {}
    verts = []
    indices = []

    for line in text.splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "v":
            positions.append([float(x) for x in parts[1:4]])
        elif parts[0] == "vt":
            texcoords.append([float(parts[1]), float(parts[2])])
        elif parts[0] == "vn":
            normals.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            face = []
            for spec in parts[1:]:
                comps = spec.split("/")
                vi = int(comps[0])
                ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                key = (vi, ti, ni)
                if key not in vert_map:
                    vert_map[key] = len(verts)
                    p = positions[vi - 1 if vi > 0 else vi]
                    t = texcoords[ti - 1 if ti > 0 else ti] if ti else [0.0, 0.0]
                    n = normals[ni - 1 if ni > 0 else ni] if ni else [0.0, 0.0, 1.0]
                    verts.append((p, t, n))
                face.append(vert_map[key])
            for k in range(1, len(face) - 1):     # fan-triangulate
                indices += [face[0], face[k], face[k + 1]]

    out = np.zeros(len(verts), VERTEX_DTYPE)
    for i, (p, t, n) in enumerate(verts):
        out["position"][i] = p
        out["texcoord"][i] = t
        out["normal"][i] = n
    idx = np.asarray(indices, np.int32)
    compute_tangents(out, idx)
    if not normals:
        compute_normals(out, idx)
    return out, idx


def compute_normals(verts, indices):
    pos = verts["position"]
    tris = indices.reshape(-1, 3)
    fn = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]], pos[tris[:, 2]] - pos[tris[:, 0]])
    acc = np.zeros_like(pos)
    for c in range(3):
        np.add.at(acc, tris[:, c], fn)
    n = np.linalg.norm(acc, axis=1, keepdims=True)
    verts["normal"] = acc / np.maximum(n, 1e-9)


def compute_tangents(verts, indices):
    """Lengyel-style per-face tangent accumulation."""
    pos = verts["position"]
    uv = verts["texcoord"]
    nrm = verts["normal"]
    tris = indices.reshape(-1, 3)
    e1 = pos[tris[:, 1]] - pos[tris[:, 0]]
    e2 = pos[tris[:, 2]] - pos[tris[:, 0]]
    du1 = uv[tris[:, 1]] - uv[tris[:, 0]]
    du2 = uv[tris[:, 2]] - uv[tris[:, 0]]
    r = du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]
    r = np.where(np.abs(r) < 1e-12, 1.0, r)
    t = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) / r[:, None]
    acc = np.zeros_like(pos)
    for c in range(3):
        np.add.at(acc, tris[:, c], t)
    # orthogonalize against normals
    acc -= nrm * np.sum(acc * nrm, axis=1, keepdims=True)
    ln = np.linalg.norm(acc, axis=1, keepdims=True)
    tan = np.where(ln > 1e-9, acc / np.maximum(ln, 1e-9), [1.0, 0.0, 0.0])
    verts["tangent"][:, :3] = tan
    verts["tangent"][:, 3] = 1.0


def obj_to_pack(obj_path, pack_path, asset_id=0):
    with open(obj_path) as f:
        verts, idx = parse_obj(f.read())
    w = PackWriter()
    w.write_mesh(asset_id, verts, idx, verts["position"].min(0),
                 verts["position"].max(0), compress=True)
    w.save(pack_path)
    return len(verts), len(idx) // 3


if __name__ == "__main__":
    import sys

    v, t = obj_to_pack(sys.argv[1], sys.argv[2])
    print(f"wrote {sys.argv[2]}: {v} vertices, {t} triangles")
