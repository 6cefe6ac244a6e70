"""Pack inspector (counterpart of datum_tpu/tools/assetdump.py): lists a
pack's assets with their metadata, in the JAX tool's text.

    python -m datum_tpu_torch.tools.assetdump PACK [PACK ...]
"""

from __future__ import annotations

from ..asset.pack import PackReader


def dump(path):
    pack = PackReader(path)
    lines = [f"{path}: {len(pack.assets)} assets"]
    for aid, info in sorted(pack.assets.items()):
        desc = f"  [{aid:4d}] {info.type.upper():5s} size={info.datasize}"
        f = info.fields
        if info.type == "mesh":
            desc += (f" verts={f['vertexcount']} tris={f['indexcount'] // 3}"
                     f" bones={f['bonecount']}")
        elif info.type == "imag":
            desc += (f" {f['width']}x{f['height']} layers={f['layers']}"
                     f" levels={f['levels']} fmt={f['format']}")
        elif info.type == "anim":
            desc += f" dur={f['duration']:.2f}s joints={f['jointcount']}"
        elif info.type == "catl":
            desc += f" magic={f['magic']:#x} ver={f['version']}"
        elif info.type == "modl":
            desc += (f" tex={f['texturecount']} mat={f['materialcount']}"
                     f" mesh={f['meshcount']} inst={f['instancecount']}")
        lines.append(desc)
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    for p in sys.argv[1:]:
        print(dump(p))
