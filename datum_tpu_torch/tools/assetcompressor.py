"""Pack re-compressor (counterpart of datum_tpu/tools/assetcompressor.py):
rewrites each DATA chunk as an LZ4 CDAT chunk (kept raw where that would
not be smaller) and patches the dataoffset of the header chunk before it.

    python -m datum_tpu_torch.tools.assetcompressor IN.pack OUT.pack
"""

from __future__ import annotations

import struct

from ..asset.pack import SIGNATURE, _fast_checksum, cdat_blocks


def compress_pack(src_path, dst_path):
    with open(src_path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError("not a pack file")

    # first pass: parse chunk list
    chunks = []
    pos = 8
    while pos + 8 <= len(data):
        length, = struct.unpack_from("<I", data, pos)
        tag = data[pos + 4:pos + 8]
        chunks.append((pos, length, tag))
        if tag == b"HEND":
            break
        pos = pos + 8 + length + 4

    # second pass: rewrite, tracking dataoffset fixups per asset: the
    # typed header chunk immediately precedes its DATA chunk, so patch
    # its trailing dataoffset (u64) after we know the new position.
    out = bytearray(SIGNATURE)
    pending_header = None   # (out_pos, tag, length)
    for pos, length, tag in chunks:
        body = data[pos + 8:pos + 8 + length]
        if tag == b"DATA":
            payload = body
            blocks = cdat_blocks(payload)
            if len(blocks) < len(payload):
                _patch_dataoffset(out, pending_header, len(out))
                _write_chunk(out, b"CDAT", blocks)
            else:       # incompressible: keep raw
                _patch_dataoffset(out, pending_header, len(out))
                _write_chunk(out, b"DATA", payload)
            pending_header = None
        else:
            if tag in (b"CATL", b"TEXT", b"IMAG", b"MESH", b"FONT", b"MATL",
                       b"ANIM", b"PART", b"MODL"):
                pending_header = (len(out), tag, length)
            _write_chunk(out, tag, body)
    with open(dst_path, "wb") as f:
        f.write(bytes(out))
    return len(data), len(out)


def _write_chunk(out, tag, payload):
    out += struct.pack("<I", len(payload))
    out += tag
    out += payload
    out += struct.pack("<I", _fast_checksum(bytes(payload)))


_OFFSET_POS = {b"CATL": 12, b"TEXT": 4, b"IMAG": 24, b"MESH": 40, b"FONT": 16,
               b"MATL": 0, b"ANIM": 12, b"PART": 36, b"MODL": 16}


def _patch_dataoffset(out, pending, new_offset):
    if pending is None:
        return
    hpos, tag, length = pending
    field = _OFFSET_POS.get(tag)
    if field is None:
        return
    at = hpos + 8 + field
    out[at:at + 8] = struct.pack("<Q", new_offset)
    # re-checksum the header chunk payload
    payload = bytes(out[hpos + 8:hpos + 8 + length])
    out[hpos + 8 + length:hpos + 12 + length] = struct.pack(
        "<I", _fast_checksum(payload))


if __name__ == "__main__":
    import sys

    src, dst = sys.argv[1], sys.argv[2]
    a, b = compress_pack(src, dst)
    print(f"{src}: {a} -> {b} bytes ({100 * b // max(a, 1)}%)")
