"""Binary .pack asset container: reader and writer (counterpart of
datum_tpu/asset/pack.py; the wire format is the contract, and the port's
writer produces the JAX writer's bytes exactly).

Layout: 8-byte signature D9 'S' 'V' 'A' 0D 0A 1A 0A, then chunks of
{u32 length, u32 fourcc, payload[length], u32 checksum}; each asset is
ASET -> typed header chunk (CATL/TEXT/IMAG/MESH/FONT/MATL/ANIM/PART/
MODL) -> DATA or CDAT -> AEND; the file ends with HEND.  The typed
header carries a u64 dataoffset pointing at its DATA/CDAT chunk header.
CDAT holds 16384-byte blocks {u32 csize, u8 data[16380]} of LZ4 (the
last block trimmed).  The chunk checksum XORs each payload byte shifted
left by i % 4 bits; ANIM and MODL payloads open with a 1-byte pad (the
size of an empty C++ struct).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import lz4

SIGNATURE = bytes([0xD9, ord("S"), ord("V"), ord("A"), 0x0D, 0x0A, 0x1A, 0x0A])

BLOCK_DATA = 16380
BLOCK_SIZE = 16384

VERTEX_DTYPE = np.dtype([
    ("position", np.float32, 3),
    ("texcoord", np.float32, 2),
    ("normal", np.float32, 3),
    ("tangent", np.float32, 4),
])

RIG_DTYPE = np.dtype([("bone", np.uint32, 4), ("weight", np.float32, 4)])
BONE_DTYPE = np.dtype([("name", "S32"), ("transform", np.float32, 8)])


def fourcc(s: str) -> int:
    return struct.unpack("<I", s.encode())[0]


def chunk_checksum(data: bytes) -> int:
    # XOR of payload bytes shifted by (i % 4)*8 is NOT what the reference
    # does — it shifts by (i % 4) bit positions (tools/assetpacker.cpp:74).
    c = 0
    for i, b in enumerate(data):
        c ^= b << (i % 4)
    return c & 0xFFFFFFFF


def _fast_checksum(data: bytes) -> int:
    # vectorized chunk_checksum
    a = np.frombuffer(data, np.uint8)
    c = 0
    for s in range(4):
        part = a[s::4]
        x = np.bitwise_xor.reduce(part.astype(np.uint32)) if part.size else 0
        c ^= int(x) << s
    return c & 0xFFFFFFFF


IMAGE_RGBA = 0
IMAGE_RGBA_BC3 = 3
IMAGE_RGBE = 5
IMAGE_F32 = 11


@dataclass
class AssetInfo:
    id: int
    type: str            # 'catl' | 'text' | 'imag' | 'mesh' | 'font' | 'matl' | 'anim' | 'part' | 'modl'
    datasize: int = 0
    dataoffset: int = 0
    fields: dict = field(default_factory=dict)


class PackReader:
    """Parses a .pack chunk directory and decodes payloads on demand."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            self._data = bytes(path_or_bytes)
            self.path = None
        else:
            with open(path_or_bytes, "rb") as f:
                self._data = f.read()
            self.path = str(path_or_bytes)
        if self._data[:8] != SIGNATURE:
            raise ValueError("invalid pack signature")
        self.assets: dict[int, AssetInfo] = {}
        self._parse()

    def _parse(self):
        pos = 8
        current: Optional[AssetInfo] = None
        data = self._data
        while pos + 8 <= len(data):
            length, ctype = struct.unpack_from("<II", data, pos)
            body = pos + 8
            tag = data[pos + 4:pos + 8].decode("latin1")
            if tag == "HEND":
                break
            if tag == "ASET":
                (aid,) = struct.unpack_from("<I", data, body)
                current = AssetInfo(id=aid, type="")
            elif tag == "CATL":
                magic, version, datasize, dataoffset = struct.unpack_from("<IIIQ", data, body)
                current.type = "catl"
                current.datasize, current.dataoffset = datasize, dataoffset
                current.fields = dict(magic=magic, version=version)
            elif tag == "TEXT":
                tlen, dataoffset = struct.unpack_from("<IQ", data, body)
                current.type = "text"
                current.datasize, current.dataoffset = tlen, dataoffset
            elif tag == "IMAG":
                w, h, layers, levels, fmt, datasize, dataoffset = struct.unpack_from("<IIIIIIQ", data, body)
                current.type = "imag"
                current.datasize, current.dataoffset = datasize, dataoffset
                current.fields = dict(width=w, height=h, layers=layers, levels=levels, format=fmt)
            elif tag == "MESH":
                vc, ic, bc = struct.unpack_from("<III", data, body)
                mn = struct.unpack_from("<3f", data, body + 12)
                mx = struct.unpack_from("<3f", data, body + 24)
                datasize, dataoffset = struct.unpack_from("<IQ", data, body + 36)
                current.type = "mesh"
                current.datasize, current.dataoffset = datasize, dataoffset
                current.fields = dict(vertexcount=vc, indexcount=ic, bonecount=bc,
                                      mincorner=np.array(mn, np.float32),
                                      maxcorner=np.array(mx, np.float32))
            elif tag == "FONT":
                ascent, descent, leading, glyphcount, dataoffset = struct.unpack_from("<IIIIQ", data, body)
                current.type = "font"
                current.dataoffset = dataoffset
                current.datasize = 4 + 6 * glyphcount * 2 + glyphcount * glyphcount
                current.fields = dict(ascent=ascent, descent=descent, leading=leading,
                                      glyphcount=glyphcount)
            elif tag == "MATL":
                (dataoffset,) = struct.unpack_from("<Q", data, body)
                current.type = "matl"
                current.datasize, current.dataoffset = 44, dataoffset
            elif tag == "ANIM":
                duration, jointcount, transformcount, dataoffset = struct.unpack_from("<fIIQ", data, body)
                current.type = "anim"
                current.dataoffset = dataoffset
                # leading pad byte: reference payload struct is empty, and
                # sizeof(empty struct)==1 in C++ (src/assetpack.h:227-254)
                current.datasize = 1 + jointcount * 44 + transformcount * 36
                current.fields = dict(duration=duration, jointcount=jointcount,
                                      transformcount=transformcount)
            elif tag == "PART":
                mn = struct.unpack_from("<3f", data, body)
                mx = struct.unpack_from("<3f", data, body + 12)
                maxparticles, emittercount, emitterssize, dataoffset = struct.unpack_from("<IIIQ", data, body + 24)
                current.type = "part"
                current.dataoffset = dataoffset
                current.datasize = 4 + emitterssize
                current.fields = dict(minrange=np.array(mn, np.float32),
                                      maxrange=np.array(mx, np.float32),
                                      maxparticles=maxparticles, emittercount=emittercount,
                                      emitterssize=emitterssize)
            elif tag == "MODL":
                tc, mc, shc, ic, dataoffset = struct.unpack_from("<IIIIQ", data, body)
                current.type = "modl"
                current.dataoffset = dataoffset
                current.datasize = 1 + tc * 8 + mc * 44 + shc * 4 + ic * 44  # 1-byte pad, see ANIM
                current.fields = dict(texturecount=tc, materialcount=mc, meshcount=shc,
                                      instancecount=ic)
            elif tag == "AEND":
                if current is not None:
                    self.assets[current.id] = current
                current = None
            # DATA/CDAT chunks are skipped here; payloads are read on demand
            pos = body + length + 4

    # --- payload access ---------------------------------------------------
    def payload(self, asset_id: int) -> bytes:
        info = self.assets[asset_id]
        pos = info.dataoffset
        length, ctype = struct.unpack_from("<II", self._data, pos)
        tag = self._data[pos + 4:pos + 8].decode("latin1")
        body = pos + 8
        if tag == "DATA":
            if length != info.datasize:
                raise ValueError(f"asset {asset_id}: DATA size mismatch")
            return self._data[body:body + length]
        if tag == "CDAT":
            # each block decodes straight into the payload's buffer, capped
            # at what the payload has left
            out = bytearray(info.datasize)
            n_out = 0
            remaining = length
            cursor = body
            while remaining > 0:
                nbytes = min(BLOCK_SIZE, remaining)
                (csize,) = struct.unpack_from("<I", self._data, cursor)
                n_out += lz4.decompress_into(self._data, cursor + 4, csize, out, n_out)
                cursor += nbytes
                remaining -= nbytes
            return bytes(memoryview(out)[:n_out])
        raise ValueError(f"asset {asset_id}: unhandled data chunk {tag!r}")

    # --- typed decoders ---------------------------------------------------
    def catalog(self, asset_id: int = 0) -> dict[int, str]:
        data = self.payload(asset_id)
        entrycount, stringslength = struct.unpack_from("<II", data, 0)
        entries = {}
        off = 8
        strbase = off + entrycount * 12
        for _ in range(entrycount):
            aid, pathindex, pathlength = struct.unpack_from("<III", data, off)
            off += 12
            entries[aid] = data[strbase + pathindex:strbase + pathindex + pathlength].decode()
        return entries

    def text(self, asset_id: int) -> bytes:
        return self.payload(asset_id)

    def mesh(self, asset_id: int):
        info = self.assets[asset_id]
        vc, ic, bc = (info.fields[k] for k in ("vertexcount", "indexcount", "bonecount"))
        data = self.payload(asset_id)
        verts = np.frombuffer(data, VERTEX_DTYPE, vc, 0)
        indices = np.frombuffer(data, np.uint32, ic, vc * VERTEX_DTYPE.itemsize)
        result = dict(
            vertices=verts, indices=indices,
            mincorner=info.fields["mincorner"], maxcorner=info.fields["maxcorner"],
        )
        if bc:
            rig_off = vc * VERTEX_DTYPE.itemsize + ic * 4
            result["rig"] = np.frombuffer(data, RIG_DTYPE, vc, rig_off)
            result["bones"] = np.frombuffer(data, BONE_DTYPE, bc, rig_off + vc * RIG_DTYPE.itemsize)
        return result

    def image(self, asset_id: int):
        """Returns dict with raw mip chain as uint32/float32 arrays per level."""
        info = self.assets[asset_id]
        f = info.fields
        data = self.payload(asset_id)
        w, h, layers, levels, fmt = f["width"], f["height"], f["layers"], f["levels"], f["format"]
        mips = []
        off = 0
        mw, mh = w, h
        for _ in range(levels):
            if fmt == IMAGE_RGBA_BC3:
                nblocks = ((mw + 3) // 4) * ((mh + 3) // 4) * layers
                mips.append(np.frombuffer(data, np.uint8, nblocks * 16, off).copy())
                off += nblocks * 16
            elif fmt == IMAGE_F32:
                count = mw * mh * layers
                mips.append(np.frombuffer(data, np.float32, count, off).reshape(layers, mh, mw).copy())
                off += count * 4
            else:
                count = mw * mh * layers
                mips.append(np.frombuffer(data, np.uint32, count, off).reshape(layers, mh, mw).copy())
                off += count * 4
            mw, mh = max(1, mw // 2), max(1, mh // 2)
        return dict(width=w, height=h, layers=layers, levels=levels, format=fmt, mips=mips)

    def material(self, asset_id: int):
        data = self.payload(asset_id)
        color = struct.unpack_from("<4f", data, 0)
        metalness, roughness, reflectivity, emissive = struct.unpack_from("<4f", data, 16)
        albedomap, surfacemap, normalmap = struct.unpack_from("<III", data, 32)
        return dict(color=np.array(color, np.float32), metalness=metalness, roughness=roughness,
                    reflectivity=reflectivity, emissive=emissive,
                    albedomap=albedomap, surfacemap=surfacemap, normalmap=normalmap)

    def animation(self, asset_id: int):
        info = self.assets[asset_id]
        jc, tc = info.fields["jointcount"], info.fields["transformcount"]
        data = self.payload(asset_id)
        joints = []
        off = 1  # skip empty-struct pad byte
        for _ in range(jc):
            name = data[off:off + 32].split(b"\0")[0].decode()
            parent, index, count = struct.unpack_from("<III", data, off + 32)
            joints.append(dict(name=name, parent=parent, index=index, count=count))
            off += 44
        times = np.zeros(tc, np.float32)
        transforms = np.zeros((tc, 8), np.float32)
        for i in range(tc):
            vals = struct.unpack_from("<9f", data, off)
            times[i] = vals[0]
            transforms[i] = vals[1:]
            off += 36
        return dict(duration=info.fields["duration"], joints=joints, times=times,
                    transforms=transforms)

    def model(self, asset_id: int):
        info = self.assets[asset_id]
        f = info.fields
        data = self.payload(asset_id)
        off = 1  # skip empty-struct pad byte
        textures = []
        for _ in range(f["texturecount"]):
            ttype, tex = struct.unpack_from("<II", data, off)
            textures.append(dict(type=ttype, texture=tex))
            off += 8
        materials = []
        for _ in range(f["materialcount"]):
            color = struct.unpack_from("<4f", data, off)
            metalness, roughness, reflectivity, emissive = struct.unpack_from("<4f", data, off + 16)
            albedomap, surfacemap, normalmap = struct.unpack_from("<III", data, off + 32)
            materials.append(dict(color=np.array(color, np.float32), metalness=metalness,
                                  roughness=roughness, reflectivity=reflectivity,
                                  emissive=emissive, albedomap=albedomap,
                                  surfacemap=surfacemap, normalmap=normalmap))
            off += 44
        meshes = []
        for _ in range(f["meshcount"]):
            (m,) = struct.unpack_from("<I", data, off)
            meshes.append(m)
            off += 4
        instances = []
        for _ in range(f["instancecount"]):
            mesh, material = struct.unpack_from("<II", data, off)
            transform = np.array(struct.unpack_from("<8f", data, off + 8), np.float32)
            (childcount,) = struct.unpack_from("<I", data, off + 40)
            instances.append(dict(mesh=mesh, material=material, transform=transform,
                                  childcount=childcount))
            off += 44
        return dict(textures=textures, materials=materials, meshes=meshes, instances=instances)

    def font(self, asset_id: int):
        info = self.assets[asset_id]
        n = info.fields["glyphcount"]
        data = self.payload(asset_id)
        (glyphatlas,) = struct.unpack_from("<I", data, 0)
        off = 4
        arrays = {}
        for name, dt in (("x", np.uint16), ("y", np.uint16), ("width", np.uint16),
                         ("height", np.uint16), ("offsetx", np.int16), ("offsety", np.int16)):
            arrays[name] = np.frombuffer(data, dt, n, off).copy()
            off += n * 2
        arrays["advance"] = np.frombuffer(data, np.uint8, n * n, off).reshape(n, n).copy()
        return dict(glyphatlas=glyphatlas, glyphcount=n, ascent=info.fields["ascent"],
                    descent=info.fields["descent"], leading=info.fields["leading"], **arrays)

    def particlesystem(self, asset_id: int):
        info = self.assets[asset_id]
        data = self.payload(asset_id)
        (spritesheet,) = struct.unpack_from("<I", data, 0)
        return dict(spritesheet=spritesheet, emitters=data[4:], **info.fields)


def cdat_blocks(payload: bytes) -> bytes:
    """A CDAT chunk's payload: LZ4 blocks of {u32 csize, data}, each
    compressed to at most BLOCK_DATA bytes and padded to BLOCK_SIZE,
    except the last."""
    payload = bytes(payload)
    blocks = []
    pos = 0
    while pos < len(payload):
        cdata, consumed = lz4.compress(payload, BLOCK_DATA, start=pos)
        if consumed == 0:
            raise ValueError("an LZ4 block took no input")
        pos += consumed
        block = struct.pack("<I", len(cdata)) + cdata
        if pos < len(payload):
            block = block.ljust(BLOCK_SIZE, b"\0")
        blocks.append(block)
    return b"".join(blocks)


class PackWriter:
    """Writes .pack files byte-compatible with the reference tooling."""

    def __init__(self):
        self._buf = io.BytesIO()
        self._buf.write(SIGNATURE)

    def _chunk(self, tag: str, payload: bytes):
        self._buf.write(struct.pack("<I", len(payload)))
        self._buf.write(tag.encode())
        self._buf.write(payload)
        self._buf.write(struct.pack("<I", _fast_checksum(payload)))

    def tell(self):
        return self._buf.tell()

    def write_catalog(self, asset_id: int, magic: int, version: int, entries: dict[int, str]):
        strings = b""
        table = b""
        for aid, path in entries.items():
            table += struct.pack("<III", aid, len(strings), len(path))
            strings += path.encode() + b"\0"
        payload = struct.pack("<II", len(entries), len(strings)) + table + strings
        self._chunk("ASET", struct.pack("<I", asset_id))
        dataoffset = self.tell() + 8 + 20 + 4  # after CATL chunk
        self._chunk("CATL", struct.pack("<IIIQ", magic, version, len(payload), dataoffset))
        self._chunk("DATA", payload)
        self._chunk("AEND", b"")

    def write_text(self, asset_id: int, data: bytes):
        self._chunk("ASET", struct.pack("<I", asset_id))
        dataoffset = self.tell() + 8 + 12 + 4
        self._chunk("TEXT", struct.pack("<IQ", len(data), dataoffset))
        self._chunk("DATA", data)
        self._chunk("AEND", b"")

    def write_image(self, asset_id: int, width, height, layers, levels, fmt, payload: bytes,
                    compress=False):
        self._chunk("ASET", struct.pack("<I", asset_id))
        dataoffset = self.tell() + 8 + 32 + 4
        self._chunk("IMAG", struct.pack("<IIIIIIQ", width, height, layers, levels, fmt,
                                        len(payload), dataoffset))
        self._data_chunk(payload, compress)
        self._chunk("AEND", b"")

    def write_mesh(self, asset_id: int, vertices, indices, mincorner, maxcorner,
                   rig=None, bones=None, compress=False):
        vertices = np.asarray(vertices)
        if vertices.dtype != VERTEX_DTYPE:
            raise ValueError("vertices must use VERTEX_DTYPE")
        indices = np.asarray(indices, np.uint32)
        payload = vertices.tobytes() + indices.tobytes()
        bonecount = 0
        if rig is not None:
            payload += np.asarray(rig, RIG_DTYPE).tobytes() + np.asarray(bones, BONE_DTYPE).tobytes()
            bonecount = len(bones)
        self._chunk("ASET", struct.pack("<I", asset_id))
        dataoffset = self.tell() + 8 + 48 + 4
        hdr = struct.pack("<III", len(vertices), len(indices), bonecount)
        hdr += struct.pack("<3f", *np.asarray(mincorner, np.float32))
        hdr += struct.pack("<3f", *np.asarray(maxcorner, np.float32))
        hdr += struct.pack("<IQ", len(payload), dataoffset)
        self._chunk("MESH", hdr)
        self._data_chunk(payload, compress)
        self._chunk("AEND", b"")

    def write_material(self, asset_id: int, color=(0.75, 0.75, 0.75, 1.0), metalness=0.0,
                       roughness=1.0, reflectivity=0.5, emissive=0.0,
                       albedomap=0, surfacemap=0, normalmap=0):
        self._chunk("ASET", struct.pack("<I", asset_id))
        dataoffset = self.tell() + 8 + 8 + 4
        self._chunk("MATL", struct.pack("<Q", dataoffset))
        payload = struct.pack("<4f", *color) + struct.pack("<4f", metalness, roughness,
                                                           reflectivity, emissive)
        payload += struct.pack("<III", albedomap, surfacemap, normalmap)
        self._chunk("DATA", payload)
        self._chunk("AEND", b"")

    def write_animation(self, asset_id: int, duration, joints, times, transforms):
        payload = b"\0"  # empty-struct pad byte (see PackReader)
        for j in joints:
            payload += j["name"].encode().ljust(32, b"\0")[:32]
            payload += struct.pack("<III", j["parent"], j["index"], j["count"])
        for t, tf in zip(times, transforms):
            payload += struct.pack("<f", t) + np.asarray(tf, np.float32).tobytes()
        self._chunk("ASET", struct.pack("<I", asset_id))
        dataoffset = self.tell() + 8 + 20 + 4
        self._chunk("ANIM", struct.pack("<fIIQ", duration, len(joints), len(times), dataoffset))
        self._chunk("DATA", payload)
        self._chunk("AEND", b"")

    def write_model(self, asset_id: int, textures, materials, meshes, instances):
        payload = b"\0"  # empty-struct pad byte (see PackReader)
        for t in textures:
            payload += struct.pack("<II", t["type"], t["texture"])
        for m in materials:
            payload += struct.pack("<4f", *m["color"])
            payload += struct.pack("<4f", m["metalness"], m["roughness"], m["reflectivity"],
                                   m["emissive"])
            payload += struct.pack("<III", m["albedomap"], m["surfacemap"], m["normalmap"])
        for m in meshes:
            payload += struct.pack("<I", m)
        for inst in instances:
            payload += struct.pack("<II", inst["mesh"], inst["material"])
            payload += np.asarray(inst["transform"], np.float32).tobytes()
            payload += struct.pack("<I", inst["childcount"])
        self._chunk("ASET", struct.pack("<I", asset_id))
        dataoffset = self.tell() + 8 + 24 + 4
        self._chunk("MODL", struct.pack("<IIIIQ", len(textures), len(materials), len(meshes),
                                        len(instances), dataoffset))
        self._chunk("DATA", payload)
        self._chunk("AEND", b"")

    def write_font(self, asset_id: int, glyphatlas, ascent, descent, leading,
                   x, y, width, height, offsetx, offsety, advance):
        n = len(x)
        payload = struct.pack("<I", glyphatlas)
        payload += np.asarray(x, np.uint16).tobytes() + np.asarray(y, np.uint16).tobytes()
        payload += np.asarray(width, np.uint16).tobytes() + np.asarray(height, np.uint16).tobytes()
        payload += np.asarray(offsetx, np.int16).tobytes() + np.asarray(offsety, np.int16).tobytes()
        payload += np.asarray(advance, np.uint8).tobytes()
        self._chunk("ASET", struct.pack("<I", asset_id))
        dataoffset = self.tell() + 8 + 24 + 4   # FONT header = 4xu32 + u64
        self._chunk("FONT", struct.pack("<IIIIQ", ascent, descent, leading, n, dataoffset))
        self._chunk("DATA", payload)
        self._chunk("AEND", b"")

    def write_particlesystem(self, asset_id: int, minrange, maxrange, maxparticles,
                             emittercount, spritesheet, emitterdata: bytes):
        payload = struct.pack("<I", spritesheet) + emitterdata
        self._chunk("ASET", struct.pack("<I", asset_id))
        dataoffset = self.tell() + 8 + 44 + 4
        hdr = struct.pack("<3f", *np.asarray(minrange, np.float32))
        hdr += struct.pack("<3f", *np.asarray(maxrange, np.float32))
        hdr += struct.pack("<IIIQ", maxparticles, emittercount, len(emitterdata), dataoffset)
        self._chunk("PART", hdr)
        self._chunk("DATA", payload)
        self._chunk("AEND", b"")

    def _data_chunk(self, payload: bytes, compress: bool):
        if not compress:
            self._chunk("DATA", payload)
            return
        self._chunk("CDAT", cdat_blocks(payload))

    def finish(self) -> bytes:
        self._chunk("HEND", b"")
        return self._buf.getvalue()

    def save(self, path):
        with open(path, "wb") as f:
            f.write(self.finish())
