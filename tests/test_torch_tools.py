"""The port's pack tools (datum_tpu_torch/tools) against the JAX
package's (CPU): the OBJ parser on OBJ text written here (arrays and
pack bytes equal), the compressor and the dump on packs written here,
the BC3 codec (exact), Radiance .hdr IO, the core pack at small bake
sizes (every asset but the catalog and the TEXT entries equal after
decoding; the float bakes within 1e-5; every registry entry a callable
of datum_tpu_torch) and the TrueType baker on DejaVuSans (atlas bytes
equal; skipped where the font is absent, as tests/test_ttf.py does)."""

import importlib
import os

import numpy as np
import pytest

from datum_tpu.asset import pack as jpack
from datum_tpu.tools import assetcompressor as jcomp
from datum_tpu.tools import assetdump as jdump
from datum_tpu.tools import bc as jbc
from datum_tpu.tools import hdr as jhdr
from datum_tpu.tools import objparser as jobj

from datum_tpu_torch import packscene
from datum_tpu_torch.asset import pack as tpack
from datum_tpu_torch.tools import assetcompressor as tcomp
from datum_tpu_torch.tools import assetdump as tdump
from datum_tpu_torch.tools import bc as tbc
from datum_tpu_torch.tools import hdr as thdr
from datum_tpu_torch.tools import objparser as tobj

TTF = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"

# a pentagon and a quad (fan triangulation), negative indices, faces with
# v//vn and v/vt, comments and blank lines
OBJ_MIXED = """# mixed records
v 0 0 0
v 1 0 0
v 1.5 1 0
v 0.5 1.7 0
v -0.5 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
vn 0 1 0

f 1/1/1 2/2/1 3/3/1 4/1/1 5/2/1
f -1//-2 -2//-1 1//1 6//2
f 2/3 3/1 6/2
"""


def _same_arrays(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _without_normals(text):
    """OBJ text with its vn records dropped and faces as v/vt."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("vn "):
            continue
        if ln.startswith("f "):
            ln = "f " + " ".join(p.rsplit("/", 1)[0] for p in ln.split()[1:])
        out.append(ln)
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("text", ["mixed", "lathe", "no normals"])
def test_objparser_equal(text, tmp_path):
    obj = {"mixed": OBJ_MIXED, "lathe": packscene.lathe_obj(3, 16, 8),
           "no normals": _without_normals(packscene.lathe_obj(4, 8, 4))}[text]
    tv, ti = tobj.parse_obj(obj)
    jv, ji = jobj.parse_obj(obj)
    _same_arrays(tv, jv)
    _same_arrays(ti, ji)
    assert len(ti) % 3 == 0 and ti.max() < len(tv)
    if text == "no normals":
        assert np.allclose(np.linalg.norm(tv["normal"], axis=1), 1.0, atol=1e-5)
    src = tmp_path / "in.obj"
    src.write_text(obj)
    assert (tobj.obj_to_pack(src, tmp_path / "t.pack")
            == jobj.obj_to_pack(src, tmp_path / "j.pack"))
    assert (tmp_path / "t.pack").read_bytes() == (tmp_path / "j.pack").read_bytes()
    m = tpack.PackReader(tmp_path / "t.pack").mesh(0)
    _same_arrays(m["vertices"], tv)


def test_lathe_obj_shape():
    """The chip's OBJ: a few thousand vertices of v/vt/vn quads, a third
    of the rows written with negative indices, triangles facing out."""
    text = packscene.lathe_obj(0)
    faces = [ln for ln in text.splitlines() if ln.startswith("f ")]
    assert len(faces) == 64 * 40 and all(len(f.split()) == 5 for f in faces)
    assert sum("-" in f for f in faces) == 64 * 13
    v, idx = tobj.parse_obj(text)
    assert 2000 < len(v) < 5000
    tri = idx.reshape(-1, 3)
    p = v["position"]
    fn = np.cross(p[tri[:, 1]] - p[tri[:, 0]], p[tri[:, 2]] - p[tri[:, 0]])
    out = p[tri].mean(1) * np.float32([1, 0, 1])
    assert ((fn * out).sum(1) > 0).mean() > 0.99


def _uncompressed_pack(mod, path):
    rng = np.random.RandomState(9)
    w = mod.PackWriter()
    w.write_catalog(0, 0x42, 3, {1: "mesh", 2: "image"})
    v = np.zeros(500, mod.VERTEX_DTYPE)
    v["position"] = np.repeat(rng.randn(50, 3), 10, 0)
    w.write_mesh(1, v, np.arange(498, dtype=np.uint32), [-1, -1, -1], [1, 1, 1])
    w.write_image(2, 64, 64, 1, 1, mod.IMAGE_RGBA,
                  (np.arange(4096, dtype=np.uint32) // 9).tobytes())
    w.write_text(3, rng.bytes(64))                # incompressible: stays DATA
    w.write_material(4, color=(0.5, 0.5, 0.5, 1))
    w.save(path)


def test_assetcompressor_equal(tmp_path):
    _uncompressed_pack(tpack, tmp_path / "t.pack")
    _uncompressed_pack(jpack, tmp_path / "j.pack")
    assert (tmp_path / "t.pack").read_bytes() == (tmp_path / "j.pack").read_bytes()
    rt = tcomp.compress_pack(tmp_path / "t.pack", tmp_path / "tc.pack")
    rj = jcomp.compress_pack(tmp_path / "j.pack", tmp_path / "jc.pack")
    assert rt == rj and rt[1] < rt[0]
    data = (tmp_path / "tc.pack").read_bytes()
    assert data == (tmp_path / "jc.pack").read_bytes() and b"CDAT" in data
    a, b = tpack.PackReader(tmp_path / "t.pack"), tpack.PackReader(data)
    for aid in a.assets:
        assert a.payload(aid) == b.payload(aid)
    (tmp_path / "not.pack").write_bytes(b"not a pack file")
    with pytest.raises(ValueError):
        tcomp.compress_pack(tmp_path / "not.pack", tmp_path / "x.pack")


def test_assetdump_equal(tmp_path):
    p = tmp_path / "scene.pack"
    assets = packscene.scene_assets(sphere_detail=4, grid=(2, 2), map_size=8, mapped=(1,))
    packscene.write_scene_pack(p, assets)
    text = tdump.dump(str(p))
    assert text == jdump.dump(str(p))
    for word in ("MODL", "MESH", "ANIM", "IMAG", "CATL", "bones=3", "fmt=3", "fmt=5"):
        assert word in text


def test_bc3_exact():
    rng = np.random.RandomState(10)
    img = np.concatenate([rng.randint(0, 256, (32, 64, 4)),
                          np.repeat(rng.randint(0, 256, (1, 64, 4)), 32, 0)]).astype(np.uint8)
    img[:4, :4] = 77                                # a flat block (c0 == c1)
    enc = tbc.encode_bc3(img)
    _same_arrays(enc, jbc.encode_bc3(img))
    for w, h in ((64, 64), (61, 30), (5, 3)):
        _same_arrays(tbc.decode_bc3(enc, w, h), jbc.decode_bc3(enc, w, h))
    dec = tbc.decode_bc3(enc, 64, 64)
    assert np.abs(dec.astype(int) - img).mean() < 40


def test_hdr_roundtrip(tmp_path):
    rng = np.random.RandomState(11)
    img = (rng.rand(16, 32, 3) * 50).astype(np.float32)
    img[0, 0] = 0.0
    thdr.save_hdr(tmp_path / "t.hdr", img)
    jhdr.save_hdr(tmp_path / "j.hdr", img)
    assert (tmp_path / "t.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    back = thdr.load_hdr(tmp_path / "t.hdr")
    _same_arrays(back, jhdr.load_hdr(tmp_path / "t.hdr"))
    err = np.abs(back - img) / np.maximum(img.max(-1, keepdims=True), 1e-6)
    assert err.max() < 0.02 and back[0, 0].max() == 0.0
    # an RLE scanline file: 2 rows of 8, one run and one literal span per channel
    rows = b""
    for y in range(2):
        rows += bytes([2, 2, 0, 8])
        for c in range(4):
            rows += bytes([128 + 4, 100 + c + y]) + bytes([4]) + bytes([10, 20, 30, 129])
    p = tmp_path / "rle.hdr"
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 8\n" + rows)
    _same_arrays(thdr.load_hdr(p), jhdr.load_hdr(p))


@pytest.fixture(scope="module")
def core_packs(tmp_path_factory):
    from datum_tpu.tools.assetbuilder import build_core_pack as jbuild

    from datum_tpu_torch.tools.assetbuilder import build_core_pack as tbuild

    d = tmp_path_factory.mktemp("core")
    tcat = tbuild(str(d / "t.pack"), envbrdf_size=8, skybox_size=8)
    jcat = jbuild(str(d / "j.pack"), envbrdf_size=8, skybox_size=8)
    return tpack.PackReader(d / "t.pack"), jpack.PackReader(d / "j.pack"), tcat, jcat


def test_core_pack_assets_equal(core_packs):
    t, j, _, _ = core_packs
    assert t.assets.keys() == j.assets.keys()
    assert t.assets[0].fields == j.assets[0].fields       # magic, version
    checked = 0
    for aid, info in j.assets.items():
        assert t.assets[aid].type == info.type
        if info.type in ("catl", "text"):
            continue
        if info.type == "imag" and info.fields["format"] == jpack.IMAGE_F32:
            a, b = t.image(aid), j.image(aid)
            assert a["mips"][0].shape == b["mips"][0].shape
            np.testing.assert_allclose(a["mips"][0], b["mips"][0], atol=1e-5, rtol=0)
        else:
            assert t.payload(aid) == j.payload(aid), (aid, info.type)
        checked += 1
    assert checked >= 25


def test_core_pack_registry_names_the_port(core_packs):
    t, _, tcat, jcat = core_packs
    assert t.catalog(0) == {k: v for k, v in tcat.items()}
    assert tcat.keys() == jcat.keys()
    for aid, name in tcat.items():
        assert name.startswith("datum_tpu_torch.")
        assert t.text(aid) == name.encode()
        mod, _, sym = name.partition("#")[0].rpartition(".")
        fn = getattr(importlib.import_module(mod), sym)
        assert callable(fn), name
        # the JAX entry names the same role: same module path past the
        # package, but for the Pallas rasters
        jname = jcat[aid]
        if "raster_pallas" not in jname:
            assert name.replace("datum_tpu_torch.", "datum_tpu.", 1) == jname


@pytest.mark.skipif(not os.path.exists(TTF), reason="no system TTF available")
def test_ttf_atlas_equal(tmp_path):
    from datum_tpu.tools.assetbuilder import pack_ttf_font as jpack_ttf
    from datum_tpu.tools.ttf import bake_font as jbake

    from datum_tpu_torch.render.sprite import Font
    from datum_tpu_torch.tools.assetbuilder import pack_ttf_font as tpack_ttf
    from datum_tpu_torch.tools.ttf import bake_font as tbake

    chars = "ABCHeloWrd!go0"
    tf, jf = tbake(TTF, size=20, chars=chars), jbake(TTF, size=20, chars=chars)
    assert isinstance(tf, Font) and tf.charmap == jf.charmap
    for k in ("atlas", "x", "y", "width", "height", "offsetx", "offsety", "advance"):
        _same_arrays(getattr(tf, k), getattr(jf, k))
    assert (tf.ascent, tf.descent, tf.leading) == (jf.ascent, jf.descent, jf.leading)
    tw, jw = tpack.PackWriter(), jpack.PackWriter()
    tpack_ttf(tw, 10, 11, TTF, size=16, chars="ABC0", compress=True)
    jpack_ttf(jw, 10, 11, TTF, size=16, chars="ABC0", compress=True)
    assert tw.finish() == jw.finish()
