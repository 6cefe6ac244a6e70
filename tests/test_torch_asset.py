"""The port's pack pipeline against the JAX package's (CPU, numpy only).

Seeded inputs go through datum_tpu_torch/math/color.py, asset/lz4.py,
asset/pack.py and asset/manager.py and through their counterparts in
datum_tpu.  Tolerance: none.  The colour codecs' u32 codes and float
decodes are equal bit for bit, the native LZ4 codec's output and the
PackWriter's bytes are equal byte for byte, the readers' decodes are
equal, and the two managers, driven through the same sequence of calls,
answer each call alike.
"""

import os
import struct

import numpy as np
import pytest

from datum_tpu.asset import lz4 as jlz4
from datum_tpu.asset import manager as jmanager
from datum_tpu.asset import pack as jpack
from datum_tpu.math import color as jcolor

from datum_tpu_torch.asset import lz4 as tlz4
from datum_tpu_torch.asset import manager as tmanager
from datum_tpu_torch.asset import pack as tpack
from datum_tpu_torch.math import color as tcolor


def _seeded(seed=0):
    return np.random.RandomState(seed)


# ---------------------------------------------------------------------------
# colour codecs
# ---------------------------------------------------------------------------

def _colors(seed, n=4096):
    rng = _seeded(seed)
    c = np.concatenate([
        rng.uniform(-0.5, 1.5, (n, 4)),
        rng.uniform(0, 1, (n, 4)) ** 4,
        np.exp2(rng.uniform(-30, 20, (n, 4))),       # exponent floor and the clamp
        [[65408, 65409, 1e9, 1], [0, 0, 0, 0], [1e-30, 2e-30, 0, 1],
         [2 ** -17, 2 ** -16, 2 ** -15, 1], [0.5, 0.5, 0.5, 0.5]]]).astype(np.float32)
    return c


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("name", ["rgba", "srgba", "rgbm", "rgbe"])
def test_color_codecs_exact(name):
    c = _colors(1)
    pk = getattr(tcolor, f"pack_{name}")(c)
    _eq(pk, getattr(jcolor, f"pack_{name}")(c))
    assert pk.dtype == np.uint32
    codes = np.concatenate([pk, _seeded(2).randint(0, 2 ** 32, 4096, dtype=np.uint64)
                            .astype(np.uint32)])
    _eq(getattr(tcolor, f"unpack_{name}")(codes), getattr(jcolor, f"unpack_{name}")(codes))


def test_color_gamma_hsv_exact():
    c = _colors(3)
    _eq(tcolor.gamma_encode(c), jcolor.gamma_encode(c))
    _eq(tcolor.gamma_decode(c), jcolor.gamma_decode(c))
    rng = _seeded(4)
    h, s, v = (rng.uniform(-2, 2, 1000).astype(np.float32),
               rng.uniform(0, 1, 1000).astype(np.float32),
               rng.uniform(0, 1, 1000).astype(np.float32))
    _eq(tcolor.hsv_to_rgb(h, s, v), jcolor.hsv_to_rgb(h, s, v))


# ---------------------------------------------------------------------------
# LZ4
# ---------------------------------------------------------------------------

def _lz4_inputs():
    rng = _seeded(5)
    return dict(
        random=rng.bytes(50000),
        text=b"hello world, this is a compressible string! " * 1000,
        mixed=(b"abcabcabc" * 500) + rng.bytes(1000) + (b"xyz" * 700),
        zeros=bytes(300000),
        image=(np.arange(1 << 16, dtype=np.uint32) // 7).tobytes(),
        short=b"0123456789ab")


@pytest.fixture(scope="module")
def jax_native():
    lib = jlz4._load_native()
    assert lib, "the JAX package's native codec did not build"
    return lib


@pytest.mark.parametrize("name", sorted(_lz4_inputs()))
def test_lz4_native_equals_jax_native(name, jax_native):
    data = _lz4_inputs()[name]
    for cap in (len(data) * 2 + 64, tpack.BLOCK_DATA, 1000):
        comp, used = tlz4.compress(data, cap)
        assert (comp, used) == jlz4.compress(data, cap)
        assert len(comp) <= cap and 0 < used <= len(data)
        assert tlz4.decompress(comp, used) == data[:used]
        # the plain codec decodes the native stream, and the native codec
        # the plain one
        assert tlz4.py_decompress(comp, used) == data[:used]
        pcomp, pused = tlz4.py_compress(data, cap)
        assert (pcomp, pused) == jlz4._py_compress(data, cap)
        assert tlz4.decompress(pcomp, pused) == data[:pused]


def test_lz4_partial_fit_and_start():
    data = _seeded(6).bytes(50000)
    comp, used = tlz4.compress(data, 10000)
    assert 0 < used <= 10000
    assert tlz4.decompress(comp, used) == data[:used]
    # start= compresses the tail without copying it: as the tail alone
    assert tlz4.compress(data, 10000, start=used) == tlz4.compress(data[used:], 10000)
    with pytest.raises(ValueError):
        tlz4.compress(data, 10000, start=len(data) + 1)


def test_lz4_decompress_into():
    """Blocks decoded into one buffer at offsets, as PackReader.payload
    does: equal to decompress, bounded by the buffer, corrupt raises."""
    data = _lz4_inputs()["image"]
    a, na = tlz4.compress(data, 20000)
    b, nb = tlz4.compress(data, 20000, start=na)
    src = b"xx" + a + b
    out = bytearray(na + nb)
    assert tlz4.decompress_into(src, 2, len(a), out, 0) == na
    assert tlz4.decompress_into(src, 2 + len(a), len(b), out, na) == nb
    assert bytes(out) == data[:na + nb] == tlz4.decompress(a, na) + tlz4.decompress(b, nb)
    with pytest.raises(ValueError):                 # no room left in the buffer
        tlz4.decompress_into(src, 2, len(a), out, na + nb - 10)
    with pytest.raises(ValueError):
        tlz4.decompress_into(src, 2, len(src), out, 0)


def test_lz4_empty(jax_native):
    assert tlz4.compress(b"", 100) == jlz4.compress(b"", 100) == (b"", 0)
    assert tlz4.decompress(b"", 0) == b""


def test_lz4_corrupt_block_raises():
    comp, used = tlz4.compress(b"abcd" * 400, 4096)
    bad = bytearray(comp)
    bad[-6:] = b"\xff" * 6                  # an offset past the output
    with pytest.raises(ValueError):
        tlz4.decompress(bytes(bad), used)
    with pytest.raises(ValueError):
        tlz4.decompress(b"\x10\x41\x05", 100)   # a match with one offset byte
    with pytest.raises(ValueError):
        tlz4.decompress(comp, used // 2)    # more output than the cap


def test_lz4_failed_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises with the
    compiler's output."""
    src = tmp_path / "lz4.cpp"
    src.write_text('extern "C" long datum_lz4_decompress( { this is not C++ }\n')
    monkeypatch.setattr(tlz4, "SOURCE", src)
    monkeypatch.setattr(tlz4, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="lz4.cpp build failed"):
        tlz4.build()
    assert not list((tmp_path / "build").glob("*.so"))
    assert tlz4.library_path().parent == tmp_path / "build"


def test_checksums_equal():
    data = _seeded(7).bytes(1021)
    assert (tpack._fast_checksum(data) == tpack.chunk_checksum(data)
            == jpack._fast_checksum(data))


# ---------------------------------------------------------------------------
# PackWriter / PackReader
# ---------------------------------------------------------------------------

def _mesh(rng, mod, n=100):
    v = np.zeros(n, mod.VERTEX_DTYPE)
    v["position"] = rng.randn(n, 3)
    v["texcoord"] = rng.rand(n, 2)
    v["normal"] = rng.randn(n, 3)
    v["tangent"] = rng.randn(n, 4)
    return v, rng.randint(0, n, 3 * n).astype(np.uint32)


def _write_all(mod, compress, seed=8):
    """Every asset type, from one seed, through mod's PackWriter."""
    rng = _seeded(seed)
    w = mod.PackWriter()
    w.write_catalog(0, 0x1234, 1, {1: "mesh", 2: "rigged", 3: "image", 9: "font"})
    v, idx = _mesh(rng, mod, 3000)
    w.write_mesh(1, v, idx, v["position"].min(0), v["position"].max(0), compress=compress)
    v, idx = _mesh(rng, mod, 200)
    rig = np.zeros(200, mod.RIG_DTYPE)
    rig["bone"] = rng.randint(0, 3, (200, 4))
    rig["weight"] = rng.rand(200, 4)
    bones = np.zeros(3, mod.BONE_DTYPE)
    bones["name"] = [b"root", b"mid", b"tip"]
    bones["transform"] = rng.randn(3, 8)
    w.write_mesh(2, v, idx, [-1, -1, -1], [1, 1, 1], rig=rig, bones=bones, compress=compress)
    img = rng.randint(0, 2 ** 32, (2, 64, 64), dtype=np.uint64).astype(np.uint32)
    mip1 = (np.arange(2 * 32 * 32, dtype=np.uint32) // 5).reshape(2, 32, 32)
    w.write_image(3, 64, 64, 2, 2, mod.IMAGE_RGBA, img.tobytes() + mip1.tobytes(),
                  compress=compress)
    w.write_image(4, 8, 8, 1, 2, mod.IMAGE_RGBA_BC3, rng.bytes(4 * 16 + 16), compress=compress)
    w.write_image(5, 4, 4, 1, 1, mod.IMAGE_F32, rng.rand(16).astype(np.float32).tobytes(),
                  compress=compress)
    w.write_text(6, b"datum_tpu_torch.ops.ssao.hbao")
    w.write_material(7, color=(1, 0.5, 0.25, 1), metalness=0.9, roughness=0.3,
                     reflectivity=0.4, emissive=0.1, albedomap=5, surfacemap=6, normalmap=7)
    joints = [dict(name="root", parent=0, index=0, count=2),
              dict(name="arm", parent=0, index=2, count=3)]
    w.write_animation(8, 1.5, joints, [0.0, 1.0, 0.0, 0.5, 1.5],
                      rng.randn(5, 8).astype(np.float32))
    n = 5
    w.write_font(9, 3, 10, 3, 2, *(rng.randint(0, 60, n) for _ in range(4)),
                 *(rng.randint(-5, 5, n) for _ in range(2)), rng.randint(0, 12, (n, n)))
    w.write_particlesystem(10, (0, 0, 0), (1, 2, 3), 100, 2, 4, rng.bytes(37))
    w.write_model(11, [dict(type=0, texture=3), dict(type=2, texture=4)],
                  [dict(color=np.float32([1, 0.5, 0.2, 1]), metalness=0.1, roughness=0.7,
                        reflectivity=0.5, emissive=0.0, albedomap=1, surfacemap=0,
                        normalmap=2)],
                  [1, 2], [dict(mesh=i % 2, material=0, childcount=0,
                                transform=rng.randn(8).astype(np.float32)) for i in range(3)])
    return w.finish()


@pytest.mark.parametrize("compress", [False, True])
def test_pack_writer_bytes_equal(compress):
    data = _write_all(tpack, compress)
    assert data == _write_all(jpack, compress)
    tags = {data[p:p + 4] for p in range(8, len(data) - 4)
            if data[p:p + 4] in (b"CDAT", b"DATA")}
    assert (b"CDAT" in tags) == compress


def _decode_all(reader):
    out = {}
    for aid, info in sorted(reader.assets.items()):
        name = dict(catl="catalog", imag="image", matl="material", anim="animation",
                    modl="model", part="particlesystem").get(info.type, info.type)
        out[aid] = (info.type, info.datasize, info.dataoffset, getattr(reader, name)(aid))
    return out


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("compress", [False, True])
def test_pack_reader_on_jax_packs(compress):
    data = _write_all(jpack, compress)
    t, j = tpack.PackReader(data), jpack.PackReader(data)
    assert t.assets.keys() == j.assets.keys()
    for aid in t.assets:
        assert t.assets[aid].type == j.assets[aid].type
        _same(t.assets[aid].fields, j.assets[aid].fields)
    _same(_decode_all(t), _decode_all(j))


def test_pack_reader_rejects_a_bad_signature():
    with pytest.raises(ValueError, match="signature"):
        tpack.PackReader(b"NOTAPACK" + bytes(16))


# ---------------------------------------------------------------------------
# the manager, mirrored call by call
# ---------------------------------------------------------------------------

def _poll(mgr, aid, tries=2000):
    import time

    for _ in range(tries):
        got = mgr.request(aid)
        if got is not None or mgr.error(aid) is not None:
            return got
        time.sleep(0.002)
    raise AssertionError(f"asset {aid} never loaded")


def _corrupt_pack(mod):
    """A pack whose text asset's DATA chunk is shorter than its header
    says: its decode raises."""
    w = mod.PackWriter()
    w.write_text(0, b"good")
    w.write_text(1, b"bad!")
    data = bytearray(w.finish())
    i = data.rindex(b"TEXT")
    struct.pack_into("<I", data, i + 4, 99)    # TEXT header: length 99
    return bytes(data)


def _script(mod, mgr_mod, tmp_path, tag):
    """One scripted run of a manager; returns what each step saw."""
    seen = []
    p0 = tmp_path / f"{tag}_a.pack"
    p0.write_bytes(_write_all(mod, True))
    p1 = tmp_path / f"{tag}_b.pack"
    w = mod.PackWriter()
    for i in range(4):
        w.write_text(i, bytes([i]) * 100)
    p1.write_bytes(w.finish())
    p2 = tmp_path / f"{tag}_c.pack"
    p2.write_bytes(_corrupt_pack(mod))

    mgr = mgr_mod.AssetManager(budget_bytes=60000, workers=4)
    b0, b1, b2 = mgr.load(str(p0)), mgr.load(str(p1)), mgr.load(str(p2))
    seen.append(("bases", b0, b1, b2, sorted(mgr._assets), b1 + 3 in mgr))
    seen.append(("find", mgr.find(b0 + 3).type, mgr.find(999)))
    # request: None first, then the payload once the worker decoded it
    seen.append(("first request", mgr.request(b0 + 3)))
    seen.append(("streamed", _poll(mgr, b0 + 3)["mips"][1].tobytes()))
    seen.append(("ready", mgr.ready(b0 + 3), mgr.ready(b0 + 1)))
    # a failed decode is parked, not retried
    assert _poll(mgr, b2 + 1) is None
    err = mgr.error(b2 + 1)
    seen.append(("error", type(err).__name__, str(err), mgr.request(b2 + 1),
                 b2 + 1 in mgr._loading, mgr.load_sync(b2 + 0)))
    # LRU: the budget (60000 bytes) evicts the coldest payload
    for a in (b0 + 1, b0 + 2, b0 + 3, b0 + 7):
        mgr.load_sync(a)
        seen.append(("lru", a, sorted(mgr._resident), mgr._used))
    mgr.request(b0 + 2)                       # touch: b0 + 2 is now the newest
    mgr.load_sync(b0 + 1)
    seen.append(("lru touched", sorted(mgr._resident), list(mgr._resident)))
    # a guard() barrier pins every payload while it is held
    with mgr.guard():
        for a in (b0 + 3, b0 + 5, b0 + 6):
            mgr.load_sync(a)
        seen.append(("guarded", sorted(mgr._resident), mgr._used))
    mgr.load_sync(b1 + 0)
    seen.append(("released", sorted(mgr._resident), mgr._used))

    # hot reload: rewrite pack b (asset 1 changed, asset 3 removed, asset
    # 7 past the reserved range), bump its mtime with os.utime
    watcher = mgr_mod.PackWatcher(mgr)
    seen.append(("watch idle", watcher.poll()))
    mgr.load_sync(b1 + 1)
    mgr.load_sync(b1 + 3)
    w = mod.PackWriter()
    for i, body in ((0, b"\0" * 100), (1, b"changed"), (2, b"\2" * 100), (7, b"new")):
        w.write_text(i, body)
    p1.write_bytes(w.finish())
    st = os.stat(p1)
    os.utime(p1, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    changed = watcher.poll()
    seen.append(("reloaded", sorted(changed), mgr.load_sync(b1 + 1), b1 + 3 in mgr,
                 b1 + 7 in mgr, mgr.ready(b1 + 1), watcher.poll()))
    seen.append(("final", sorted(mgr._assets), sorted(mgr._resident), mgr._used))
    return seen


def test_manager_script_mirrors_jax(tmp_path, capsys):
    t = _script(tpack, tmanager, tmp_path, "t")
    t_log = capsys.readouterr().out
    j = _script(jpack, jmanager, tmp_path, "j")
    j_log = capsys.readouterr().out
    assert len(t) == len(j)
    for a, b in zip(t, j):
        _same(a, b)
    assert "exceeds the pack's reserved 4 ids" in t_log
    assert t_log.replace("t_b.pack", "j_b.pack") == j_log


def test_manager_close_stops_its_workers(tmp_path):
    w = tpack.PackWriter()
    w.write_text(0, b"x")
    p = tmp_path / "x.pack"
    p.write_bytes(w.finish())
    mgr = tmanager.AssetManager()
    base = mgr.load(str(p))
    assert _poll(mgr, base) == b"x"
    mgr.close()
    with pytest.raises(RuntimeError):
        mgr._pool.submit(print)
