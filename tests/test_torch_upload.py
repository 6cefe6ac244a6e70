"""The port's DeviceUploader (datum_tpu_torch/asset/upload.py) on the CPU:
tests/test_upload.py's cases on device="cpu", a mesh payload's parked
TypeError (a structured array: jax.device_put raises TypeError on it
too), and the raise when "cuda" is asked for without a card.  Uploaded
leaves equal their host arrays exactly (dtype, shape and bytes).  The
cross-stream case under allocator reuse needs the card
(tests/test_torch_cuda.py)."""

import time

import numpy as np
import pytest
import torch

from datum_tpu_torch.asset import AssetManager, DeviceUploader, PackWriter
from datum_tpu_torch.asset.pack import IMAGE_RGBA, VERTEX_DTYPE


def wait_ready(up, key, timeout=10.0):
    t0 = time.time()
    while not up.ready(key):
        assert time.time() - t0 < timeout, "upload never landed"
        time.sleep(0.005)


@pytest.fixture
def up():
    u = DeviceUploader(device="cpu")
    yield u
    u.close()


def test_submit_poll_get(up):
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    assert up.get("a") is None
    up.submit("a", a)
    wait_ready(up, "a")
    got = up.get("a")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), a)
    a[0, 0] = -1.0                      # the upload is a copy
    assert got[0, 0] == 0.0


def test_tree_and_many(up):
    for i in range(16):
        up.submit(i, dict(x=np.full((8, 8), i, np.float32), y=np.int32(i),
                          mips=[np.full((2, 4, 4), i, np.uint32), np.zeros(3, np.uint16)],
                          meta=(i, 0.5, None)))
    up.flush()
    for i in range(16):
        got = up.get(i)
        assert float(got["x"][0, 0]) == i and int(got["y"]) == i
        assert got["y"].dtype == torch.int32 and got["y"].dim() == 0
        assert got["mips"][0].dtype == torch.uint32 and int(got["mips"][0][1, 3, 3]) == i
        assert got["mips"][1].dtype == torch.uint16
        assert got["meta"] == (i, 0.5, None)


def test_readonly_and_strided_leaves(up):
    """A read-only array (a view of bytes, as a mesh's indices are),
    a transposed and a reversed array land equal to their values."""
    ro = np.frombuffer(np.arange(12, dtype=np.uint32).tobytes(), np.uint32)
    m = np.arange(12, dtype=np.float32).reshape(3, 4)
    up.submit("p", dict(ro=ro, t=m.T, r=m[::-1, ::-2]))
    up.flush()
    got = up.get("p")
    for k, want in (("ro", ro), ("t", m.T), ("r", m[::-1, ::-2])):
        assert got[k].numpy().dtype == want.dtype
        assert np.array_equal(got[k].numpy(), want)


def test_duplicate_submit_is_noop(up):
    a = np.ones(4, np.float32)
    up.submit("k", a)
    up.submit("k", a * 2)      # ignored: already pending or resident
    up.flush()
    assert float(up.get("k")[0]) == 1.0
    up.evict("k")
    assert up.get("k") is None


def test_chained_asset_request(tmp_path, up):
    """AssetManager decoding -> upload, end to end on a pack written by
    the pack writer; the uploaded mips equal the host payload's."""
    path = tmp_path / "t.pack"
    rng = np.random.RandomState(0)
    img = rng.randint(0, 2 ** 32, (1, 8, 8), dtype=np.uint64).astype(np.uint32)
    w = PackWriter()
    w.write_image(0, 8, 8, 1, 1, IMAGE_RGBA, img.tobytes())
    path.write_bytes(w.finish())
    mgr = AssetManager()
    base = mgr.load(str(path))
    t0 = time.time()
    dev = None
    while dev is None and time.time() - t0 < 10.0:
        dev = up.request(("tex", base), mgr, base)
        time.sleep(0.005)
    assert dev is not None, "chained request never became resident"
    host = mgr.request(base)
    assert dev["mips"][0].dtype == torch.uint32
    assert dev["mips"][0].numpy().tobytes() == host["mips"][0].tobytes()
    assert dev["width"] == 8 and dev["format"] == IMAGE_RGBA
    mgr.close()


def test_mesh_payload_parks_a_type_error(tmp_path, up):
    """A mesh's VERTEX_DTYPE vertices cannot be a tensor: the upload's
    TypeError is parked and get() raises it (each time); other keys go
    on uploading."""
    verts = np.zeros(10, VERTEX_DTYPE)
    verts["position"] = np.random.RandomState(1).randn(10, 3)
    w = PackWriter()
    w.write_mesh(0, verts, np.arange(9, dtype=np.uint32), [-1, -1, -1], [1, 1, 1])
    w.write_text(1, b"shader name")
    path = tmp_path / "m.pack"
    path.write_bytes(w.finish())
    mgr = AssetManager()
    base = mgr.load(str(path))
    up.submit("mesh", mgr.load_sync(base))
    up.submit("text", mgr.load_sync(base + 1))     # bytes: no array either
    up.submit("ok", np.arange(3, dtype=np.int64))
    up.flush()
    assert up.ready("mesh") and up.ready("text")
    for _ in range(2):
        with pytest.raises(TypeError):
            up.get("mesh")
    with pytest.raises(TypeError):
        up.get("text")
    assert up.get("ok").tolist() == [0, 1, 2]
    mgr.close()


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers the CUDA queue")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceUploader()
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceUploader(device="cuda")
    with pytest.raises(ValueError):
        DeviceUploader(device="meta")
