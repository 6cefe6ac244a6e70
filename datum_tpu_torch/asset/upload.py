"""Background device-upload queue on a CUDA side stream (counterpart of
datum_tpu/asset/upload.py, whose worker calls jax.device_put and fences
with block_until_ready).

Decoded host payloads stream to the card on a worker thread while the
render loop polls `ready()`, never blocking a frame on an upload.  The
uploader owns a `torch.cuda.Stream`; its one worker thread sets its
device and uploads each payload on that stream.  Each numpy leaf of a
payload tree (dicts, lists and tuples of numpy arrays and numpy scalars;
the image decoder's `mips` list of u32 arrays) is copied from its host
memory to a tensor on the card with `non_blocking=True` on the side
stream.  One `torch.cuda.Event` is recorded after a payload's last copy,
and the worker waits on it before it publishes the payload: `ready()`
means the copy landed, as in the JAX version.  Python numbers and None
stay as they are (host metadata: widths, levels, material factors); a
leaf the card cannot hold (a str or bytes, or a structured array such as
a mesh's VERTEX_DTYPE vertices, which torch.from_numpy rejects as
jax.device_put does) makes the upload fail with TypeError, which is
parked and raised by `get()`.

No pinned staging: the decoded arrays live in pageable memory, so a
pinned buffer adds a host copy that CUDA's own pageable copy makes
anyway.  On an H100 (700 W) the 28 images of chip_smoke.py's phase 6a
(39.4 MB) uploaded at 1.92 GB/s through a pinned buffer a leaf (3.70
GB/s for pageable copies in the same run) and at 2.92 GB/s through one
pinned buffer a payload, staged while the previous payload's copy was
in flight (4.23 GB/s pageable).

Cross-stream lifetime: the device tensors are allocated on the side
stream and read on the consumer's.  When the consumer drops one, the
caching allocator would hand its block to the next allocation on the
side stream at once, while the consumer's stream may still have queued
reads of it.  `get()` therefore calls `record_stream` with the calling
thread's current stream on every tensor it returns: the allocator then
keeps the block until that stream's work queued so far has run.  This
was chosen over allocating on the consumer's stream (with the side
stream waiting on it) because the consumer's stream is known only when
the payload is taken, not when the worker uploads it, and a payload may
be taken on several streams.

device="cuda" (the default) needs a card and raises without one;
device="cpu" copies the leaves into CPU tensors (the tests' path).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree):
    """The leaves of a payload tree (host or device), in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


class DeviceUploader:
    """Single-worker upload queue with per-key states: absent -> pending
    (its upload's future) -> resident (a device payload or a parked
    exception)."""

    def __init__(self, device="cuda"):
        self._device = torch.device(device)
        self.stream = None
        if self._device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("DeviceUploader: device 'cuda' asked for, but "
                                   "torch.cuda.is_available() is False")
            if self._device.index is None:
                self._device = torch.device("cuda", torch.cuda.current_device())
            self.stream = torch.cuda.Stream(device=self._device)
        elif self._device.type != "cpu":
            raise ValueError(f"DeviceUploader: unsupported device {device!r}")
        self._resident = {}
        self._pending = {}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="device-upload",
                                        initializer=self._init_worker)

    @property
    def device(self):
        return self._device

    # --- worker side --------------------------------------------------------
    def _init_worker(self):
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)

    def _reap(self):
        """Under the lock: move every finished upload to _resident, its
        device payload or the exception it raised (parked for get())."""
        for key, fut in list(self._pending.items()):
            if fut.done():
                del self._pending[key]
                exc = fut.exception()
                self._resident[key] = exc if exc is not None else fut.result()

    def _leaf(self, x):
        """One leaf of a payload on the uploader's device: a numpy array
        or scalar copied, a Python number or None as it is; TypeError
        else."""
        if isinstance(x, (np.ndarray, np.generic)):
            a = np.asarray(x)
            if self._device.type == "cpu":
                return torch.from_numpy(np.array(a, copy=True))
            # torch.from_numpy takes no negative strides and warns on a
            # read-only array (a mesh's indices, viewed in the pack's bytes)
            a = np.require(a, requirements=["C", "W"])
            return torch.from_numpy(a).to(self._device, non_blocking=True)
        if x is None or isinstance(x, (bool, int, float)):
            return x
        raise TypeError(f"upload: a {type(x).__name__} leaf is not an array")

    def _upload(self, payload):
        if self._device.type == "cpu":
            return _tree_map(self._leaf, payload)
        with torch.cuda.stream(self.stream):
            dev = _tree_map(self._leaf, payload)
            done = torch.cuda.Event()
            done.record(self.stream)
        # the fence: ready() must mean the copy landed
        done.synchronize()
        return dev

    # --- producer side ------------------------------------------------------
    def submit(self, key, payload) -> None:
        """Enqueue a host payload (array or tree) for upload; a key that
        is pending or resident is left as it is."""
        with self._lock:
            self._reap()
            if key in self._pending or key in self._resident:
                return
            self._pending[key] = self._pool.submit(self._upload, payload)

    def request(self, key, manager, asset_id):
        """Chain AssetManager decoding into the upload queue: the device
        payload if resident, else schedule the decode (the manager's
        workers) and then the upload (this queue's thread) and return
        None: the non-blocking request() of the asset system."""
        got = self.get(key)
        if got is not None:
            return got
        with self._lock:
            if key in self._pending:
                return None
        payload = manager.request(asset_id)
        if payload is None:
            return None                   # still decoding; poll again
        self.submit(key, payload)
        return None

    # --- consumer side ------------------------------------------------------
    def ready(self, key) -> bool:
        with self._lock:
            self._reap()
            return key in self._resident

    def get(self, key):
        """The device payload if its upload landed, else None; raises
        the parked exception of a failed upload.  Every tensor returned is
        recorded on the calling thread's current stream (see the module's
        docstring)."""
        with self._lock:
            self._reap()
            dev = self._resident.get(key)
        if isinstance(dev, BaseException):
            raise dev
        if dev is not None and self._device.type == "cuda":
            consumer = torch.cuda.current_stream(self._device)
            for t in leaves(dev):
                if isinstance(t, torch.Tensor):
                    t.record_stream(consumer)
        return dev

    def flush(self):
        """Block until every queued upload has landed."""
        with self._lock:
            futures = list(self._pending.values())
        wait(futures)
        with self._lock:
            self._reap()

    def evict(self, key):
        with self._lock:
            self._reap()
            self._resident.pop(key, None)

    def close(self):
        """Stop the worker after the uploads it has taken."""
        self._pool.shutdown(wait=True)
