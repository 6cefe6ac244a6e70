"""A frame of `render_frame` on a CUDA device, replayed as a chain of
CUDA graphs.

With `use_pallas` every stream of the frame sits at a capacity
FrameConfig fixes, so the same launches run every frame on tensors of
the same shapes: on the megakernel branch, and on the deferred branch's
K5, K1 and K7 routes.  Eagerly the host enqueues several thousand small
launches a frame and the card waits for it; here each stage of the
frame (STAGES, the spans of render/frame.py) is captured once as CUDA
graphs (`torch.cuda.CUDAGraph`, one memory pool a capture) and
replayed.  K1 (K6 with raster_two_phase), K2, K5 and K4 stay out of the
graphs: their wrappers are called between two graphs through their
module attributes every frame (ops/_kernels.py::launch_eager), on the
graphs' own buffers, writing into preallocated outputs.  The
benchmark's roofline readers find these kernels' inputs by wrapping
those attributes, which a graph's replay never calls.  K3, K7 and K2's
epilogue are captured inside the graphs.

When it engages (`render`): only what the call shows decides.  The key
of a frame is its device, `cfg`, whether the program's tracing is on,
the tree structure, dtypes and shapes of draws, sceneset and prev (None
or not), the non-array leaves (Python numbers and strings) of all four
trees, the address, shape and strides of each of state's tensors, and
`lights`: the deferred branch's live point and spot light counts, which
its dense light loops run as Python loops (render/frame.py::
host_light_counts reads them from a host sceneset).  A deferred frame
whose counts are on the device only (None) cannot key.  A key seen once
runs eagerly; its second frame is captured and then replayed, and every
later one replays.  At most MAX_CAPTURES captures are held, the least
recently used dropped first; each keeps alive what its graphs read by
address (state's tensors, the cached constants of
ops/common.py::device_cached).  A state with arrays that are not
tensors on the device, or a non-array leaf that cannot key, runs
eagerly.  render_frame sends only frames with `use_pallas` here: the
scan raster reads device values on the host (ops/common.py::fma).

Inputs: each frame, every array of draws, sceneset and prev is packed
into a pinned host buffer and copied to the capture's device buffer in
one asynchronous copy; tensors already on a device are copied device to
device.  A host buffer is filled again only once the copy out of it has
run, found by querying its event; while every buffer is still being
read a new one is made, up to MAX_HOST_BUFFERS, so that the frame
waits for the card only when the host runs that many frames ahead.  The
graphs read the device buffer's views.

Outputs: the capture's outputs are overwritten by the next replay, so a
replay returns fresh copies of them (a device-to-device copy each).

Launch counts: each enrolled kernel launcher's `launches`
(ops/_kernels.py::enroll) counts the launches it made; a graph's replay
adds those its capture recorded, whatever wraps the launcher's module
attribute.

Spans: while the program's tracing is on, a replayed frame is the span
"frame", the first stage's "frame.input.upload" (the inputs' copy), one
span a stage around its graphs' replays, and the calls between the
graphs under the spans they ran in when captured ("frame.raster.k1",
"frame.raster.k5", "frame.translucent.lit", "frame.translucent.wboit",
"frame.translucent.particles", "frame.shade.k2"); the statistics
"frame.graph.eager", "frame.graph.capture" and "frame.graph.replay"
count the frames of each kind."""

from __future__ import annotations

import collections
import contextlib
import itertools
import warnings

import numpy as np
import torch

from ..convert import map_arrays
from ..debug.debug import span as debug_span
from ..debug.debug import statistic_hit, tracing
from ..ops import _kernels

STAGES = ("frame.input", "frame.shadows", "frame.raster", "frame.planes",
          "frame.translucent", "frame.shade", "frame.post")
MAX_CAPTURES = 2
MAX_SEEN = 16            # keys remembered for their first sighting
MAX_HOST_BUFFERS = 4     # pinned input buffers a capture fills in turn
ALIGN = 256              # bytes: each input array's offset in the buffers

_held = collections.OrderedDict()     # key -> _Capture
_seen = collections.OrderedDict()     # key -> frames seen
_streams = {}                         # device -> its capture stream


def span(name):
    """debug.span(name) for the frame's own code; while a frame is being
    captured, the recorder's span instead, which starts a new graph at
    each stage of STAGES and notes the spans a K1/K2 call runs in."""
    rec = _kernels.recorder
    return debug_span(name) if rec is None else _Span(rec, name)


class _Replay:
    """One captured graph of a stage, and the launches it counts (one per
    entry of _kernels.ENROLLED)."""

    def __init__(self, stage, graph, launches):
        self.stage, self.graph, self.launches = stage, graph, launches

    def run(self):
        self.graph.replay()
        _kernels.add_launches(self.launches)


class _Launch:
    """A launch_eager call made between two graphs: module.<name>(**kw),
    inside the spans `parts` (those it ran in under its stage)."""

    def __init__(self, stage, module, name, kw, parts):
        self.stage, self.module, self.name, self.kw, self.parts = (stage, module, name,
                                                                  kw, parts)

    def run(self):
        with contextlib.ExitStack() as spans:
            for p in self.parts:
                spans.enter_context(debug_span(p))
            getattr(self.module, self.name)(**self.kw)


class _Span:
    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        if self.name in STAGES:
            self.rec.open(self.name)
        self.rec.stack.append(self.name)

    def __exit__(self, *exc):
        self.rec.stack.pop()


class _Recorder:
    """The steps of one capture on device: its graphs, one pool, and the
    launch_eager calls between them."""

    def __init__(self, pool, device):
        self.pool, self.device, self.steps, self.stack, self.keep = pool, device, [], [], []
        self.graph = self.stage = None
        self.base = _kernels.launch_counts()

    def open(self, stage):
        """End the graph being captured and start one of `stage`."""
        self.close()
        self.stage, self.before = stage, _kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def close(self):
        """End the graph being captured; keep it unless it is empty."""
        if self.graph is None:
            return
        g, self.graph = self.graph, None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            g.capture_end()
        empty = False
        for w in caught:
            if "CUDA Graph is empty" in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        if not empty:
            self.steps.append(_Replay(self.stage, g, _kernels.launches_since(self.before)))

    def between(self, module, name, kw):
        """launch_eager's call while capturing: end the stage's graph,
        note the call, start the stage's next graph.  Returns kw["out"],
        which each replay's call fills."""
        stage = self.stage
        self.close()
        parts = self.stack[self.stack.index(stage) + 1:] if stage in self.stack else []
        self.steps.append(_Launch(stage, module, name, kw, tuple(parts)))
        self.open(stage)
        return kw["out"]

    def outside(self, build, args):
        """A device_cached constant missing from its cache, built between
        two graphs: end the stage's graph, build it on the device's
        default stream and wait for it, start the stage's next graph."""
        stage, capturing = self.stage, self.graph is not None
        self.close()
        with torch.cuda.stream(torch.cuda.default_stream(self.device)):
            out = build(*args)
        torch.cuda.synchronize(self.device)
        if capturing:
            self.open(stage)
        return out


class _Recording:
    """The recorder on while the frame's body is captured
    (_kernels.recorder); the enrolled launch counts put back after (the
    capture launched nothing).  A body that raises leaves no capture open
    behind it: the error propagates, and the capture stream stays usable."""

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        _kernels.recorder = self.rec

    def __exit__(self, exc_type, *exc):
        if exc_type is not None and self.rec.graph is not None:
            with contextlib.suppress(RuntimeError):
                self.rec.graph.capture_end()
        _kernels.recorder = None
        _kernels.add_launches([-n for n in _kernels.launches_since(self.rec.base)])


def _leaves(trees):
    out = []
    for t in trees:
        map_arrays(t, out.append)
    return out


def _as_bytes(a):
    """The bytes of a host array leaf (numpy, or a CPU tensor): a flat
    uint8 numpy array."""
    return np.asarray(a).reshape(-1).view(np.uint8)


class _Inputs:
    """The static input buffers of a capture: the trees (draws,
    sceneset, prev) rebuilt on them, and their upload each frame."""

    def __init__(self, trees, device):
        leaves = _leaves(trees)
        statics = [None] * len(leaves)
        self.packed, self.moved = [], []          # (leaf, offset, bytes), (leaf, tensor)
        size = 0
        for i, a in enumerate(leaves):
            if isinstance(a, torch.Tensor) and a.device.type != "cpu":
                statics[i] = torch.empty(a.shape, dtype=a.dtype, device=device)
                self.moved.append((i, statics[i]))
            else:
                nb = _as_bytes(a).size
                self.packed.append((i, size, nb))
                size += -(-nb // ALIGN) * ALIGN
        self.device_buf = torch.empty(max(size, 1), dtype=torch.uint8, device=device)
        for i, off, nb in self.packed:
            a = np.asarray(leaves[i])
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            statics[i] = self.device_buf[off:off + nb].view(dtype).view(a.shape)
        it = iter(statics)
        self.trees = [map_arrays(t, lambda _: next(it)) for t in trees]
        self.size = max(size, 1)
        self.host = collections.deque()           # (pinned buffer, its copy's event)

    def _free_host(self):
        """A pinned buffer no copy reads any more: the oldest once its
        copy has run (a query, no wait), or once MAX_HOST_BUFFERS are out
        (waited for); else a new one."""
        if self.host:
            buf, ev = self.host[0]
            if len(self.host) >= MAX_HOST_BUFFERS:
                ev.synchronize()
            if ev.query():
                self.host.popleft()
                return buf
        return torch.empty(self.size, dtype=torch.uint8, pin_memory=True)

    def upload(self, trees):
        """Copy this frame's trees (the capture's structure) into the
        static buffers, on the current stream."""
        leaves = _leaves(trees)
        buf = self._free_host()
        host = buf.numpy()
        for i, off, nb in self.packed:
            host[off:off + nb] = _as_bytes(leaves[i])
        self.device_buf.copy_(buf, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.host.append((buf, ev))
        for i, t in self.moved:
            t.copy_(leaves[i], non_blocking=True)


class _Capture:
    """One captured frame: its inputs, its steps grouped by stage, its
    outputs (overwritten by each replay) and what its graphs read by
    address."""

    def __init__(self, inputs, steps, out, keep):
        self.inputs, self.out, self.keep = inputs, out, keep
        self.stages = [(s, list(g)) for s, g in itertools.groupby(steps, lambda x: x.stage)]

    def replay(self, trees):
        with debug_span("frame"):
            for n, (stage, steps) in enumerate(self.stages):
                with debug_span(stage):
                    if n == 0:
                        with debug_span("frame.input.upload"):
                            self.inputs.upload(trees)
                    for step in steps:
                        step.run()
            return _fresh(self.out)


def _fresh(tree):
    """The output tree with each tensor copied."""
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


_KEYABLE = (type(None), bool, int, float, str, bytes)


def _signature(tree, addresses=False):
    """The hashable structure of a tree: its containers and keys, each
    array's dtype and shape (with addresses, a tensor's address, strides
    and device too), each other leaf's value; None if a leaf cannot key
    a frame."""
    if isinstance(tree, dict):
        items = tuple((k, _signature(v, addresses)) for k, v in tree.items())
        return None if any(s is None for _, s in items) else (dict, items)
    if isinstance(tree, (list, tuple)):
        items = tuple(_signature(v, addresses) for v in tree)
        return None if any(s is None for s in items) else (type(tree), items)
    if isinstance(tree, torch.Tensor):
        sig = (tree.dtype, tuple(tree.shape), tree.device.type)
        return sig + (tree.data_ptr(), tree.stride(), tree.device) if addresses else sig
    if isinstance(tree, (np.ndarray, np.generic)):
        return (tree.dtype.str, tree.shape)
    return ("=", type(tree), tree) if isinstance(tree, _KEYABLE) else None


def frame_key(cfg, state, draws, sceneset, prev, device, lights=()):
    """The key of a frame (module docstring), or None when it cannot be
    keyed.  lights: the host light counts the frame runs with (a tuple
    of ints; () where it reads none)."""
    sigs = (_signature(state, addresses=True), _signature(draws), _signature(sceneset),
            _signature(prev))
    if lights is None or any(s is None for s in sigs):
        return None
    return (torch.device(device), cfg, tracing(), lights) + sigs


def _on_device(state, device):
    """Whether every array of state is a tensor on device."""
    ok = []
    map_arrays(state, lambda a: ok.append(isinstance(a, torch.Tensor)
                                          and a.device == device))
    return all(ok)


def _stream(device):
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _capture(cfg, state, trees, device, body, lights):
    """Capture body(cfg, state, draws, sceneset, prev, lights) on the
    static copies of trees; returns its _Capture."""
    inputs = _Inputs(trees, device)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()          # the eager frames' cached blocks, beside the pool
    rec = _Recorder(torch.cuda.graph_pool_handle(), device)
    with torch.cuda.device(device), torch.cuda.stream(_stream(device)), _Recording(rec):
        out = body(cfg, state, *inputs.trees, lights)
        rec.close()
    torch.cuda.current_stream(device).wait_stream(_stream(device))
    keep = rec.keep + [t for t in _leaves([state]) if isinstance(t, torch.Tensor)]
    return _Capture(inputs, rec.steps, out, keep)


def render(cfg, state, draws, sceneset, prev, device, eager, body, lights):
    """A frame with use_pallas on a CUDA device: eager(cfg, state, draws,
    sceneset, prev, device, lights) (render_frame's eager path) for a
    key's first frame, then body(cfg, state, draws, sceneset, prev,
    lights) (the frame after its inputs' upload, on device tensors)
    captured and replayed (module docstring).  lights: as frame_key's;
    None where the frame reads its light counts on the device, which
    runs it eagerly."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = frame_key(cfg, state, draws, sceneset, prev, device, lights) \
        if _on_device(state, device) else None
    trees = (draws, sceneset, prev)
    if key is not None and key in _held:
        _held.move_to_end(key)
        statistic_hit("frame.graph.replay")
        return _held[key].replay(trees)
    seen = 0 if key is None else _seen.pop(key, 0) + 1
    if key is not None:
        _seen[key] = seen
        while len(_seen) > MAX_SEEN:
            _seen.popitem(last=False)
    if seen < 2:
        statistic_hit("frame.graph.eager")
        return eager(cfg, state, draws, sceneset, prev, device, lights)
    statistic_hit("frame.graph.capture")
    while len(_held) >= MAX_CAPTURES:
        _held.popitem(last=False)
    _held[key] = _capture(cfg, state, trees, device, body, lights)
    return _held[key].replay(trees)


def clear():
    """Drop every capture and every key seen."""
    _held.clear()
    _seen.clear()
