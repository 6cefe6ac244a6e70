"""Timed-block profiling ring, statistics, gauges and the debug menu
(counterpart of datum_tpu/debug/debug.py, copied).

A fixed-size global event ring (g_debuglog, 4096 entries) takes frame
markers, begin/end timed blocks, device pass times (gpu_block), and the
log also keeps statistics counters, resource gauges and live-tunable
menu values; stream_debuglog writes the ring in the JAX package's binary
format, which load_debuglog reads back.

The program's tracing (set_tracing, off by default) puts every timed
block on torch.profiler's timeline too, as a range named PREFIX + its
name, on the clock the device's kernels are on.  The frame's own code
paths open their blocks through `span` (and `traced`), which while
tracing is off is a shared no-op: no ring entry, no range."""

from __future__ import annotations

import contextlib
import functools
import struct
import threading
import time

RING_SIZE = 4096

ENTRY_FRAME = 0
ENTRY_BEGIN = 1
ENTRY_END = 2
ENTRY_GPU = 3
ENTRY_STAT = 4
ENTRY_GAUGE = 5

PREFIX = "datum."          # the program's profiler ranges


class DebugLog:
    def __init__(self, size=RING_SIZE):
        self.entries = [None] * size
        self.tail = 0
        self.size = size
        self._lock = threading.Lock()
        self.statistics: dict[str, int] = {}
        self.gauges: dict[str, tuple] = {}
        self.menu_values: dict[str, float] = {}
        self.frame = 0

    def push(self, kind, name, timestamp=None, color=(1, 1, 1), extra=0.0):
        ts = timestamp if timestamp is not None else time.perf_counter()
        i = self.tail % self.size
        self.entries[i] = (kind, name, ts, color, extra, self.frame)
        self.tail += 1

    # --- queries ------------------------------------------------------------
    def block_times(self, frames_back=1):
        """{name: total seconds} over recent frames, pairing begin/end."""
        open_ts = {}
        totals = {}
        lo = max(0, self.tail - self.size)
        min_frame = self.frame - frames_back
        for idx in range(lo, self.tail):
            e = self.entries[idx % self.size]
            if e is None or e[5] < min_frame:
                continue
            kind, name, ts = e[0], e[1], e[2]
            if kind == ENTRY_BEGIN:
                open_ts[name] = ts
            elif kind == ENTRY_END and name in open_ts:
                totals[name] = totals.get(name, 0.0) + ts - open_ts.pop(name)
            elif kind == ENTRY_GPU:
                totals[name] = totals.get(name, 0.0) + e[4]
        return totals


g_debuglog = DebugLog()


def frame_marker():
    g_debuglog.frame += 1
    g_debuglog.push(ENTRY_FRAME, "frame")


def begin_timed_block(name, color=(1, 1, 1)):
    g_debuglog.push(ENTRY_BEGIN, name, color=color)


def end_timed_block(name):
    g_debuglog.push(ENTRY_END, name)


_tracing = False


def set_tracing(on):
    """Turn the program's tracing on or off (off by default)."""
    global _tracing
    _tracing = bool(on)


def tracing():
    """Whether the program's tracing is on."""
    return _tracing


class timed_block:
    """A with-block timed as a begin/end pair in the ring (the end is
    pushed also when the block raises); while tracing is on, also a
    torch.profiler range named PREFIX + name inside that pair."""

    def __init__(self, name, color=(1, 1, 1)):
        self.name, self.color = name, color
        self._range = None

    def __enter__(self):
        begin_timed_block(self.name, self.color)
        if _tracing:
            from torch.profiler import record_function

            self._range = record_function(PREFIX + self.name)
            self._range.__enter__()

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        end_timed_block(self.name)


_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A timed_block of the program's own code paths while tracing is
    on; the shared no-op otherwise."""
    return timed_block(name) if _tracing else _NO_SPAN


def traced(name):
    """Decorator: each call of the function is a span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _tracing:
                return fn(*args, **kwargs)
            with timed_block(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def gpu_block(name, seconds):
    """Record a device pass duration, measured by the caller (CUDA
    events or a synchronised wall clock)."""
    g_debuglog.push(ENTRY_GPU, name, extra=seconds)


def statistic_hit(name, count=1):
    g_debuglog.statistics[name] = g_debuglog.statistics.get(name, 0) + count


def resource_use(name, used, capacity):
    g_debuglog.gauges[name] = (used, capacity)


def debug_menu_value(name, default):
    """Live-tunable value: the menu's value of name, set to default
    on first use."""
    return g_debuglog.menu_values.setdefault(name, default)


def set_debug_menu_value(name, value):
    g_debuglog.menu_values[name] = value


MAGIC = 0x44544C47  # 'GLTD'


def stream_debuglog(path, log: DebugLog | None = None):
    """Binary dump of the event ring: MAGIC and the entry count
    (<II), then per entry <BdfI (kind, time, extra, frame) and the name
    (a length byte and at most 63 bytes)."""
    log = log or g_debuglog
    with open(path, "wb") as f:
        lo = max(0, log.tail - log.size)
        entries = [log.entries[i % log.size] for i in range(lo, log.tail)]
        entries = [e for e in entries if e is not None]
        f.write(struct.pack("<II", MAGIC, len(entries)))
        for kind, name, ts, color, extra, frame in entries:
            nb = name.encode()[:63]
            f.write(struct.pack("<BdfI", kind, ts, extra, frame))
            f.write(struct.pack("<B", len(nb)) + nb)


def load_debuglog(path):
    out = []
    with open(path, "rb") as f:
        magic, count = struct.unpack("<II", f.read(8))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a debuglog dump")
        for _ in range(count):
            kind, ts, extra, frame = struct.unpack("<BdfI", f.read(17))
            (nlen,) = struct.unpack("<B", f.read(1))
            name = f.read(nlen).decode()
            out.append(dict(kind=kind, name=name, time=ts, extra=extra, frame=frame))
    return out


_logged_once = set()


def log_once(message):
    """Print a message at most once per process."""
    if message not in _logged_once:
        _logged_once.add(message)
        print(message)
