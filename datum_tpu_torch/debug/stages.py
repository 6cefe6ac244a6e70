"""The program's spans read back from a torch.profiler window, in memory.

While the program's tracing is on (debug.set_tracing), every span is a
profiler range named PREFIX + its name on the host (the frame, its
stages and their parts; the host frame build).  Stages reads a finished
profiler's raw events and puts down to each span name, a frame:

- host_ms: the time its ranges were open on the host;
- device_ms: the device time of the operations (kernels, copies, sets)
  whose runtime call ran while one of its ranges was open;
- launches: the kernel-launch calls made while one was open;
- syncs and sync_ms: the host's synchronize calls (stream, event,
  device) made while one was open, and the time they blocked.

A device operation is put down to the spans open when its runtime call
ran: the profiler gives the operation and its runtime call one
correlation id (`linked` counts the operations matched so).  The
ranges' own device mirrors are not operations.  Spans nest on the host's one
frame thread, so the ranges open at an instant are a stack, and each
idle stretch of the device is labelled with the innermost span open on
the host at its middle.

    stages = profile_stages(lambda: [render(d, s) for d, s in inputs], len(inputs))
    print(stages.format())
"""

from __future__ import annotations

import dataclasses

from .debug import PREFIX, set_tracing, tracing

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize")


@dataclasses.dataclass(frozen=True)
class Event:
    """One profiler event: times in ns on the profiler's clock; corr its
    correlation id."""
    name: str
    on_device: bool
    start: int
    end: int
    corr: int = 0


def profile_events(prof):
    """The Events of a finished torch.profiler.profile (its raw results,
    which is much faster than prof.events())."""
    from torch.autograd import DeviceType

    return [Event(e.name(), e.device_type() != DeviceType.CPU, e.start_ns(),
                  e.start_ns() + e.duration_ns(), e.correlation_id())
            for e in prof.profiler.kineto_results.events()]


def _open_at(spans, times):
    """For each time, the indices of the spans open at it, outermost
    first (spans: [(start, end, ...)] that nest)."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][0], -spans[i][1]))
    out = [()] * len(times)
    stack, j = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(order) and spans[order[j]][0] <= t:
            while stack and spans[stack[-1]][1] <= spans[order[j]][0]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and spans[stack[-1]][1] <= t:
            stack.pop()
        out[q] = tuple(stack)
    return out


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Stages:
    """The spans of a window of `frames` frames (events: Events)."""

    def __init__(self, events, frames):
        self.frames = frames
        host = [e for e in events if not e.on_device]
        ranges = {e.name for e in host}
        self.spans = sorted((e.start, e.end, e.name[len(PREFIX):]) for e in host
                            if e.name.startswith(PREFIX))
        # the device's operations, without the host ranges' mirrors
        self.device_ops = [e for e in events if e.on_device and e.name not in ranges]
        # the runtime calls (cudaLaunchKernel, cudaMemcpyAsync, ...)
        calls = {e.corr: e.start for e in host if e.name.startswith("cu")}
        issued = [calls.get(d.corr) for d in self.device_ops]
        self.linked = sum(t is not None for t in issued)
        self.launches = [e for e in host if e.name in LAUNCH_CALLS]
        self.syncs = [e for e in host if e.name in SYNC_CALLS]

        rows = {}
        for s, e, name in self.spans:
            r = rows.setdefault(name, dict(host=0, device=0, launches=0, syncs=0,
                                           sync=0, ranges=0))
            r["host"] += e - s
            r["ranges"] += 1

        def add(items, times, key, amount):
            open_ = _open_at(self.spans, [t if t is not None else -1 for t in times])
            for item, t, idx in zip(items, times, open_):
                if t is None:
                    continue
                for name in {self.spans[i][2] for i in idx}:
                    rows[name][key] += amount(item)

        add(self.device_ops, issued, "device", lambda d: d.end - d.start)
        add(self.launches, [e.start for e in self.launches], "launches", lambda e: 1)
        add(self.syncs, [e.start for e in self.syncs], "syncs", lambda e: 1)
        add(self.syncs, [e.start for e in self.syncs], "sync", lambda e: e.end - e.start)
        self.rows = rows
        self.device_ns = sum(d.end - d.start for d in self.device_ops)

    def row(self, name):
        """{host_ms, device_ms, launches, syncs, sync_ms} a frame of the
        span `name` (without the prefix), or None if it never opened."""
        r = self.rows.get(name)
        if r is None:
            return None
        f = self.frames
        return dict(host_ms=r["host"] / f / 1e6, device_ms=r["device"] / f / 1e6,
                    launches=r["launches"] / f, syncs=r["syncs"] / f,
                    sync_ms=r["sync"] / f / 1e6, ranges=r["ranges"] / f)

    def table(self):
        """[(name, row)] of every span, in the order they first opened."""
        seen = {}
        for _, _, name in self.spans:
            seen.setdefault(name, None)
        return [(name, self.row(name)) for name in seen]

    def innermost(self, t):
        """The innermost span open on the host at time t (ns), or None."""
        idx = _open_at(self.spans, [t])[0]
        return self.spans[idx[-1]][2] if idx else None

    def idle_gaps(self, window=None, top=10):
        """The `top` longest stretches of `window` (start, end ns; default:
        from the first span's start to the last one's end) in which the
        device ran nothing: [(the innermost span open on the host at its
        middle or "other", ms)]."""
        if window is None:
            window = (self.spans[0][0], max(e for _, e, _ in self.spans))
        lo, hi = window
        busy = _merge([(max(d.start, lo), min(d.end, hi)) for d in self.device_ops
                       if d.end > lo and d.start < hi])
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        gaps = sorted(((b - a, a) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                      reverse=True)[:top]
        return [(self.innermost(a + g // 2) or "other", g / 1e6) for g, a in gaps]

    def format(self):
        """The table and the longest idle gaps as text lines."""
        lines = [f"{'span':34s} {'host ms':>9s} {'device ms':>9s} {'launches':>8s} "
                 f"{'syncs':>6s} {'sync ms':>8s}  (a frame, over {self.frames})"]
        for name, r in self.table():
            lines.append(f"{name:34s} {r['host_ms']:9.3f} {r['device_ms']:9.3f} "
                         f"{r['launches']:8.1f} {r['syncs']:6.1f} {r['sync_ms']:8.3f}")
        lines.append(f"device ops {len(self.device_ops)} ({self.linked} linked to their "
                     f"runtime call), {self.device_ns / self.frames / 1e6:.3f} device ms a frame")
        if self.spans and self.device_ops:
            lines.append("longest idle gaps (ms): " + ", ".join(
                f"{n} {ms:.3f}" for n, ms in self.idle_gaps()))
        return "\n".join(lines)


class tracing_on:
    """The program's tracing on inside a with-block, put back after it."""

    def __enter__(self):
        self.was = tracing()
        set_tracing(True)

    def __exit__(self, *exc):
        set_tracing(self.was)


def profile_stages(run, frames, device=None):
    """Run run() (which issues `frames` frames) under torch.profiler with
    the program's tracing on, then synchronize `device` (a CUDA device
    also records the CUDA activity); returns their Stages."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with tracing_on(), profile(activities=activities) as prof:
        run()
        if cuda:
            torch.cuda.synchronize(device)
    return Stages(profile_events(prof), frames)
