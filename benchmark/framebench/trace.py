"""torch.profiler windows over a few steady frames, read in memory.

From the profiler's events (nothing is written to disk): the device
operations (kernels, copies and sets) with their intervals on the trace's
timeline, the kernel-launch calls on the host, the window's own span and
the benchmark's host spans (wait, build, enqueue) around each frame.

Two windows: `profile` records the CPU and CUDA activities (the host's
ops, ranges and launches beside the device's), which slows the host's
side of a frame; `profile_device` records the CUDA activity alone, which
leaves the host near its untraced pace, for the device's busy share.
"""

from __future__ import annotations

import re
from pathlib import Path

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALL = "cudaDeviceSynchronize"
LABEL = "bench."
WINDOW = LABEL + "window"
HOST_SPANS = ("wait", "build", "enqueue")


def kernel_name(name):
    """The function name of a device kernel's name, demangled
    ('void ns::f<T>(float const*, ...)' -> 'f') or not ('_Z1fILi2EEvPKf'
    -> 'f')."""
    m = re.match(r"_Z(?:N\d*)?(\d+)", name)
    if m:
        return name[m.end():m.end() + int(m.group(1))]
    name = name.replace("(anonymous namespace)::", "")
    head = re.split(r"[(<]", name, maxsplit=1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


def library_kernels(package_dir):
    """The kernels the program's hand-written library defines: each
    __global__ function's name in its csrc/*.cu."""
    pat = re.compile(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(")
    names = set()
    for src in sorted(Path(package_dir, "csrc").glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return names


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Window:
    """The events of one profiled window of `frames` frames; times in s."""

    def __init__(self, events, frames, library):
        from torch.autograd import DeviceType

        self.frames, self.library = frames, library
        self.device_ops = []        # (name, start, end)
        self.launches = 0
        self.host = []              # (label, start, end)
        self.span = None
        syncs = []
        for e in events:
            name = e.name
            a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == DeviceType.CUDA:
                if not name.startswith(LABEL):       # the ranges' device mirrors
                    self.device_ops.append((name, a, b))
            elif name == WINDOW:
                self.span = (a, b)
            elif name.startswith(LABEL):
                self.host.append((name[len(LABEL):], a, b))
            elif name in LAUNCH_CALLS:
                self.launches += 1
            elif name == SYNC_CALL:
                syncs.append(b)
        self.span_from = "range"
        if self.span is None and len(syncs) >= 2:
            # no ranges (CUDA activity alone): the window runs from the
            # end of the synchronize before its frames to the end of the
            # one after them
            self.span, self.span_from = (min(syncs), max(syncs)), SYNC_CALL
        if self.span is None:
            raise RuntimeError(f"the profiled window has neither a {WINDOW!r} range "
                               f"nor two {SYNC_CALL} calls")
        lo, hi = self.span
        self.busy = _merge([(max(a, lo), min(b, hi)) for _, a, b in self.device_ops
                            if b > lo and a < hi])

    @property
    def window_s(self):
        return self.span[1] - self.span[0]

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy)

    def kernels(self):
        """(kernel function name, seconds) of every kernel launch."""
        return [(kernel_name(n), b - a) for n, a, b in self.device_ops
                if not n.startswith(("Memcpy", "Memset"))]

    def kernel_s(self, name):
        """Device seconds a frame of the kernel `name`."""
        return sum(s for k, s in self.kernels() if k == name) / self.frames

    def idle_gaps(self):
        """(host span in progress at the gap's middle, seconds) of every
        stretch of the window in which the device ran nothing."""
        lo, hi = self.span
        edges = [lo] + [x for ab in self.busy for x in ab] + [hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            label = next((n for n, s, e in self.host if s <= mid < e), "other")
            out.append((label, b - a))
        return out

    def breakdown(self, top=10):
        by_name = {}
        for n, a, b in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda kv: -kv[1])[:top]
        return dict(device_ops=[[n[:200], s] for n, s in ops],
                    idle_gaps=[[n, s] for n, s in gaps])


def profile(run_frames, frames, library):
    """Run `run_frames(label)` (which renders `frames` frames and
    synchronizes) under torch.profiler with the CPU and CUDA activities,
    inside the window's range; returns its Window."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    def label(name):
        return record_function(LABEL + name)

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            run_frames(label)
    return Window(prof.events(), frames, library)


def profile_device(run_frames, frames, library, device):
    """Run `run_frames(label)` under torch.profiler with the CUDA activity
    alone, between two synchronizes that bound the window; returns its
    Window (no host ranges: its idle gaps are all "other")."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        run_frames(lambda _name: contextlib.nullcontext())
    return Window(prof.events(), frames, library)
