"""One run of one cell: set-up, the measured window, with --trace 1 the
profiled window, the comparison with the reference, the result line.

Set-up: the configuration's scene and its sky bake, the device state,
the kernel library (built by nvcc in the checkout on a cell's first
run), and `warm_frames` frames of the loop, each copied to the host for
the comparison.  The window then runs the loop for --seconds and ends
with a synchronize.  The end-to-end metrics (--trace 0), each reported
in the cells that BENCHMARK.json lists for it: setup_s (process start
to the window's start), frame_ms (the window's wall time over its
frames) and frame_p95_ms (the 95th percentile of the device-timed
intervals between consecutive frames' end events).  With --trace 1 the
window also records the benchmark's host spans, two torch.profiler
windows of `profile_frames` frames follow it (the CUDA activity alone,
for the device's busy share; then the CPU and CUDA activities, for the
rest), and each per-layer metric's reader (benchmark/metrics/) takes its
number from those; a reader that finds nothing leaves its metric out.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import importlib
import inspect
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from . import check, loop, spec, trace
from .guard import forbidden_modules


class Readings:
    """What the per-layer readers read: spans (seconds of each frame's
    wait, build and enqueue in the window), window (trace.Window of the
    CPU and CUDA activities), device_window (trace.Window of the CUDA
    activity alone), work ({metric: the bound seconds of each captured
    launch}), frames_profiled, intervals_ms and frame_ms of the window."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


@contextlib.contextmanager
def capturing(readers):
    """Record the arguments of the program functions each reader names
    in its CAPTURE (module, function names); yields {metric: [kwargs]}."""
    got, saved = {}, []
    for name, module in readers.items():
        cap = getattr(module, "CAPTURE", None)
        if cap is None:
            continue
        got[name] = []
        mod = importlib.import_module(cap[0])
        for fn_name in cap[1]:
            orig = getattr(mod, fn_name)

            @functools.wraps(orig)          # the function's attributes too
            def wrapped(*a, _orig=orig, _sig=inspect.signature(orig), _list=got[name], **k):
                _list.append(dict(_sig.bind(*a, **k).arguments))
                return _orig(*a, **k)

            setattr(mod, fn_name, wrapped)
            saved.append((mod, fn_name, orig))
    try:
        yield got
    finally:
        for mod, fn_name, orig in saved:
            setattr(mod, fn_name, orig)


def _device_info(device):
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=1, memory_peak_bytes=torch.cuda.max_memory_allocated(device))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)


def warm(fl, traffic):
    """The set-up's frames; returns the chain's start: [(t, the frame's
    outputs on the host)] of each."""
    chain = []
    fl.run(count=traffic["warm_frames"],
           keep=lambda i, out, prev: chain.append((fl.t(i), check.to_host(out))))
    loop.synchronize(fl.device)
    return chain


def window(fl, traffic, seconds, rng, spans=None):
    """The measured window: (the sample, [(i, outputs)] of its first
    frame, the events, its seconds)."""
    sample = loop.Sample(traffic["compare_frames"], rng)
    first = []

    def keep(i, out, prev):
        if not first:
            first.append((i, out))
        sample.offer(i, out, prev)

    w0 = time.perf_counter()
    events = fl.run(until=w0 + seconds, spans=spans, keep=keep)
    loop.synchronize(fl.device)
    return sample, first, events, time.perf_counter() - w0


def compared_frames(fl, chain, first, sample):
    """(the chain: the warm frames and the window's first, each (t,
    outputs); the sample: each (t, outputs, prev)), on the host."""
    chain = chain + [(fl.t(i), check.to_host(out)) for i, out in first]
    return chain, [(fl.t(i), check.to_host(out), check.prev_to_host(prev))
                   for i, out, prev in sorted(sample.kept, key=lambda k: k[0])]


def program_loop(cell, device, seed, side=None, scene=None, state=None):
    """The program's scene (built unless given) and a loop from the seed's
    t0; returns (loop, the run's random stream)."""
    side = side or loop.program_side()
    scene = scene or loop.build_scene(side, cell.config, cell.traffic, device)
    state = state if state is not None else scene.ctx.device_state(device)
    t0, rng = loop.start_time(seed, cell.traffic)
    return loop.FrameLoop(side, scene, state, device, t0, cell.traffic["hz"],
                          cell.traffic["in_flight"]), rng


def run(cell, *, seed, seconds, traced, device, t_start, err=sys.stderr):
    """One run; returns (exit code, the result dict or None)."""
    tr = cell.traffic
    fl, rng = program_loop(cell, device, seed)
    chain = warm(fl, tr)
    setup_s = time.perf_counter() - t_start

    spans = {} if traced else None
    sample, first, events, window_s = window(fl, tr, seconds, rng, spans)
    n = len(events) - 1
    intervals = loop.intervals_ms(events)
    frame_ms = window_s * 1e3 / n

    result = dict(correct=False, attempted=n, failed=0, metrics={})
    if traced:
        readers = {m["name"]: spec.metric_module(m["name"], cell.root)
                   for m in cell.per_layer}
        frames = tr["profile_frames"]
        package = Path(importlib.import_module("datum_tpu_torch").__file__).parent
        library = trace.library_kernels(package)

        def run_frames(label):
            fl.run(count=frames, label=label)
            loop.synchronize(device)

        dwin = (trace.profile_device(run_frames, frames, library, device)
                if device.type == "cuda" else None)
        with capturing(readers) as captured:
            win = trace.profile(run_frames, frames, library)
        work = {}
        for name, calls in captured.items():
            bounds = [readers[name].work(c) for c in calls]
            work[name] = None if any(b is None for b in bounds) else bounds
        del captured
        r = Readings(spans=spans, window=win, device_window=dwin, work=work,
                     frames_profiled=frames, intervals_ms=intervals, frame_ms=frame_ms)
        for m in cell.per_layer:
            v = readers[m["name"]].read(r)
            if v is not None:
                result["metrics"][m["name"]] = dict(value=float(v), unit=m["unit"])
        result["breakdown"] = win.breakdown()
        lib = {}
        for k, sec in win.kernels():
            if k in win.library:
                c, t = lib.get(k, (0, 0.0))
                lib[k] = (c + 1, t + sec)
        print(f"trace: {frames} frames, {len(win.device_ops)} device operations, "
              f"{win.launches} launches; the library's kernels (launches, ms): "
              + ", ".join(f"{k} {c} {t * 1e3:.4f}" for k, (c, t) in sorted(lib.items()))
              + "; captured launches: " + ", ".join(
                  f"{k} {len(v) if v else v}" for k, v in work.items()), file=err)
        if dwin is not None:
            print(f"device-only trace: window {dwin.window_s * 1e3:.3f} ms (from "
                  f"{dwin.span_from}), busy {dwin.busy_s * 1e3:.3f} ms, "
                  f"{len(dwin.device_ops)} device operations, {dwin.launches} launches; "
                  f"the full trace's window {win.window_s * 1e3:.3f} ms, busy "
                  f"{win.busy_s * 1e3:.3f} ms", file=err)
    else:
        values = dict(setup_s=setup_s, frame_ms=frame_ms,
                      frame_p95_ms=statistics.quantiles(intervals, n=20)[18])
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    result["device"] = _device_info(device)
    if traced:
        busy = dwin if dwin is not None else win
        result["device"].update(busy_s=busy.busy_s, window_s=busy.window_s)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=err)
        return 1, None

    # the comparison, after the peak was read and the program's state freed
    chain, sampled = compared_frames(fl, chain, first, sample)
    overflow = [int(c[1]["bin_overflow"]) for c in chain + sampled]
    del fl, sample, first, events
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    reference = check.Reference(cell, device)
    r1 = time.perf_counter()
    numbers = check.worst(check.readings(reference, chain, sampled))
    del reference
    r2 = time.perf_counter()
    ok, judged = check.judge(numbers, cell.limits)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=err)
        return 1, None
    result["correct"] = ok
    result["compared"] = judged
    print(f"reference: scene {r1 - r0:.1f} s, {len(chain) + len(sampled)} frames "
          f"{r2 - r1:.1f} s (chain t {', '.join(f'{c[0]:.4f}' for c in chain)}; sample t "
          f"{', '.join(f'{c[0]:.4f}' for c in sampled)}); frames in the window {n}; "
          f"main bin_overflow {overflow}; unjudged: " + ", ".join(
              f"{k} {v!r}" for k, v in numbers.items() if k not in judged), file=err)
    for k, c in judged.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=err)
    return 0, result


def main(argv, t_start):
    import argparse

    ap = argparse.ArgumentParser(description="one run of one cell of the frame benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    chips = next(w["chips"] for w in spec.load_spec()["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    code, result = run(cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
                       device=torch.device("cuda", 0), t_start=t_start)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code
