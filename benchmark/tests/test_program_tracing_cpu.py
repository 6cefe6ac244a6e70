"""The harness measures the program with the program's own tracing off
(datum_tpu_torch.debug.set_tracing, off by default): no window it
profiles holds a program range, no frame it keeps carries counters, and
the traced result keeps its keys.  With the tracing on, the full
window's program ranges would have device mirrors that trace.Window
counts as device operations, and the host build and the enqueue would
carry the spans' cost."""

import time

import torch
from conftest import add_cell

from framebench import check, runner, spec, trace

CPU = torch.device("cpu")


def test_traced_run_keeps_the_program_tracing_off(bench_copy, one_torch_thread,
                                                   monkeypatch):
    from datum_tpu_torch.debug import debug

    name = add_cell(bench_copy, "tiny", "datumtest-2160p")
    windows, kept = [], []
    real_window, real_to_host = trace.Window.__init__, check.to_host

    def window(self, events, frames, library):
        windows.append({e.name for e in events})
        real_window(self, events, frames, library)

    def to_host(out):
        kept.append(set(out))
        return real_to_host(out)

    monkeypatch.setattr(trace.Window, "__init__", window)
    monkeypatch.setattr(check, "to_host", to_host)
    code, result = runner.run(spec.load_cell(name, bench_copy), seed=2**31 + 99,
                              seconds=2.0, traced=True, device=CPU,
                              t_start=time.perf_counter())
    assert code == 0 and result["correct"] is True
    assert not debug.tracing()
    assert windows and kept
    assert not any(n.startswith(debug.PREFIX) for names in windows for n in names)
    assert not any("counters" in keys for keys in kept)
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"host_build_ms", "enqueue_ms"} <= set(result["metrics"])
