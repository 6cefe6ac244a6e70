"""The harness on the CPU at 128x64: its loop, its result line, the files
it finds by name, the command without a card, and the faults that have
to make `correct` false."""

import filecmp
import io
import json
import subprocess
import sys
import time

import pytest
import torch
from conftest import BENCH, ROOT, add_cell

from framebench import faults, loop, runner, spec

CPU = torch.device("cpu")


def _run(root, cell_name, traced=False, seconds=2.0, seed=2**31 + 12345):
    err = io.StringIO()
    code, result = runner.run(spec.load_cell(cell_name, root), seed=seed, seconds=seconds,
                              traced=traced, device=CPU, t_start=time.perf_counter(), err=err)
    return code, result, err.getvalue()


def test_new_files_found_by_name(bench_copy):
    name = add_cell(bench_copy, "tiny", "datumtest-2160p")
    cell = spec.load_cell(name, bench_copy)
    assert cell.config["scene"] == "datumtest_scene" and cell.traffic["width"] == 128
    limits = json.loads((BENCH / "cells" / "datumtest-2160p.json").read_text())["limits"]
    assert cell.limits == limits
    assert "tiny_frames" in [m["name"] for m in cell.per_layer]
    assert spec.metric_module("tiny_frames", bench_copy).read(
        runner.Readings(intervals_ms=[1.0, 2.0])) == 2.0
    # the files that were there are untouched
    for d in ("configs", "workloads", "cells", "metrics"):
        cmp = filecmp.dircmp(BENCH / d, bench_copy / "benchmark" / d)
        assert not cmp.diff_files and not cmp.left_only
    assert spec.load_cell("datumtest-2160p", bench_copy).config == \
        spec.load_cell("datumtest-2160p").config


def test_run_and_result_line(bench_copy, one_torch_thread):
    name = add_cell(bench_copy, "tiny", "datumtest-2160p")
    code, result, err = _run(bench_copy, name)
    assert code == 0 and result["correct"] is True
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["device"]["count"] == 1
    limits = json.loads((BENCH / "cells" / "datumtest-2160p.json").read_text())["limits"]
    assert set(result["compared"]) == set(limits)
    # the compared numbers beside their limits are the last lines
    tail = err.strip().splitlines()[-len(limits):]
    assert [line.split()[0] for line in tail] == sorted(limits)
    assert all(" limit " in line for line in tail)
    json.dumps(result)


def test_traced_run(bench_copy, one_torch_thread):
    name = add_cell(bench_copy, "tiny", "datumtest-2160p")
    code, result, err = _run(bench_copy, name, traced=True)
    assert code == 0 and result["correct"] is True
    m = result["metrics"]
    # the host spans and the test's own metric read on the CPU; the
    # device's readers find nothing there and leave their metrics out
    assert {"host_build_ms", "enqueue_ms", "tiny_frames"} <= set(m)
    assert not {"k1_roofline_pct", "k2_roofline_pct", "torch_device_ms"} & set(m)
    assert not {"setup_s", "frame_ms", "frame_p95_ms"} & set(m)
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # K1 and K2 on the opaque and the lit layer of each profiled frame
    assert "captured launches: k1_roofline_pct 4, k2_roofline_pct 4" in err


def test_command_needs_a_card():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "datumtest-2160p",
                        "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_fails_the_run(bench_copy, one_torch_thread, monkeypatch, fault):
    """The run with the timed path broken underneath reads correct false
    under the cell's limits.  (The cell runs on one chip: there is no
    exchange between chips to leave out.)"""
    name = add_cell(bench_copy, "tiny", "datumtest-2160p")
    real = loop.program_side
    monkeypatch.setattr(loop, "program_side",
                        lambda: faults.broken_side(real(), faults.FAULTS[fault]))
    code, result, err = _run(bench_copy, name)
    assert code == 0 and result["correct"] is False, err
