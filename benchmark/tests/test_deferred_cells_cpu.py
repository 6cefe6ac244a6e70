"""The deferred deployment's cell on the CPU at 128x64: a tiny copy of
datumtest-deferred-1080p (TINY_FRAME with the configuration's bilinear
filter, the cell's own limits), added as new files and entries as
add_cell adds one, runs with `correct` true, its traced run captures K5
once and K4 twice a frame for the new roofline readers, and each planted
fault makes it false.  The tiny cell steps t by 1/6 s: at 128x64 a 1/60 s
step can move the scene's lights by less than these pixels resolve, so
that the previous frame (the stale fault) passes for the current one at
some t0, while at 1920x1088 it fails the cell (PERF.md §2)."""

import io
import json
import time

import pytest
import torch
from conftest import BENCH, ROOT, TINY_FRAME, add_cell

from framebench import faults, loop, runner, spec

CPU = torch.device("cpu")
CELL = "datumtest-deferred-1080p"


def add_deferred_cell(root):
    """add_cell's tiny cell with datumtest-deferred's frame change, the
    limits of datumtest-deferred-1080p and 6 Hz steps."""
    name = add_cell(root, "tinydef", CELL)
    traffic = root / "benchmark" / "workloads" / "tinydef-traffic.json"
    traffic.write_text(json.dumps(dict(json.loads(traffic.read_text()), hz=6)))
    base = json.loads((BENCH / "configs" / "datumtest.json").read_text())["frame"]
    deferred = json.loads((BENCH / "configs" / "datumtest-deferred.json").read_text())
    changed = {k: v for k, v in deferred["frame"].items() if base.get(k) != v}
    path = root / "benchmark" / "configs" / "tinydef.json"
    config = json.loads(path.read_text())
    config["frame"] = dict(TINY_FRAME, **changed)
    path.write_text(json.dumps(config))
    return name


def _run(root, cell_name, traced=False, seconds=2.0, seed=2**31 + 4321):
    err = io.StringIO()
    code, result = runner.run(spec.load_cell(cell_name, root), seed=seed, seconds=seconds,
                              traced=traced, device=CPU, t_start=time.perf_counter(), err=err)
    return code, result, err.getvalue()


def test_new_cells_and_readers_are_entries():
    b = spec.load_spec(ROOT)
    cells = {w["name"]: w for w in b["workloads"]}
    assert cells[CELL]["config"] == "datumtest-deferred"
    assert cells["datumtest-1080p"]["config"] == "datumtest"
    for name in (CELL, "datumtest-1080p"):
        cell = spec.load_cell(name)
        assert (cell.traffic["width"], cell.traffic["height"]) == (1920, 1088)
        assert set(cell.limits) == {"image_rmse", "vis_mismatch", "depth_max", "ao_max",
                                    "lum_rel"}
        assert {m["name"] for m in cell.end_to_end} == {"setup_s", "frame_ms"}
    deferred = {m["name"] for m in spec.load_cell(CELL).per_layer}
    assert deferred == {"k5_roofline_pct", "k4_roofline_pct"}
    # the megakernel cell at 1080p reports what datumtest-2160p reports
    # of the layers, the K1 and K2 shares among them
    megakernel = {m["name"] for m in spec.load_cell("datumtest-1080p").per_layer}
    assert megakernel == {m["name"] for m in spec.load_cell("datumtest-2160p").per_layer}
    for m in deferred | megakernel:
        assert callable(spec.metric_module(m).read)


def test_run_is_correct_and_captures_k5_and_k4(bench_copy, one_torch_thread):
    name = add_deferred_cell(bench_copy)
    cell = spec.load_cell(name, bench_copy)
    assert cell.config["frame"]["texture_filter"] == "bilinear"
    assert cell.limits == spec.load_cell(CELL).limits
    code, result, err = _run(bench_copy, name, traced=True)
    assert code == 0 and result["correct"] is True, err
    # the device's readers find nothing on the CPU and leave their
    # metrics out; the K5 and K4 wrappers' calls were captured: 1 and 2
    # a frame over the window's 2 frames, no K1 or K2
    assert not {"k5_roofline_pct", "k4_roofline_pct"} & set(result["metrics"])
    assert "k5_roofline_pct 2" in err and "k4_roofline_pct 4" in err, err
    assert "k1_roofline_pct []" in err and "k2_roofline_pct []" in err, err


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_fails_the_deferred_run(bench_copy, one_torch_thread, monkeypatch, fault):
    name = add_deferred_cell(bench_copy)
    real = loop.program_side
    monkeypatch.setattr(loop, "program_side",
                        lambda: faults.broken_side(real(), faults.FAULTS[fault]))
    code, result, err = _run(bench_copy, name)
    assert code == 0 and result["correct"] is False, err
