"""BENCHMARK.json and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:
benchmark/configs/<config>.json (the `file` of the configuration's
entry), benchmark/workloads/<traffic>.json, benchmark/cells/<cell>.json
(the cell's limits on the compared numbers) and
benchmark/metrics/<metric>.py (a reader with `read(readings)`).  A later
cell or metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = "benchmark"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    limits: dict          # name -> the limit of each compared number
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reported(entries, cell):
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell called `name` in root/BENCHMARK.json, with its files read."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / BENCH_DIR / "workloads" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / BENCH_DIR / "cells" / f"{name}.json").read_text())["limits"]
    return Cell(name=name, config=config, traffic=traffic, limits=limits,
                end_to_end=_reported(spec["end_to_end"], name),
                per_layer=_reported(spec["per_layer"], name), root=root)


def metric_module(name: str, root: Path = ROOT):
    """benchmark/metrics/<name>.py: read(readings) -> number or None, and
    optionally CAPTURE and work(inputs) (see runner.capturing)."""
    path = root / BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module
