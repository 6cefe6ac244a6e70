"""The benchmark's own tests (python -m pytest benchmark/tests from the
repo root).  CPU tests build the harness's pieces at 128x64; tests that
need a card are marked `cuda` and decide inside a fixture."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a small datumtest scene that renders in well under a second a frame on
# the CPU: no shadows, the rest of the bench's passes
TINY_FRAME = dict(grid=[2, 2], sphere_detail=6, n_point_lights=2, skybox=True,
                  skybox_size=8, max_vertices=2048, max_triangles=2048, bin_capacity=64,
                  big_capacity=16, bin_max_span=8, use_pallas=True,
                  enable_material_maps=True, texture_filter="mip_half",
                  enable_shadows=False, max_translucent_draws=2,
                  max_translucent_tris=512, translucent_lit=True,
                  translucent_lit_layers=1, translucent_lit_scale=2,
                  max_particle_quads=64, max_decals_active=2, decal_textures=False,
                  shadow_factor_scale=4, enable_ssao=True, enable_fog=True,
                  enable_ssr=True, fog_sample_scale=8, forward_bin_capacity=64)
TINY_TRAFFIC = dict(width=128, height=64, hz=60, in_flight=2, t0_max_s=600.0,
                    warm_frames=2, compare_frames=2, profile_frames=2, why="tests")


def add_cell(root, name, limits_from):
    """Add a configuration, a traffic mix, a cell (with the limits of the
    cell `limits_from`) and a per-layer metric to a copy of the benchmark
    as new files and entries; returns the cell's name."""
    b = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    (bench / "configs" / f"{name}.json").write_text(json.dumps(dict(
        name=name, scene="datumtest_scene", frame=TINY_FRAME, reduced=[])))
    (bench / "workloads" / f"{name}-traffic.json").write_text(json.dumps(TINY_TRAFFIC))
    limits = json.loads((bench / "cells" / f"{limits_from}.json").read_text())
    (bench / "cells" / f"{name}-128.json").write_text(json.dumps(limits))
    (bench / "metrics" / f"{name}_frames.py").write_text(
        "def read(r):\n    return float(len(r.intervals_ms))\n")
    b["configs"].append(dict(name=name, source="tests", file=f"benchmark/configs/{name}.json",
                             reduced=[], why="tests"))
    b["workloads"].append(dict(name=f"{name}-128", config=name, traffic=f"{name}-traffic",
                               chips=1, why="tests"))
    for m in b["per_layer"] + b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(f"{name}-128")
    b["per_layer"].append(dict(name=f"{name}_frames", unit="frames", better="higher",
                               source="host_clock", layer="tests", moves="frame_ms",
                               workloads=[f"{name}-128"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return f"{name}-128"


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's data files."""
    shutil.copyfile(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("configs", "workloads", "cells", "metrics"):
        shutil.copytree(BENCH / d, tmp_path / "benchmark" / d)
    return tmp_path


@pytest.fixture
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
