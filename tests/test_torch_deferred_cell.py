"""The benchmark's deferred deployment (benchmark/configs/datumtest-
deferred.json) at 128x64 on the CPU: its `frame` keys cut down as the
benchmark's own tests cut datumtest's (benchmark/tests/conftest.py::
TINY_FRAME), rendered by datum_tpu_torch's render_frame and by the
benchmark's plain reference (benchmark/plainframe) through the
benchmark's frame loop: a chain of 3 frames from a seeded t0, each side
on its own SSAO history, then one frame given the program's `prev`.
The image, depth, vis, luminance and the AO history stay within the
limits of the cell datumtest-deferred-1080p, and the frame takes the
deferred branch's K5 route: use_shade_kernel False, K5 once and K4
twice a frame, no K1 or K2.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
CELL = "datumtest-deferred-1080p"
SEED = 2**31 + 2021
CHAIN = 3


def _bench_conftest():
    """benchmark/tests/conftest.py as a module of its own name, with
    benchmark/ at the end of sys.path (for framebench and plainframe)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("benchmark_tests_conftest",
                                                  BENCH / "tests" / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    sys.path[:] = path + ([str(BENCH)] if str(BENCH) not in path else [])
    return module


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _tiny_deferred_frame(tiny):
    """tiny (TINY_FRAME) with every key that datumtest-deferred changes
    from datumtest (the texture filter)."""
    base, deferred = _config("datumtest")["frame"], _config("datumtest-deferred")["frame"]
    changed = {k: v for k, v in deferred.items() if base.get(k) != v}
    assert changed == {"texture_filter": "bilinear"}
    return dict(tiny, **changed)


def _counting(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def wrapped(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return orig(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def run():
    """The program's chain and sampled frame, each side's readings and the
    kernel wrappers' calls a frame."""
    from datum_tpu_torch.ops import raster_blend_cuda, raster_cuda, raster_v1_cuda, shade_cuda
    from datum_tpu_torch.render import frame as F

    conf = _bench_conftest()
    from framebench import check, loop, spec

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    limits = json.loads((BENCH / "cells" / f"{CELL}.json").read_text())["limits"]
    config = dict(_config("datumtest-deferred"), frame=_tiny_deferred_frame(conf.TINY_FRAME))
    traffic = dict(conf.TINY_TRAFFIC, warm_frames=CHAIN)
    cell = spec.Cell(name="tiny-deferred", config=config, traffic=traffic, limits=limits,
                     end_to_end=[], per_layer=[], root=ROOT)
    calls, per_frame = {}, []
    with pytest.MonkeyPatch.context() as mp:
        for module, names in ((raster_v1_cuda, ("raster_v1_reference",)),
                              (raster_blend_cuda, ("raster_blend_reference",)),
                              (raster_cuda, ("raster_shade_reference",
                                             "raster_shade_2p_reference")),
                              (shade_cuda, ("shade_deferred_reference",))):
            for name in names:
                _counting(mp, module, name, calls)
        side = loop.program_side()
        scene = loop.build_scene(side, config, traffic, cpu)
        state = scene.ctx.device_state(cpu)
        t0, _ = loop.start_time(SEED, traffic)
        fl = loop.FrameLoop(side, scene, state, cpu, t0, traffic["hz"], traffic["in_flight"])
        kept = []

        def keep(i, out, prev):
            kept.append((fl.t(i), out, prev))
            per_frame.append(dict(calls))
            calls.clear()

        fl.run(count=CHAIN + 1, keep=keep)
    chain = [(t, check.to_host(out)) for t, out, _ in kept[:CHAIN]]
    t, out, prev = kept[CHAIN]
    sample = [(t, check.to_host(out), check.prev_to_host(prev))]
    reference = check.Reference(cell, cpu)
    readings = check.readings(reference, chain, sample)
    torch.set_num_threads(threads)
    yield dict(shade_kernel=F.use_shade_kernel(scene.cfg, state), per_frame=per_frame,
               readings=readings, limits=limits, frames=chain + sample,
               sampled_prev=prev)


def test_route_is_k5_and_two_k4_passes(run):
    assert run["shade_kernel"] is False
    assert run["per_frame"] == [dict(raster_v1_reference=1, raster_blend_reference=2)] * (
        CHAIN + 1)


def test_history_carried_through_the_chain(run):
    assert run["sampled_prev"] is not None
    assert all("ao" in f[1] for f in run["frames"])
    assert len(run["readings"]) == CHAIN + 1
    assert all("ao_max" in r for r in run["readings"])


@pytest.mark.parametrize("number", ["image_rmse", "vis_mismatch", "depth_max", "ao_max",
                                    "lum_rel"])
def test_within_the_cell_limits(run, number):
    from framebench import check

    assert number in run["limits"]
    worst = check.worst(run["readings"])
    assert worst[number] <= run["limits"][number], (number, worst)
