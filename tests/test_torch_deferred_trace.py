"""The program's tracing on the deferred branch's K5 route (the
benchmark's datumtest-deferred configuration, bilinear filter) at
128x64 on the CPU, with the sun cascades and a spot map:

- on: debug/stages.py's table of the frame has the visibility raster
  (frame.raster.k5) and the gbuffer resolve (frame.raster.resolve)
  inside frame.raster, and the lighting pass's terms
  (frame.shade.lighting.env, .probes, .sun, .points, .spots) inside
  frame.shade.lighting; the frame's counters hold the entries dropped by
  the main bins, each sun stack, the spot map and both weighted-blend
  passes;
- off: the two functions that gained spans (render/frame.py::
  _deferred_raster, ops/lighting_pass.py::shade_deferred) run the same
  operations, in the same order and to the same bits, as they did
  without the spans: the benchmark's frozen plain copies of their
  modules (benchmark/plainframe, copied from the port before the
  spans), each loaded inside the port's package so that it calls the
  port's own helpers.  The spans add nothing to an untraced frame.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from datum_tpu_torch.debug import debug
from datum_tpu_torch.debug import stages as st
from datum_tpu_torch.ops import lighting_pass
from datum_tpu_torch.render import frame as F
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import datumtest_scene

BENCH = Path(__file__).resolve().parents[1] / "benchmark"

SMALL = dict(width=128, height=64, grid=(2, 2), sphere_detail=6, n_point_lights=2,
             skybox=True, skybox_size=8, max_vertices=2048, max_triangles=2048,
             bin_capacity=64, big_capacity=16, bin_max_span=8, use_pallas=True,
             enable_material_maps=True, texture_filter="bilinear",
             enable_shadows=True, shadow_mode="esm", shadow_res=128,
             shadow_bin_capacity=64, max_spot_shadows=1, spot_shadow_mode="parabolic",
             spot_shadow_res=128, max_translucent_draws=2, max_translucent_tris=512,
             max_particle_quads=64, max_decals_active=2, decal_textures=False,
             shadow_factor_scale=4, enable_ssao=True, enable_fog=True, enable_ssr=True,
             fog_sample_scale=8, forward_bin_capacity=64)
T = 0.3
PARTS = {"frame.raster": ["frame.raster.bins", "frame.raster.k5", "frame.raster.resolve"],
         "frame.shade.lighting": [f"frame.shade.lighting.{p}" for p in
                                  ("env", "probes", "sun", "points", "spots")]}


@pytest.fixture(autouse=True)
def _tracing_off_after():
    yield
    debug.set_tracing(False)


@pytest.fixture(scope="module")
def scene():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    ctx, camera, params, make_rl = datumtest_scene(device="cpu", **SMALL)
    state = ctx.device_state("cpu")
    rl = make_rl(T)
    draws = ctx.frame_draws(rl, camera)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights, probes=rl.probes)
    yield ctx.config, state, draws, ss
    torch.set_num_threads(threads)


def _render(scene):
    cfg, state, draws, ss = scene
    return F.render_frame(cfg, state, draws, ss, device="cpu")


@pytest.fixture(scope="module")
def traced(scene):
    """One frame under the CPU profiler with tracing on: (outputs,
    Stages, the program's ranges)."""
    from torch.profiler import ProfilerActivity, profile

    assert not F.use_shade_kernel(scene[0], scene[1])
    debug.set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _render(scene)
    debug.set_tracing(False)
    events = st.profile_events(prof)
    ranges = sorted((e.start, e.end, e.name[len(debug.PREFIX):]) for e in events
                    if not e.on_device and e.name.startswith(debug.PREFIX))
    return out, st.Stages(events, 1), ranges


@pytest.mark.parametrize("stage", sorted(PARTS))
def test_stage_table_has_the_parts_under_their_stage(traced, stage):
    _, stages, ranges = traced
    rows = [name for name, _ in stages.table()]
    assert stage in rows and set(PARTS[stage]) <= set(rows)
    # each part's ranges open and close inside one of its stage's ranges
    outer = [(a, b) for a, b, n in ranges if n == stage]
    for a, b, name in ranges:
        if name in PARTS[stage]:
            assert any(oa <= a and b <= ob for oa, ob in outer), name
    assert all(stages.row(p)["ranges"] >= 1 for p in PARTS[stage])


def test_counters_hold_every_cut_capacity(traced):
    out = traced[0]
    names = set(out["counters"])
    assert {"raster.bins", "shadows.spot.0", "translucent.wboit.0",
            "translucent.particles.0"} <= names
    assert any(n.startswith("shadows.sun.") for n in names)
    assert all(v.shape == () and v.dtype == torch.int32 for v in out["counters"].values())


def _without_spans(module):
    """The plain copy of the port's `module` (benchmark/plainframe, the
    same path), loaded as a module of the port's package: its relative
    imports reach the port's modules."""
    package, name = module.__name__.rsplit(".", 1)
    path = BENCH.joinpath("plainframe", *package.split(".")[1:], name + ".py")
    spec = importlib.util.spec_from_file_location(f"{package}._{name}_without_spans", path)
    copy = importlib.util.module_from_spec(spec)
    copy.__package__ = package
    spec.loader.exec_module(copy)
    return copy


def _ops(fn):
    """(the aten operations fn() runs, in order, its result)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    return [e.name for e in st.profile_events(prof) if e.name.startswith("aten::")], res


def _flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _flat(item)]
    return [x]


@pytest.mark.parametrize("part", ["_deferred_raster", "shade_deferred"])
def test_tracing_off_runs_what_the_plain_copy_runs(scene, monkeypatch, part):
    module = F if part == "_deferred_raster" else lighting_pass
    plain = _without_spans(module)
    assert "span(" not in Path(plain.__file__).read_text().split(f"def {part}(")[1] \
        .split("\ndef ")[0]
    args = []
    orig = getattr(module, part)

    def keep(*a, **k):
        args.append((a, k))
        return orig(*a, **k)

    monkeypatch.setattr(module, part, keep)
    _render(scene)
    monkeypatch.setattr(module, part, orig)
    assert len(args) == 1 and not debug.tracing()
    a, k = args[0]
    ops_program, res_program = _ops(lambda: orig(*a, **k))
    # the plain copy reads the light counts back from the sceneset's
    # tensors, which the frame now gives shade_deferred as host ints
    readback = ("aten::item", "aten::_local_scalar_dense")
    plain_k = {n: v for n, v in k.items() if n != "light_counts"}
    ops_plain, res_plain = _ops(lambda: getattr(plain, part)(*a, **plain_k))
    if part == "shade_deferred":
        assert k["light_counts"] == F.host_light_counts(scene[3])
        assert [o for o in ops_plain if o in readback] == list(readback) * 2
        ops_plain = [o for o in ops_plain if o not in readback]
    assert len(ops_program) > 50
    assert ops_program == ops_plain
    flat_p, flat_r = _flat(res_program), _flat(res_plain)
    assert len(flat_p) == len(flat_r)
    for p, r in zip(flat_p, flat_r):
        assert torch.equal(p, r) if isinstance(p, torch.Tensor) else p == r
