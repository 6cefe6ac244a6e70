"""The program's tracing (debug.set_tracing) on the CPU, on a small
datumtest frame (128x64, one sun stack, one spot map, the lit layer, the
WBOIT stream, SSAO, fog, SSR), in the megakernel branch and in the
deferred branch:

- off (the default): the debug ring gains no entry, a profiler window
  holds no program range (megakernel branch), the frame has no counters;
- on: the frame's stages open once each, in the branch's order, inside
  the frame's range, each part inside its stage; the host build's spans
  open too; the ring's block_times holds the stages' names;
- the image, depth, vis and ao_prev are bit-equal on and off;
- the counters equal the entries the bins drop, counted again here
  from each pass's triangle setup, and read 0 where nothing drops;
- debug/stages.py puts device operations, launches and syncs down to
  the spans open when their runtime call ran (synthetic events: the CPU
  has no device activity).
"""

import numpy as np
import pytest
import torch

from datum_tpu_torch.debug import debug
from datum_tpu_torch.debug import stages as st
from datum_tpu_torch.ops import raster as raster_ops
from datum_tpu_torch.ops import shadow as shadow_ops
from datum_tpu_torch.render import frame as F
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import datumtest_scene

SMALL = dict(width=128, height=64, grid=(2, 2), sphere_detail=6, n_point_lights=2,
             skybox=True, skybox_size=8, max_vertices=2048, max_triangles=2048,
             bin_capacity=64, big_capacity=16, bin_max_span=8, use_pallas=True,
             enable_material_maps=True, texture_filter="mip_half",
             enable_shadows=True, shadow_mode="esm", shadow_res=128,
             shadow_bin_capacity=64, max_spot_shadows=1, spot_shadow_mode="parabolic",
             spot_shadow_res=128, max_translucent_draws=2, max_translucent_tris=512,
             translucent_lit=True, translucent_lit_layers=1, translucent_lit_scale=2,
             max_particle_quads=64, max_decals_active=2, decal_textures=False,
             shadow_factor_scale=4, enable_ssao=True, enable_fog=True, enable_ssr=True,
             fog_sample_scale=8, forward_bin_capacity=64)
BRANCHES = dict(megakernel=SMALL, deferred=dict(SMALL, use_shade_kernel=False))
STAGES = dict(
    megakernel=["input", "shadows", "raster", "planes", "translucent", "shade", "post"],
    deferred=["input", "shadows", "raster", "planes", "shade", "translucent", "post"])
BUILD = ["build.renderlist", "build.draws", "build.expand", "build.sceneset"]
T = 0.3


@pytest.fixture(autouse=True)
def _tracing_off_after():
    yield
    debug.set_tracing(False)


def _scene(kw):
    ctx, camera, params, make_rl = datumtest_scene(device="cpu", **kw)
    return ctx, camera, params, make_rl, ctx.device_state("cpu")


def _frame(scene, prev=None):
    ctx, camera, params, make_rl, state = scene
    rl = make_rl(T)
    draws = ctx.frame_draws(rl, camera)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights, probes=rl.probes)
    return F.render_frame(ctx.config, state, draws, ss, device="cpu", prev=prev)


def _profiled(scene, on):
    """(the frame's outputs, the window's Events, the ring's new entries)
    of one frame (build included) under the CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    debug.set_tracing(on)
    tail = debug.g_debuglog.tail
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _frame(scene)
    debug.set_tracing(False)
    log = debug.g_debuglog
    return out, st.profile_events(prof), [log.entries[i % log.size]
                                          for i in range(tail, log.tail)]


@pytest.fixture(scope="module", params=sorted(BRANCHES))
def traced(request):
    """Per branch: the frame with tracing off, then one profiled window
    each with it off and on."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    scene = _scene(BRANCHES[request.param])
    tail = debug.g_debuglog.tail
    plain = _frame(scene)
    # a profiled window with tracing off in one branch (the profiler
    # slows the CPU frame ~10x)
    off = _profiled(scene, False) if request.param == "megakernel" else None
    yield dict(branch=request.param, scene=scene, plain=plain, off=off,
               ring_off=debug.g_debuglog.tail - tail, on=_profiled(scene, True))
    torch.set_num_threads(threads)


def _program_ranges(events):
    return sorted((e.start, e.end, e.name[len(debug.PREFIX):]) for e in events
                  if not e.on_device and e.name.startswith(debug.PREFIX))


def test_tracing_off_leaves_no_trace(traced):
    assert not debug.tracing()
    assert traced["ring_off"] == 0 and "counters" not in traced["plain"]
    if traced["off"] is not None:
        out, events, ring = traced["off"]
        assert ring == [] and "counters" not in out
        assert not any(e.name.startswith(debug.PREFIX) for e in events)
        assert len(events) > 100              # the window did record the frame


def test_stages_in_order_and_nested(traced):
    _, events, _ = traced["on"]
    spans = _program_ranges(events)
    frames = [s for s in spans if s[2] == "frame"]
    assert len(frames) == 1
    f0, f1, _ = frames[0]
    inside = [s for s in spans if s[2].startswith("frame.")]
    assert all(f0 <= a and b <= f1 for a, b, _ in inside)
    top = [s for s in inside if s[2].count(".") == 1]
    assert [n.split(".")[1] for _, _, n in top] == STAGES[traced["branch"]]
    # the stages follow each other and fill most of the frame
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    assert sum(b - a for a, b, _ in top) >= 0.95 * (f1 - f0)
    # each part opens inside its own stage's range
    parts = [s for s in inside if s[2].count(".") >= 2]
    assert len(parts) >= 12
    for a, b, name in parts:
        parent = name.rsplit(".", 1)[0]
        assert any(pa <= a and b <= pb for pa, pb, pn in spans if pn == parent), name
    # the host build, before the frame
    build = [n for _, _, n in spans if n.startswith("build.")]
    assert sorted(set(build)) == sorted(BUILD)
    assert all(b <= f0 for _, b, n in spans if n.startswith("build."))
    if traced["branch"] == "megakernel":
        names = {n for _, _, n in spans}
        assert {"frame.shadows.sun", "frame.shadows.spot", "frame.raster.k1",
                "frame.planes.ssao", "frame.translucent.lit", "frame.translucent.wboit",
                "frame.shade.k2", "frame.post.ssr"} <= names


def test_ring_holds_the_stage_names(traced):
    _, _, ring = traced["on"]
    begins = [e[1] for e in ring if e[0] == debug.ENTRY_BEGIN]
    ends = [e[1] for e in ring if e[0] == debug.ENTRY_END]
    assert sorted(begins) == sorted(ends)
    names = {"frame"} | {f"frame.{s}" for s in STAGES[traced["branch"]]} | set(BUILD)
    assert names <= set(begins)
    log = debug.DebugLog()
    for e in ring:
        log.push(e[0], e[1], timestamp=e[2])
    assert names <= set(log.block_times(1))


@pytest.mark.parametrize("key", ["image", "depth", "vis", "ao_prev", "luminance",
                                 "bin_overflow"])
def test_outputs_bit_equal_on_and_off(traced, key):
    a, b = traced["plain"][key], traced["on"][0][key]
    if key == "ao_prev":
        assert torch.equal(a["ao"], b["ao"]) and torch.equal(a["view"], b["view"])
    else:
        assert torch.equal(a, b)


def _dropped(setup, tiles_x, tiles_y, cap, big_cap, tri_block=None):
    """The entries a bin pass drops, counted from the setup's tile
    boxes: every binned triangle takes a place in each tile of its box
    (a stacked atlas's triangle only in its own block's rows), each tile
    keeps `cap`, the big list `big_cap`."""
    tx0, ty0, tx1, ty1 = (t.numpy().astype(np.int64) for t in setup["bbox_soa"])
    n_tri = tx0.shape[0]
    if tri_block is not None:
        n_blocks, per_block = tri_block
        rows = per_block // tiles_x
        lo = np.arange(n_tri) // (n_tri // n_blocks) * rows
        ty0, ty1 = np.clip(ty0, lo, lo + rows - 1), np.clip(ty1, lo, lo + rows - 1)
    n = np.zeros((tiles_y, tiles_x), np.int64)
    for t in np.nonzero(setup["valid"].numpy())[0]:
        n[ty0[t]:ty1[t] + 1, tx0[t]:tx1[t] + 1] += 1
    return int(np.maximum(n - cap, 0).sum()
               + max(int(setup["big"].numpy().sum()) - big_cap, 0))


def _recount(branch, scene):
    """{counter: dropped entries} of the frame, from each pass's setup."""
    ctx, camera, params, make_rl, state = scene
    cfg = ctx.config
    rl = make_rl(T)
    d = ctx.frame_draws(rl, camera)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights, probes=rl.probes)
    from datum_tpu_torch.convert import to_torch

    d, ss = to_torch(d, "cpu"), to_torch(ss, "cpu")
    ex, _, clip, _, _, wp = F._vertex_stage(cfg, state, d, ss)
    tx, ty = cfg.tiles_x, cfg.tiles_y
    setup = raster_ops.triangle_setup(clip, ex["tris"], cfg.padded_width,
                                      cfg.padded_height, tx, ty,
                                      cull=-1 if cfg.backface_cull else 0,
                                      max_span=cfg.bin_max_span)
    out = {"raster.bins": _dropped(setup, tx, ty, cfg.bin_capacity, cfg.big_capacity)}
    sl = ss["spotlights"]
    stacks = dict(sun=shadow_ops.cascade_stacks(wp, ex["tris"],
                                                ss["mainlight"]["shadowview"],
                                                res=cfg.shadow_res))
    if branch == "megakernel":
        stacks["spot"] = [shadow_ops.spot_stack_parabolic(
            wp, ex["tris"], sl["view"], sl["attenuation"][:, 3], 1,
            res=cfg.spot_shadow_res)]
    else:
        stacks["spot"] = shadow_ops.cascade_stacks(wp, ex["tris"], sl["shadowview"][:1],
                                                   res=cfg.spot_shadow_res)
    for kind, group in stacks.items():
        for i, s in enumerate(group):
            out[f"shadows.{kind}.{i}"] = _dropped(
                s["setup"], s["tiles_x"], s["tiles_y"], cfg.shadow_bin_capacity,
                cfg.big_capacity, s["tri_block"])
    ts = F.translucent_stream(state, d, ss)
    fcap, fbig = cfg.forward_bin_capacity, cfg.forward_big_capacity
    if branch == "megakernel":
        lsetup, ltx, lty, _, _ = F.lit_setup(cfg, ts)
        out["translucent.lit.0"] = _dropped(lsetup, ltx, lty, fcap, fbig)
        oit = F.oit_stream(cfg, state, d, ss, ts, None)
        k = oit["nstreams"]
        out["translucent.wboit.0"] = _dropped(oit["setup"], tx, ty, fcap * k, fbig * k)
    else:
        tsetup = raster_ops.triangle_setup(ts["clip"], ts["d"]["tris"], cfg.padded_width,
                                           cfg.padded_height, tx, ty,
                                           tri_valid=ts["d"]["t_valid"])
        out["translucent.wboit.0"] = _dropped(tsetup, tx, ty, fcap, fbig)
        fwd = d["forward"]
        vp = ss["proj"] @ ss["view"]
        fclip = fwd["positions"] @ vp[:, :3].T + vp[:, 3]
        ftris = torch.from_numpy(F.RenderList.quad_triangles(cfg.max_particle_quads))
        valid = torch.arange(ftris.shape[0]) < fwd["quad_count"] * 2
        psetup = raster_ops.triangle_setup(fclip, ftris, cfg.padded_width,
                                           cfg.padded_height, tx, ty, tri_valid=valid)
        out["translucent.particles.0"] = _dropped(psetup, tx, ty, fcap, fbig)
    return out


def test_counters_equal_the_dropped_entries(traced):
    counters = traced["on"][0]["counters"]
    assert all(v.shape == () and v.dtype == torch.int32 for v in counters.values())
    got = {k: int(v) for k, v in counters.items()}
    assert got == _recount(traced["branch"], traced["scene"])
    # at these capacities some passes drop entries and some drop none
    assert any(v > 0 for v in got.values()) and any(v == 0 for v in got.values())
    assert got["raster.bins"] == int(traced["on"][0]["bin_overflow"])


# ------------------------------------------------ stages.py, synthetic


def _ev(name, start, end, corr=0, on_device=False):
    return st.Event(name, on_device, start, end, corr)


def test_stages_put_device_work_down_to_the_open_spans():
    """Two frames: the launch in `frame.raster` runs its kernel after the
    range closed (device time goes with the call, not the clock); a copy
    issued inside `frame.post`, a sync inside it; a kernel whose call is
    not in the window goes to no span; a range's device mirror is no
    operation."""
    p = debug.PREFIX
    events = []
    for f in range(2):
        o = f * 1000
        events += [
            _ev(p + "frame", o + 0, o + 100), _ev(p + "frame.raster", o + 10, o + 40),
            _ev(p + "frame.raster.k1", o + 20, o + 30), _ev(p + "frame.post", o + 50, o + 90),
            _ev("cudaLaunchKernel", o + 22, o + 24, corr=o + 7),
            _ev("k1_kernel", o + 300, o + 310, corr=o + 7, on_device=True),
            _ev("aten::copy_", o + 52, o + 60, corr=o + 99),
            _ev("cudaMemcpyAsync", o + 53, o + 55, corr=o + 2),
            _ev("Memcpy HtoD", o + 400, o + 404, corr=o + 2, on_device=True),
            _ev("early_kernel", o + 420, o + 430, corr=o + 99, on_device=True),
            _ev("cudaStreamSynchronize", o + 70, o + 85),
            _ev(p + "frame", o + 0, o + 500, on_device=True),
        ]
    s = st.Stages(events, 2)
    assert s.linked == 4 and len(s.device_ops) == 6
    assert s.row("frame.raster.k1") == dict(host_ms=10e-6, device_ms=10e-6, launches=1.0,
                                            syncs=0.0, sync_ms=0.0, ranges=1.0)
    assert s.row("frame.raster")["device_ms"] == pytest.approx(10e-6)
    assert s.row("frame.post") == dict(host_ms=40e-6, device_ms=4e-6, launches=0.0,
                                       syncs=1.0, sync_ms=15e-6, ranges=1.0)
    assert s.row("frame") == dict(host_ms=100e-6, device_ms=14e-6, launches=1.0,
                                  syncs=1.0, sync_ms=15e-6, ranges=1.0)
    assert [n for n, _ in s.table()] == ["frame", "frame.raster", "frame.raster.k1",
                                         "frame.post"]
    assert s.innermost(25) == "frame.raster.k1" and s.innermost(45) == "frame"
    assert s.innermost(200) is None
    gaps = s.idle_gaps(window=(0, 1100), top=3)
    assert gaps[0] == ("other", 670e-6)       # 430 .. 1100: after the first frame
    assert "frame.raster" in s.format()
