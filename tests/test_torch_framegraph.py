"""The frame graph (render/framegraph.py) on the CPU: the key that decides
when a frame is captured, the recorder's cut of a frame into graphs and
the K1/K2 calls between them (with a stand-in for torch.cuda.CUDAGraph,
which needs a card), the eager path's tally, and the device constants
that replace the tensors the frame used to build from Python lists and
numpy every frame (each equal to the tensor it replaces).  The capture
and replay themselves run on the card: tests/test_torch_cuda.py."""

import collections
import dataclasses
import functools
import types
import warnings

import numpy as np
import pytest
import torch

from datum_tpu_torch import debug
from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops import _kernels, bloom, common, geometry, ibl, shade_cuda, ssr2
from datum_tpu_torch.ops.common import FrameConfig, constant
from datum_tpu_torch.render import frame as frame_mod
from datum_tpu_torch.render import framegraph
from datum_tpu_torch.render.renderlist import RenderList


def _trees(seed=0, n=8):
    """A small state (tensors), draws and sceneset (numpy), as the frame
    takes them."""
    rng = np.random.RandomState(seed)
    state = dict(geometry=dict(attr12=torch.zeros((n, 12))),
                 ibl=dict(mips=[torch.zeros((6, 4, 4, 3))],
                          flatp=(torch.zeros((n, 24)), torch.zeros(2, dtype=torch.int32))))
    draws = dict(world=rng.rand(n, 3, 4).astype(np.float32), count=np.int32(n - 1),
                 translucent=dict(tris=rng.randint(0, n, (4, 3)).astype(np.int32)))
    sceneset = dict(view=rng.rand(4, 4).astype(np.float32),
                    camera=dict(exposure=np.float32(rng.rand())))
    return state, draws, sceneset


def _key(cfg=None, state=None, draws=None, ss=None, prev=None):
    s, d, c = _trees()
    return framegraph.frame_key(cfg or FrameConfig(), state or s, draws or d, ss or c,
                                prev, "cpu")


def test_key_is_equal_for_new_values_in_the_same_structure():
    s, d, c = _trees(0)
    _, d2, c2 = _trees(1)
    prev = dict(ao=torch.rand((4, 8, 2)), view=torch.rand((4, 4)))
    prev2 = {k: torch.rand_like(v) for k, v in prev.items()}
    k1 = framegraph.frame_key(FrameConfig(), s, d, c, prev, "cpu")
    k2 = framegraph.frame_key(FrameConfig(), s, d2, c2, prev2, "cpu")
    assert k1 is not None and k1 == k2 and hash(k1) == hash(k2)


def _changed(what):
    s, d, c = _trees()
    if what == "cfg":
        return _key(cfg=dataclasses.replace(FrameConfig(), enable_ssao=True))
    if what == "shape":
        return _key(draws=dict(d, world=np.zeros((9, 3, 4), np.float32)))
    if what == "dtype":
        return _key(draws=dict(d, count=np.int64(3)))
    if what == "prev":
        return _key(prev=dict(ao=torch.zeros((4, 8, 2)), view=torch.zeros((4, 4))))
    if what == "moved-state-tensor":
        geom = dict(attr12=s["geometry"]["attr12"].clone())
        return _key(state=dict(s, geometry=geom))
    if what == "number":
        return _key(ss=dict(c, scale=0.5))
    if what == "tree":
        return _key(ss=dict(c, extra=np.zeros(2, np.float32)))
    debug.set_tracing(True)
    key = _key()
    debug.set_tracing(False)
    return key


@pytest.mark.parametrize("what", ["cfg", "shape", "dtype", "prev", "moved-state-tensor",
                                  "number", "tree", "tracing"])
def test_key_differs(what):
    """A changed FrameConfig, array shape or dtype, prev given against
    None, a state tensor at another address, a Python number, the tree's
    keys, or the program's tracing: another key."""
    assert _changed(what) != _key()


def test_key_refuses_what_cannot_key():
    s, d, c = _trees()
    assert _key(draws=dict(d, obj=object())) is None
    assert _key(ss=dict(c, v=[1.0, {"a": object()}])) is None


def test_state_off_the_device_is_not_graphed():
    s, _, _ = _trees()
    assert framegraph._on_device(s, torch.device("cpu"))
    assert not framegraph._on_device(dict(s, extra=np.zeros(2)), torch.device("cpu"))


def test_render_frame_on_the_cpu_tallies_eager(monkeypatch):
    """On CPU tensors render_frame takes the eager path (no graph code)
    and tallies frame.graph.eager once a call; its outputs are the eager
    path's."""
    monkeypatch.setattr(framegraph, "render",
                        lambda *a, **k: pytest.fail("the frame graph ran on the CPU"))
    from datum_tpu_torch.scenes import datumtest_scene
    from datum_tpu_torch.render.types import make_sceneset

    torch.set_num_threads(1)
    ctx, camera, params, make_rl = datumtest_scene(
        width=128, height=64, sphere_detail=6, grid=(2, 2), n_point_lights=2, skybox=False,
        max_vertices=1024, max_triangles=1024, bin_capacity=64, big_capacity=16,
        use_pallas=True, texture_filter="mip_half", enable_shadows=False)
    rl = make_rl(0.3)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights)
    draws = ctx.frame_draws(rl, camera)
    state = ctx.device_state("cpu")
    assert frame_mod.use_shade_kernel(ctx.config, state)
    before = debug.g_debuglog.statistics.get("frame.graph.eager", 0)
    a = frame_mod.render_frame(ctx.config, state, draws, ss, device="cpu")
    b = frame_mod.render_frame(ctx.config, state, draws, ss, device="cpu")
    assert debug.g_debuglog.statistics["frame.graph.eager"] == before + 2
    e = frame_mod._eager_frame(ctx.config, state, draws, ss, None, torch.device("cpu"))
    for k in ("image", "depth", "vis", "luminance", "bin_overflow"):
        assert torch.equal(a[k], e[k]) and torch.equal(b[k], e[k]), k
    assert a["image"].float().mean() > 10


class _FakeGraph:
    """torch.cuda.CUDAGraph's capture interface on the CPU: a capture
    with no work warns as the real one does."""

    work = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        self.mark = len(_FakeGraph.work)

    def capture_end(self):
        self.ops = _FakeGraph.work[self.mark:]
        if not self.ops:
            warnings.warn("The CUDA Graph is empty. This usually means that the graph was "
                          "attempted to be captured on wrong device or stream.")

    def replay(self):
        _FakeGraph.work.extend(self.ops)


def _kernel_module():
    mod = types.SimpleNamespace()

    def k1(x, out):
        _FakeGraph.work.append("k1")
        out.fill_(x)
        return out
    k1.launches = 0
    mod.k1 = k1
    return mod


def test_recorder_cuts_at_stages_and_calls_k1_between_graphs(monkeypatch):
    """Each stage's span starts a graph; a launch_eager call ends the
    stage's graph, is noted with the spans it ran in and starts the
    stage's next graph; an empty graph is dropped; the cached constants
    handed out while capturing are kept; the wrappers' launch counts are
    put back, and each graph's are added again on replay."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    _FakeGraph.work = []
    mod = _kernel_module()
    rec = framegraph._Recorder(pool=None, device=torch.device("cpu"))
    k3 = shade_cuda.shade_epilogue_cuda.launches
    cached = constant((0.25, 0.5), torch.float32, torch.device("cpu"))
    with framegraph._Recording(rec):
        with framegraph.span("frame.input"):
            _FakeGraph.work.append("vertex")
            constant((0.25, 0.5), torch.float32, torch.device("cpu"))
        with framegraph.span("frame.raster"):
            _FakeGraph.work.append("bins")
            with framegraph.span("frame.raster.k1"):
                out = _kernels.launch_eager(mod, "k1", x=3.0, out=torch.zeros(2))
            assert torch.equal(out, torch.zeros(2))        # filled on replay
        with framegraph.span("frame.shade"):
            _FakeGraph.work.append("epilogue")
            shade_cuda.shade_epilogue_cuda.launches += 1
        rec.close()
    assert _kernels.recorder is None
    assert shade_cuda.shade_epilogue_cuda.launches == k3
    assert [(type(s).__name__, s.stage) for s in rec.steps] == [
        ("_Replay", "frame.input"), ("_Replay", "frame.raster"),
        ("_Launch", "frame.raster"), ("_Replay", "frame.shade")]
    assert rec.steps[2].parts == ("frame.raster.k1",)
    assert any(t is cached for t in rec.keep)
    cap = framegraph._Capture(None, rec.steps, dict(out=out), rec.keep)
    assert [s for s, _ in cap.stages] == ["frame.input", "frame.raster", "frame.shade"]
    _FakeGraph.work = []
    for _, steps in cap.stages:
        for step in steps:
            step.run()
    assert _FakeGraph.work == ["vertex", "bins", "k1", "epilogue"]
    assert torch.equal(out, torch.full((2,), 3.0))
    assert shade_cuda.shade_epilogue_cuda.launches == k3 + 1
    fresh = framegraph._fresh(dict(a=dict(b=out), n=None))
    assert torch.equal(fresh["a"]["b"], out) and fresh["a"]["b"] is not out


def _enrolled(name):
    """A kernel launcher enrolled here, unknown to render/framegraph.py:
    its launch is the stand-in graph's work `name`."""
    def launch(x, out=None):
        _FakeGraph.work.append(name)
        return x if out is None else out.fill_(x)
    return _kernels.enroll(launch)


def test_a_kernel_enrolled_outside_ops_is_counted_by_capture_and_replay(monkeypatch):
    """A launcher enrolled outside the package, launched inside a stage's
    graph while it is captured: the capture leaves its count as it was,
    its graph records the launches, and each replay adds them."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    _FakeGraph.work = []
    k = _enrolled("k")
    rec = framegraph._Recorder(pool=None, device=torch.device("cpu"))
    with framegraph._Recording(rec):
        with framegraph.span("frame.raster"):
            k(1.0)
            k(2.0)
        rec.close()
    assert k.launches == 0
    (step,) = rec.steps
    assert step.launches[_kernels.ENROLLED.index(k)] == 2
    for _ in range(3):
        step.run()
    assert k.launches == 6 and _FakeGraph.work == ["k"] * 8


def test_launch_counts_hold_under_a_wrapper_over_the_module_attribute(monkeypatch):
    """With a functools.wraps wrapper over each launcher's module
    attribute, as the benchmark's roofline readers install theirs (which
    copies `launches` into the wrapper), the enrolled launchers count
    every launch of the replays: K1's, called between the graphs, and
    K3's, recorded inside them."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    _FakeGraph.work = []
    mod = types.SimpleNamespace(k1=_enrolled("k1"), k3=_enrolled("k3"))
    k1, k3 = mod.k1, mod.k3
    for name, orig in (("k1", k1), ("k3", k3)):
        @functools.wraps(orig)
        def wrapped(*a, _orig=orig, **k):
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    rec = framegraph._Recorder(pool=None, device=torch.device("cpu"))
    with framegraph._Recording(rec):
        with framegraph.span("frame.shadows"):
            mod.k3(0.0)
        with framegraph.span("frame.raster"):
            out = _kernels.launch_eager(mod, "k1", x=3.0, out=torch.zeros(2))
            mod.k3(1.0)
        rec.close()
    assert (k1.launches, k3.launches) == (0, 0)
    cap = framegraph._Capture(None, rec.steps, dict(out=out), rec.keep)
    for _ in range(2):
        for _, steps in cap.stages:
            for step in steps:
                step.run()
    assert _FakeGraph.work == ["k3", "k3"] + ["k3", "k1", "k3"] * 2
    assert (k1.launches, k3.launches) == (2, 4)


def test_recorder_sees_the_seven_stages_of_the_megakernel_frame(monkeypatch):
    """The frame's own body under the recorder (plain kernels on the CPU,
    graphs stood in for): one graph a stage, in frame order."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    _FakeGraph.work = ["x"]          # every stand-in graph counts as work
    monkeypatch.setattr(_FakeGraph, "capture_end", lambda self: setattr(self, "ops", []))
    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.render.types import make_sceneset
    from datum_tpu_torch.scenes import datumtest_scene

    torch.set_num_threads(1)
    ctx, camera, params, make_rl = datumtest_scene(
        width=128, height=64, sphere_detail=6, grid=(2, 2), n_point_lights=2,
        skybox=True, skybox_size=16, device="cpu", max_vertices=1024, max_triangles=1024,
        bin_capacity=64, big_capacity=16, use_pallas=True, texture_filter="mip_half",
        enable_shadows=True, shadow_res=256, shadow_far_res=128, max_spot_shadows=1,
        spot_shadow_res=128, max_translucent_draws=2, max_translucent_tris=256,
        translucent_lit=True, max_particle_quads=16, enable_ssao=True, enable_fog=True,
        enable_ssr=True, fog_sample_scale=8)
    rl = make_rl(0.3)
    ss = to_torch(make_sceneset(camera, params, point_lights=rl.point_lights,
                                spot_lights=rl.spot_lights), "cpu")
    draws = to_torch(ctx.frame_draws(rl, camera), "cpu")
    state = ctx.device_state("cpu")
    # the eager frame first: it builds the cached constants the capture reads
    e = frame_mod._eager_frame(ctx.config, state, draws, ss, None, torch.device("cpu"))
    rec = framegraph._Recorder(pool=None, device=torch.device("cpu"))
    with framegraph._Recording(rec):
        out = frame_mod._uploaded_frame(ctx.config, state, draws, ss, None)
        rec.close()
    assert [s.stage for s in rec.steps] == list(framegraph.STAGES)
    assert torch.equal(out["image"], e["image"])


def test_launch_eager_looks_the_function_up_at_each_call(monkeypatch):
    mod = types.SimpleNamespace(f=lambda out, x: out.fill_(x))
    out = torch.zeros(3)
    _kernels.launch_eager(mod, "f", out=out, x=1.0)
    mod.f = lambda out, x: out.fill_(2 * x)
    _kernels.launch_eager(mod, "f", out=out, x=1.0)
    assert torch.equal(out, torch.full((3,), 2.0))


def test_device_cached_is_a_bounded_lru_that_builds_once():
    built = []

    @common.device_cached(maxsize=2)
    def table(n):
        built.append(n)
        return torch.arange(n)

    a = table(1)
    table(2)
    assert table(1) is a                   # a hit, and now the most recent
    table(3)                               # evicts 2, the least recently used
    assert table(1) is a and built == [1, 2, 3]
    table(2)
    assert built == [1, 2, 3, 2]


def test_device_cached_while_capturing_keeps_and_builds_outside_the_graphs():
    """While a capture runs, every tensor handed out is kept by it, and a
    miss is built by the recorder's outside() (between two graphs)."""
    rec = types.SimpleNamespace(keep=[], outside=lambda build, args: ("outside",
                                                                      build(*args)))
    cpu = torch.device("cpu")
    hit = constant((1.0, 2.0), torch.float32, cpu)
    _kernels.recorder = rec
    try:
        a = constant((1.0, 2.0), torch.float32, cpu)
        b = constant((7.0, 8.0, 9.0), torch.float32, cpu)
    finally:
        _kernels.recorder = None
    assert a is hit and b[0] == "outside" and torch.equal(b[1], torch.tensor([7.0, 8.0, 9.0]))
    assert rec.keep == [a, b]
    constant.cache_clear()


_F32 = dict(dtype=torch.float32, device="cpu")


def _hoisted():
    """(name, the device constant, the tensor it replaces, built inline
    as before)."""
    cpu = torch.device("cpu")
    return [
        ("luminance weights", constant(frame_mod.LUMA_REC709, torch.float32, cpu),
         torch.tensor([0.2126, 0.7152, 0.0722], **_F32)),
        ("matmap planes", constant(frame_mod.MATMAP_PLANES, torch.int64, cpu),
         torch.tensor([0, 1, 2, 4, 5, 7, 8, 9, 10])),
        ("env-BRDF without an environment", constant((0.0, 0.0, 1.0), torch.float32, cpu),
         torch.tensor([0.0, 0.0, 1.0], **_F32)),
        ("bloom luma", constant((0.299, 0.587, 0.114), torch.float32, cpu),
         torch.tensor([0.299, 0.587, 0.114], **_F32)),
        ("SSR steps", constant(ssr2.STEPS, torch.float32, cpu),
         torch.tensor(ssr2.STEPS, **_F32)),
        ("SSR eye offset", constant((0.0, 0.5, 0.0), torch.float32, cpu),
         torch.tensor([0.0, 0.5, 0.0])),
        ("GGX tangent up", constant((1.0, 0.0, 0.0), torch.float32, cpu),
         torch.tensor([1.0, 0.0, 0.0], **_F32)),
        ("SH band-2 directions", constant(ibl.SH2_DIRS, torch.float32, cpu),
         torch.as_tensor(ibl._SH2_DIRS, **_F32)),
        ("SH band-2 inverse", constant(ibl.SH2_INV, torch.float32, cpu),
         torch.as_tensor(ibl._SH2_INV, **_F32)),
        ("K2's zero count", constant(0, torch.int32, cpu),
         torch.as_tensor(0, dtype=torch.int32).reshape(())),
        ("quaternion conjugate", constant((1.0, -1.0, -1.0, -1.0), torch.float32, cpu),
         torch.tensor([1.0, -1.0, -1.0, -1.0], **_F32)),
        ("particle quads", frame_mod.quad_triangles(5, cpu),
         torch.from_numpy(RenderList.quad_triangles(5))),
    ]


@pytest.mark.parametrize("case", range(12), ids=[h[0] for h in _hoisted()])
def test_hoisted_constant_equals_the_inline_tensor(case):
    _, got, want = _hoisted()[case]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_k2_params_equal_their_element_by_element_build():
    """shade_inputs' params, one concatenation of device values, equal
    the 64 floats set element by element as before."""
    from datum_tpu_torch.convert import to_torch
    from datum_tpu_torch.render.types import make_sceneset
    from datum_tpu_torch.scenes import datumtest_scene

    ctx, camera, params, make_rl = datumtest_scene(
        width=128, height=64, sphere_detail=4, grid=(2, 2), n_point_lights=2,
        skybox=False, enable_shadows=False)
    rl = make_rl(0.3)
    ss = to_torch(make_sceneset(camera, params, point_lights=rl.point_lights,
                                spot_lights=rl.spot_lights), "cpu")
    ss["_sh"] = torch.randn((9, 3), generator=torch.Generator().manual_seed(0))
    g = {k: torch.rand(32, 128) for k in shade_cuda.PLANE_NAMES}
    inp = shade_cuda.shade_inputs(g, ss, proj=ss["proj"], invview=ss["invview"], y0=64,
                                  full_height=256)
    proj, iv, ml, cam = ss["proj"], ss["invview"], ss["mainlight"], ss["camera"]
    p = torch.zeros(64)
    p[0], p[1], p[2], p[3] = 1.0 / proj[0, 0], 1.0 / proj[1, 1], proj[2, 2], proj[2, 3]
    p[4:16] = iv[:3, :4].reshape(-1)
    p[16:19], p[19:22] = -ml["direction"], ml["intensity"]
    p[22], p[23] = ml["cutoff"], cam["ambientintensity"]
    p[24], p[25] = cam["exposure"], cam["specularintensity"]
    p[26] = 64.0
    p[27:54] = ss["_sh"].reshape(-1)
    assert torch.equal(inp["params"], p)


def test_quat_conj_and_bloom_seed_read_their_constants():
    q = torch.randn((5, 4))
    assert torch.equal(geometry.quat_conj(q), q * torch.tensor([1.0, -1.0, -1.0, -1.0]))
    x = torch.rand((4, 8, 3)) * 40
    w = torch.tensor([0.299, 0.587, 0.114])
    t = torch.clamp(x @ w - bloom.CUTOFF, 0.0, 1.0)
    t = t * t * (3.0 - 2.0 * t)
    assert torch.equal(bloom.bloom_seed(x), bloom.tonemap(x * t[..., None]))


# the deferred branch's K5 route at a small size: bilinear filter, decals,
# SSAO, fog, a spot map, translucents and particles (two K4 passes)
K5_SCENE = dict(width=128, height=64, sphere_detail=6, grid=(2, 2), n_point_lights=4,
                skybox=True, skybox_size=16, device="cpu", max_vertices=1024,
                max_triangles=1024, bin_capacity=64, big_capacity=16, use_pallas=True,
                texture_filter="bilinear", enable_shadows=True, shadow_res=128,
                shadow_bin_capacity=64, max_spot_shadows=1, spot_shadow_res=64,
                max_translucent_draws=2, max_translucent_tris=256, max_particle_quads=16,
                max_decals_active=2, enable_ssao=True, enable_fog=True, enable_ssr=True,
                fog_sample_scale=8, forward_bin_capacity=64, forward_big_capacity=16)


def _deferred_scene(scene=K5_SCENE, t=0.3, n_point=None):
    """(cfg, state, draws, sceneset) of a deferred frame on the CPU, draws
    as tensors, the sceneset as the host builds it (numpy), with the
    first n_point point lights."""
    from datum_tpu_torch.render.types import make_sceneset
    from datum_tpu_torch.scenes import datumtest_scene

    torch.set_num_threads(1)
    ctx, camera, params, make_rl = datumtest_scene(**scene)
    rl = make_rl(t)
    ss = make_sceneset(camera, params, point_lights=rl.point_lights[:n_point],
                       spot_lights=rl.spot_lights)
    state = ctx.device_state("cpu")
    assert not frame_mod.use_shade_kernel(ctx.config, state)
    return ctx.config, state, to_torch(ctx.frame_draws(rl, camera), "cpu"), ss


def _as_card(monkeypatch):
    """The card's dispatch on CPU tensors: every tensor reads as a CUDA
    one, so the wrappers launch their kernels, each replaced by a plain
    version that counts its calls (K5 and K4 write into `out`).  Returns
    the list of calls."""
    from datum_tpu_torch.ops import raster_blend_cuda, raster_depth_cuda, raster_v1_cuda

    calls = []

    def k5(out, split=None, **inp):
        calls.append("k5")
        return out.copy_(raster_v1_cuda.raster_v1_reference(**inp))

    def k4(out, **inp):
        calls.append("k4")
        return out.copy_(raster_blend_cuda.raster_blend_reference(**inp))

    def k3(**inp):
        return raster_depth_cuda.raster_depth_reference(**inp)

    k5.launches = k4.launches = k3.launches = 0
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(raster_v1_cuda, "raster_v1_cuda", k5)
    monkeypatch.setattr(raster_blend_cuda, "raster_blend_cuda", k4)
    monkeypatch.setattr(raster_depth_cuda, "raster_depth_cuda", k3)
    return calls


def test_recorder_cuts_the_deferred_frame_with_k5_and_k4_between_graphs(monkeypatch):
    """The deferred branch's K5 route under the recorder (graphs stood in
    for, the wrappers' kernels by counting plain versions): one or more
    graphs a stage in frame order, K5's call between two graphs of
    frame.raster under frame.raster.k5, and the two K4 calls between
    graphs of frame.translucent under .wboit and .particles.  The capture
    launches nothing; each call, run as a replay runs it, fills its
    preallocated output: K5's depth is the eager frame's."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    _FakeGraph.work = ["x"]          # every stand-in graph counts as work
    monkeypatch.setattr(_FakeGraph, "capture_end", lambda self: setattr(self, "ops", []))
    cfg, state, draws, ss = _deferred_scene()
    lights = frame_mod.host_light_counts(ss)
    ss = to_torch(ss, "cpu")
    # the eager frame first: it builds the cached constants the capture reads
    e = frame_mod._eager_frame(cfg, state, draws, ss, None, torch.device("cpu"), lights)
    calls = _as_card(monkeypatch)
    rec = framegraph._Recorder(pool=None, device=torch.device("cpu"))
    with framegraph._Recording(rec):
        frame_mod._uploaded_frame(cfg, state, draws, ss, None, lights)
        rec.close()
    assert calls == []
    launch = lambda stage, part: ("_Launch", stage, (part,))
    graph = lambda stage: ("_Replay", stage, None)
    assert [(type(s).__name__, s.stage, getattr(s, "parts", None)) for s in rec.steps] == [
        graph("frame.input"), graph("frame.shadows"), graph("frame.raster"),
        launch("frame.raster", "frame.raster.k5"), graph("frame.raster"),
        graph("frame.planes"), graph("frame.shade"), graph("frame.translucent"),
        launch("frame.translucent", "frame.translucent.wboit"), graph("frame.translucent"),
        launch("frame.translucent", "frame.translucent.particles"),
        graph("frame.translucent"), graph("frame.post")]
    k5, wboit, particles = [s for s in rec.steps if isinstance(s, framegraph._Launch)]
    assert (k5.name, wboit.name, particles.name) == ("raster_v1_cuda", "raster_blend_cuda",
                                                     "raster_blend_cuda")
    h, w = cfg.padded_height, cfg.padded_width
    assert k5.kw["out"].shape == (4, h, w) and wboit.kw["out"].shape == (5, h, w)
    for step in (k5, wboit, particles):
        step.run()
    assert calls == ["k5", "k4", "k4"]
    assert torch.equal(k5.kw["out"][0], e["depth"])
    assert wboit.kw["soft"] is False and particles.kw["soft"] is True


def test_raster_v1_and_raster_blend_with_out_equal_their_plain_versions(monkeypatch):
    """raster_v1 and raster_blend on the card's route (launch_eager into
    a preallocated output, kernels by plain versions) give the CPU route's
    planes bit for bit."""
    from datum_tpu_torch.ops import raster as raster_ops
    from datum_tpu_torch.ops.raster_blend_cuda import raster_blend
    from datum_tpu_torch.ops.raster_v1_cuda import raster_v1

    cfg, state, draws, ss = _deferred_scene()
    ss = to_torch(ss, "cpu")
    ex, uv, clip, wn, wt, worldp = frame_mod._vertex_stage(cfg, state, draws, ss)
    setup, bins, counts, big, _ = frame_mod._bin_stage(cfg, ex, clip)
    tx, ty, w, h = cfg.tiles_x, cfg.tiles_y, cfg.padded_width, cfg.padded_height
    plain_v1 = raster_v1(setup, bins, big, counts, tx, ty, w, h)
    depth = plain_v1[0]
    ts = frame_mod.translucent_stream(state, draws, ss)
    d = ts["d"]
    color = state["materials"]["color"][d["material"][d["vtx_draw"].long()].long()]
    tsetup = raster_ops.triangle_setup(ts["clip"], d["tris"], w, h, tx, ty,
                                       tri_valid=d["t_valid"])
    tb, tc, tbig = raster_ops.bin_triangles(tsetup, cfg.max_translucent_tris, tx, ty,
                                            cfg.forward_bin_capacity,
                                            cfg.forward_big_capacity)
    args = (tsetup, tb, tbig, tc, d["tris"], ts["uv"], color, depth, tx, ty, w, h)
    plain_blend = raster_blend(*args, soft=False)
    calls = _as_card(monkeypatch)
    card_v1 = raster_v1(setup, bins, big, counts, tx, ty, w, h)
    card_blend = raster_blend(*args, soft=False)
    assert calls == ["k5", "k4"]
    for a, b in zip(card_v1 + card_blend, plain_v1 + plain_blend):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float(plain_blend[3].sum()) > 0


def test_key_follows_the_light_counts_not_the_lights():
    """A deferred frame's key holds its host light counts: one point or
    spot light fewer is another key, lights moved (another t) are the
    same key; counts on the device give no key."""
    from datum_tpu_torch.render.types import make_sceneset
    from datum_tpu_torch.scenes import datumtest_scene

    ctx, camera, params, make_rl = datumtest_scene(
        width=128, height=64, sphere_detail=4, grid=(2, 2), n_point_lights=4, skybox=False,
        device="cpu", enable_shadows=False)
    state = ctx.device_state("cpu")

    def key(t, n_point=None, n_spot=None):
        rl = make_rl(t)
        ss = make_sceneset(camera, params, point_lights=rl.point_lights[:n_point],
                           spot_lights=rl.spot_lights[:n_spot])
        return framegraph.frame_key(ctx.config, state, {}, ss, None, "cpu",
                                    frame_mod.host_light_counts(ss)), ss

    k, ss = key(0.3)
    assert frame_mod.host_light_counts(ss) == (4, 1)
    assert key(0.9)[0] == k and not np.array_equal(
        key(0.9)[1]["pointlights"]["position"], ss["pointlights"]["position"])
    assert key(0.3, n_point=3)[0] != k and key(0.3, n_spot=0)[0] != k
    dev = dict(ss, pointlights=dict(ss["pointlights"], count=torch.tensor(4)))
    assert frame_mod.host_light_counts(dev) == (4, 1)          # a CPU tensor reads free
    assert framegraph.frame_key(ctx.config, state, {}, ss, None, "cpu", None) is None


@pytest.mark.parametrize("counts", [(0, 0), (3, 1), (8, 1)], ids=["0", "3", "8"])
def test_shade_deferred_with_host_counts_equals_the_readback(counts, monkeypatch):
    """The light counts the deferred frame reads back where they are on
    the device (read_light_counts, with host_light_counts giving None)
    are host_light_counts' ints of the host sceneset; the counts drive
    the lighting pass's dense point and spot loops."""
    from datum_tpu_torch.ops.lighting_pass import shade_deferred
    from datum_tpu_torch.render.types import make_sceneset
    from datum_tpu_torch.scenes import datumtest_scene

    torch.set_num_threads(1)
    ctx, camera, params, make_rl = datumtest_scene(
        width=128, height=64, sphere_detail=4, grid=(2, 2), n_point_lights=8, skybox=False,
        device="cpu", enable_shadows=False)
    rl = make_rl(0.3)
    n_point, n_spot = counts
    ss = make_sceneset(camera, params, point_lights=rl.point_lights[:n_point],
                       spot_lights=rl.spot_lights[:n_spot])
    lights = frame_mod.host_light_counts(ss)
    assert lights == counts
    ss = to_torch(ss, "cpu")
    with monkeypatch.context() as m:
        m.setattr(frame_mod, "host_light_counts", lambda sceneset: None)
        read = frame_mod.read_light_counts(ss)
    assert read == lights and all(type(n) is int for n in read)
    g = torch.Generator().manual_seed(sum(counts))
    h, w = 64, 128
    gbuffer = dict(normal=torch.rand((h, w, 4), generator=g),
                   specular=torch.rand((h, w, 4), generator=g),
                   diffuse=torch.rand((h, w, 4), generator=g),
                   mask=torch.rand((h, w), generator=g) > 0.2)
    depth = torch.rand((h, w), generator=g) * 0.5 + 0.1
    kw = dict(proj=ss["proj"], invview=ss["invview"])
    a = shade_deferred(gbuffer, depth, ss, light_counts=read, **kw)
    dark = shade_deferred(gbuffer, depth, ss, light_counts=(0, 0), **kw)
    assert torch.equal(a, dark) == (counts == (0, 0))


def _host_reads(run):
    """The places where run() reads a tensor value on the host (a
    scalar out of a tensor, a boolean mask's or nonzero's data-dependent
    shape, a tensor built from host data), outside the kernels' plain
    versions, which the card does not run: [(what, file:line)]."""
    import traceback

    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode

    found = []
    reads = {"_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique2",
             "unique_consecutive", "repeat_interleave", "equal", "is_nonzero",
             "lift_fresh"}

    def note(what):
        stack = traceback.extract_stack()
        if not any(f.name.endswith("_reference") for f in stack):
            port = [f for f in stack if "datum_tpu_torch" in f.filename]
            found.append((what, f"{port[-1].filename}:{port[-1].lineno}" if port else "?"))

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name.split("::")[-1]
            if name in reads or (name.startswith("index") and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] if len(args) > 1 and isinstance(args[1], (list, tuple))
                              else ()))):
                note(name)
            return func(*args, **(kwargs or {}))

    class Builds(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("tensor", "as_tensor", "from_numpy") and (
                    not args or not isinstance(args[0], torch.Tensor)):
                note(func.__name__)
            return func(*args, **(kwargs or {}))

    with Builds(), Ops():
        run()
    return found


@pytest.mark.parametrize("route", ["K5", "K1", "K7"])
def test_deferred_frame_reads_no_tensor_on_the_host(route):
    """The body the frame graph captures, on the deferred branch's
    use_pallas routes (K5; K1 with material maps off; K7), with the
    host light counts: no tensor value is read on the host, which a
    capture would refuse; on the K5 route the readback form reads the
    two counts, which the scan finds."""
    scene = dict(K5_SCENE, enable_material_maps=route != "K5",
                 raster_kernel="mxu" if route == "K7" else "v2")
    cfg, state, draws, ss = _deferred_scene(scene)
    lights = frame_mod.host_light_counts(ss)
    ss = to_torch(ss, "cpu")
    prev = frame_mod._eager_frame(cfg, state, draws, ss, None, torch.device("cpu"),
                                  lights)["ao_prev"]
    run = lambda lights: frame_mod._uploaded_frame(cfg, state, draws, ss, prev, lights)
    assert _host_reads(lambda: run(lights)) == []
    if route == "K5":
        assert [w for w, _ in _host_reads(lambda: run(None))] == ["_local_scalar_dense"] * 2


class _Event:
    """torch.cuda.Event's query and synchronize, with the copy's state."""

    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True


def test_inputs_reuse_a_host_buffer_only_once_its_copy_has_run(monkeypatch):
    """The upload's pinned buffers: the oldest is filled again once its
    copy has run (found by a query, no wait); while every buffer is
    still being read a new one is made, up to MAX_HOST_BUFFERS, past
    which the oldest is waited for."""
    made = []
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: made.append(
        pin_memory) or np.zeros(4, np.uint8))
    inp = framegraph._Inputs.__new__(framegraph._Inputs)
    inp.size, inp.host = 4, collections.deque()
    bufs = []
    for _ in range(framegraph.MAX_HOST_BUFFERS):
        bufs.append(inp._free_host())
        inp.host.append((bufs[-1], _Event(False)))
    assert made == [True] * framegraph.MAX_HOST_BUFFERS
    first = inp.host[0][1]
    assert inp._free_host() is bufs[0] and first.waited          # the host ran ahead
    second = inp.host[0][1]
    second.done = True
    assert inp._free_host() is bufs[1] and not second.waited     # its copy ran: no wait
    third = inp.host[0][1]
    assert inp._free_host() is not bufs[2] and not third.waited  # still read: a new one
    assert made == [True] * (framegraph.MAX_HOST_BUFFERS + 1)
