"""The port's platform layer: the cases of tests/test_platform.py on
datum_tpu_torch.platform (fan-out and join on the worker queue, file
handles, the fixed-timestep loop, the triple buffer, the threaded loop),
FrameSink writing PNGs that read back equal, and particle updates fanned
out over Platform.submit_work equal to the same updates in order."""

import threading
import time

import numpy as np
from PIL import Image

from datum_tpu_torch.math import Transform
from datum_tpu_torch.platform import (
    FrameSink, GameInput, Platform, TripleBuffer, WorkQueue, run_game_loop,
    run_threaded_loop,
)
from datum_tpu_torch.render.particlesystem import (
    Distribution, ParticleEmitter, ParticleSystem,
)


def test_workqueue_fanout_join():
    q = WorkQueue(workers=4)
    results = []
    lock = threading.Lock()

    def work(i):
        with lock:
            results.append(i * i)

    for i in range(16):
        q.submit(work, i)
    q.wait(16)
    assert sorted(results) == [i * i for i in range(16)]


def test_file_handles(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(bytes(range(100)))
    plat = Platform()
    h = plat.open_handle(str(p))
    h2 = plat.open_handle(str(p))
    assert h != h2
    assert plat.read_handle(h, 10, 5) == bytes(range(10, 15))
    assert plat.read_handle(h2, 95, 10) == bytes(range(95, 100))
    plat.close_handle(h)
    plat.close_handle(h2)


def test_fixed_timestep_loop():
    steps = []

    def init(p):
        return dict(n=0)

    def update(p, s, inp, dt):
        assert isinstance(inp, GameInput) and not inp.key_pressed(65)
        s["n"] += 1
        steps.append(dt)

    def render(p, s, sink, lerp):
        assert lerp == 1.0
        sink.present(np.zeros((4, 4, 3), np.uint8))

    state, sink = run_game_loop(init, update, render, max_frames=5)
    assert state["n"] == 5
    assert sink.count == 5
    assert steps == [1.0 / 60] * 5


def test_terminate_ends_the_loop():
    def update(p, s, inp, dt):
        s["n"] += 1
        if s["n"] == 3:
            p.terminate()

    state, sink = run_game_loop(lambda p: dict(n=0), update,
                                lambda p, s, sink, lerp: sink.present(None))
    assert state["n"] == 3 and sink.count == 3


def test_triple_buffer_handoff():
    tb = TripleBuffer(lambda: {"v": 0})
    assert tb.acquire_read() is None
    tb.write_frame()["v"] = 1
    tb.publish()
    f = tb.acquire_read()
    assert f["v"] == 1
    assert tb.acquire_read() is None   # consumed
    tb.write_frame()["v"] = 2
    tb.publish()
    tb.write_frame()["v"] = 3
    tb.publish()
    assert tb.acquire_read()["v"] == 3  # freshest wins


def test_threaded_loop_runs():
    def init(p):
        return dict(ticks=0, rendered=0)

    def update(p, s, inp, dt, frame):
        s["ticks"] += 1
        frame["t"] = s["ticks"]

    def render(p, s, frame, sink):
        s["rendered"] = frame["t"]
        sink.present(np.zeros((2, 2, 3), np.uint8))

    t0 = time.perf_counter()
    state, sink = run_threaded_loop(init, update, render, hz=120, max_frames=5)
    assert sink.count == 5
    assert state["ticks"] >= 5
    assert state["rendered"] > 0
    assert time.perf_counter() - t0 < 30


def test_frame_sink_writes_png(tmp_path):
    """FrameSink(directory) writes frame_NNNNN.png (RGB and RGBA) with
    the port's zlib writer; each reads back equal, and the callback sees
    every frame with its index."""
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (17, 23, 3)).astype(np.uint8),
              rng.randint(0, 256, (9, 31, 4)).astype(np.uint8)]
    seen = []
    sink = FrameSink(directory=str(tmp_path / "out"),
                     callback=lambda img, i: seen.append(i))
    for f in frames:
        sink.present(f)
    assert sink.count == 2 and seen == [0, 1] and sink.last_frame is frames[1]
    for i, f in enumerate(frames):
        back = np.asarray(Image.open(tmp_path / "out" / f"frame_{i:05d}.png"))
        np.testing.assert_array_equal(back, f)


def _dust(seed):
    ps = ParticleSystem(maxparticles=256, emitters=[ParticleEmitter(
        rate=400.0, life=Distribution.uniform(0.1, 0.3),
        velocity=Distribution.uniform(0.2, 1.2), shape="sphere", shape_radius=6.0,
        size=Distribution.uniform(0.03, 0.10),
        color=Distribution.uniform([1.0, 0.7, 0.2, 0.3], [4.0, 2.5, 1.0, 0.8]),
        acceleration=np.array([0, 0.05, 0], np.float32),
        rotate_over_life=Distribution.constant(1.0))])
    return ps, ps.create(seed=seed)


def test_particle_updates_on_the_pool_match_in_order():
    """Stardust's fan-out: 4 systems stepped on the worker pool (joined
    each step) for 20 steps equal the same systems stepped in order on
    one thread, array for array: each owns its instance and generator."""
    plat = Platform(workers=4)
    pooled = [_dust(k) for k in range(4)]
    serial = [_dust(k) for k in range(4)]
    tfs = [Transform.translation([k * 2.0, 0, 0]) for k in range(4)]
    for _ in range(20):
        for (ps, inst), tf in zip(pooled, tfs):
            plat.submit_work(ps.update, inst, 1 / 60, tf)
        plat.workqueue.wait(4)
        for (ps, inst), tf in zip(serial, tfs):
            ps.update(inst, 1 / 60, tf)
    for (_, a), (_, b) in zip(pooled, serial):
        assert a.count > 0
        for k in ("position", "velocity", "rotation", "size", "color", "life", "alive"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
