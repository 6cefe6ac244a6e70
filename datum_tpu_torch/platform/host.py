"""Host game loops and frame presentation (counterpart of
datum_tpu/platform/host.py): run_game_loop steps a fixed timestep (with
catch-up steps in real time) and renders once a step; run_threaded_loop
runs the update on its own thread at 1/hz and renders the freshest frame
that a TripleBuffer hands over.  FrameSink stands in for the swapchain:
it keeps the last frame, calls a callback, or writes PNG files."""

from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np

from .platform import GameInput, Platform


class FrameSink:
    """Receives presented frames: keeps the last one, passes each to
    callback(image, index), and writes each to directory as
    frame_NNNNN.png."""

    def __init__(self, directory=None, callback=None, keep_last=True):
        self.directory = directory
        self.callback = callback
        self.keep_last = keep_last
        self.last_frame = None
        self.count = 0
        if directory:
            os.makedirs(directory, exist_ok=True)

    def present(self, image: np.ndarray):
        if self.keep_last:
            self.last_frame = image
        if self.callback:
            self.callback(image, self.count)
        if self.directory:
            from ..examples.common import write_png
            write_png(os.path.join(self.directory, f"frame_{self.count:05d}.png"),
                      image)
        self.count += 1


def run_game_loop(game_init, game_update, game_render, *, fps=60,
                  max_frames=None, max_seconds=None, sink=None,
                  platform=None, realtime=False):
    """Fixed-timestep loop; returns (state, sink).

    game_init(platform) -> state
    game_update(platform, state, input, dt) -> None
    game_render(platform, state, sink, lerp) -> None

    With realtime, up to 5 steps of 1/fps catch the simulation up with
    the wall clock before each render, and lerp is the render's
    interpolation factor in [0, 1]; otherwise one step a frame, lerp 1.
    """
    platform = platform or Platform()
    sink = sink or FrameSink()
    inp = GameInput()
    state = game_init(platform)

    dt = 1.0 / fps
    sim_time = time.perf_counter() if realtime else 0.0
    frames = 0
    start = time.perf_counter()
    while not platform.terminated:
        if max_frames is not None and frames >= max_frames:
            break
        if max_seconds is not None and time.perf_counter() - start > max_seconds:
            break
        if realtime:
            now = time.perf_counter()
            steps = 0
            while sim_time < now and steps < 5:
                game_update(platform, state, inp, dt)
                sim_time += dt
                steps += 1
            lerp = min(max((now - (sim_time - dt)) / dt, 0.0), 1.0)
        else:
            game_update(platform, state, inp, dt)
            lerp = 1.0
        game_render(platform, state, sink, lerp)
        frames += 1
    return state, sink


class TripleBuffer:
    """Triple-buffered frame hand-off between an update thread (writes
    write_frame(), then publish()) and a render thread (acquire_read()
    takes the freshest published frame, or None if nothing is new)."""

    def __init__(self, make_frame):
        self._frames = [make_frame() for _ in range(3)]
        self._ready = None        # index of the freshest completed frame
        self._lock = threading.Lock()
        self._write = 0
        self._read = None

    def write_frame(self):
        return self._frames[self._write]

    def publish(self):
        """Update thread: swap the written frame into the ready slot."""
        with self._lock:
            old_ready = self._ready
            self._ready = self._write
            # reuse the stale ready slot (or the never-used third buffer)
            free = {0, 1, 2} - {self._ready, self._read}
            self._write = free.pop() if old_ready is None or old_ready in free \
                else old_ready

    def acquire_read(self):
        """Render thread: take the freshest frame (None if nothing new)."""
        with self._lock:
            if self._ready is None:
                return None
            self._read = self._ready
            self._ready = None
            return self._frames[self._read]


def run_threaded_loop(game_init, game_update, game_render, *, hz=60,
                      max_frames=None, sink=None, platform=None,
                      make_frame=dict):
    """Update thread stepping 1/hz + render on the caller's thread;
    returns (state, sink).

    game_update(platform, state, input, dt, frame) fills the triple
    buffer's write frame; game_render(platform, state, frame, sink)
    renders the freshest published one."""
    platform = platform or Platform()
    sink = sink or FrameSink()
    inp = GameInput()
    state = game_init(platform)
    buffers = TripleBuffer(make_frame)
    stop = threading.Event()

    def update_thread():
        dt = 1.0 / hz
        next_t = time.perf_counter()
        while not stop.is_set() and not platform.terminated:
            game_update(platform, state, inp, dt, buffers.write_frame())
            buffers.publish()
            next_t += dt
            delay = next_t - time.perf_counter()
            if delay > 0:
                time.sleep(min(delay, dt))

    t = threading.Thread(target=update_thread, daemon=True)
    t.start()
    frames = 0
    with contextlib.ExitStack() as done:       # however the loop ends:
        done.callback(t.join, 2.0)             # stop the update thread,
        done.callback(stop.set)                # then join it
        while not platform.terminated:
            if max_frames is not None and frames >= max_frames:
                break
            frame = buffers.acquire_read()
            if frame is None:
                time.sleep(0.0005)
                continue
            game_render(platform, state, frame, sink)
            frames += 1
    return state, sink
