"""The closed frame loop of a game host at a fixed update rate.

Each frame, in order: the render list at time t (make_renderlist), the
draws with their host expansion (RenderContext.frame_draws), the scene
set (render.types.make_sceneset) and render_frame with the previous
frame's ao_prev.  t advances 1/hz a frame from t0.  At most `in_flight`
frames are in flight: before building frame i the host waits on the
event recorded at the end of frame i - in_flight.  The image stays on
the device.  The same loop drives the program (datum_tpu_torch) and,
for the comparison, the plain reference (plainframe): a Side names the
three entry points of either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
import types

import torch


class HostEvent:
    """torch.cuda.Event's interface on the CPU (the tests' device): the
    host's clock at record()."""

    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def new_event(device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return HostEvent()


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Side:
    """The entry points of one implementation of the frame."""
    scenes: types.ModuleType
    make_sceneset: object
    render_frame: object


def program_side():
    from datum_tpu_torch import scenes
    from datum_tpu_torch.render.frame import render_frame
    from datum_tpu_torch.render.types import make_sceneset
    return Side(scenes, make_sceneset, render_frame)


def reference_side():
    from plainframe import scenes
    from plainframe.render.frame import render_frame
    from plainframe.render.types import make_sceneset
    return Side(scenes, make_sceneset, render_frame)


@dataclasses.dataclass
class Scene:
    ctx: object
    camera: object
    params: object
    make_renderlist: object

    @property
    def cfg(self):
        return self.ctx.config

    def inputs(self, side, t):
        """(draws, sceneset) of the frame at time t: steps 1-3."""
        rl = self.make_renderlist(t)
        draws = self.ctx.frame_draws(rl, self.camera)
        ss = side.make_sceneset(self.camera, self.params, point_lights=rl.point_lights,
                                spot_lights=rl.spot_lights, probes=rl.probes)
        return draws, ss


def build_scene(side, config, traffic, device):
    """The configuration's scene at the traffic's viewport: its scene
    builder called with the configuration's `frame` keywords."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in config["frame"].items()}
    ctx, camera, params, make_rl = getattr(side.scenes, config["scene"])(
        width=traffic["width"], height=traffic["height"], device=str(device), **kw)
    return Scene(ctx, camera, params, make_rl)


def start_time(seed, traffic):
    """(t0, the run's random stream): t0 in [0, t0_max_s) from the seed."""
    rng = random.Random(int(seed))
    return rng.uniform(0.0, float(traffic["t0_max_s"])), rng


class Sample:
    """k of the frames offered, drawn uniformly by the stream (reservoir):
    (frame index, its outputs, the prev it was given)."""

    def __init__(self, k, rng):
        self.k, self.rng, self.kept, self.n = k, rng, [], 0

    def offer(self, i, out, prev):
        if len(self.kept) < self.k:
            self.kept.append((i, out, prev))
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.kept[j] = (i, out, prev)
        self.n += 1


def _no_label(_name):
    return contextlib.nullcontext()


class FrameLoop:
    """The program's frame loop on one device; frame i renders t0 + i/hz."""

    def __init__(self, side, scene, state, device, t0, hz, in_flight):
        self.side, self.scene, self.state, self.device = side, scene, state, device
        self.t0, self.hz, self.in_flight = t0, hz, in_flight
        self.i, self.prev = 0, None

    def t(self, i):
        return self.t0 + i / self.hz

    def run(self, *, until=None, count=None, spans=None, label=_no_label, keep=None):
        """Frames until the host clock passes `until` or `count` frames
        ran.  spans: a dict that gets each frame's wait, build and enqueue
        seconds.  label(name): a context manager around each of the three
        (the profiler's ranges).  keep(i, out, prev): each frame's
        outputs.  Returns the events: one at the start, then one at the
        end of each frame (not synchronized)."""
        start = new_event(self.device)
        start.record()
        ends = []
        clock = time.perf_counter
        while True:
            a = clock()
            if len(ends) >= self.in_flight:
                with label("wait"):
                    ends[-self.in_flight].synchronize()
            b = clock()
            with label("build"):
                draws, ss = self.scene.inputs(self.side, self.t(self.i))
            c = clock()
            with label("enqueue"):
                out = self.side.render_frame(self.scene.cfg, self.state, draws, ss,
                                             device=self.device, prev=self.prev)
            d = clock()
            end = new_event(self.device)
            end.record()
            ends.append(end)
            if spans is not None:
                for name, v in (("wait", b - a), ("build", c - b), ("enqueue", d - c)):
                    spans.setdefault(name, []).append(v)
            if keep is not None:
                keep(self.i, out, self.prev)
            self.prev = out.get("ao_prev")
            self.i += 1
            if count is not None and len(ends) >= count:
                break
            if until is not None and clock() >= until:
                break
        return [start] + ends


def intervals_ms(events):
    """The device times between consecutive events (after a synchronize)."""
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]
