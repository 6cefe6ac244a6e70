"""Particle system (counterpart of datum_tpu/render/particlesystem.py):
emitters, distributions and the vectorized host simulation.

Distribution (constant, uniform, table), ParticleEmitter with its
over-life modules, the SoA ParticleInstance and ParticleSystem.update:
integrate velocity and position, decay life, evaluate the over-life
modules per owning emitter, then emit (rate and bursts) from the
emitter's shape.  The simulation is numpy on the host, as in the JAX
package: RenderList.forward_arrays turns the live particles into the
billboard stream the frame uploads.  Each instance owns a
np.random.RandomState(seed), drawn in the JAX package's order (shape,
then velocity, life, size, rotation and colour, per emitter, per step),
so both packages simulate the same particles from one seed.  A
single-emitter system integrates with one masked numpy pass; the JAX
package's native fused pass computes the same values (its t01 clamp
changes nothing that the over-life modules read: uniform and table
curves clip t01 themselves).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..math.bound import Bound3
from ..math.quaternion import quat_rotate


class Distribution:
    """Scalar/vector distribution over particle life or emission."""

    def __init__(self, kind, a=None, b=None, table=None):
        self.kind = kind
        self.a = a
        self.b = b
        self.table = table

    @classmethod
    def constant(cls, v):
        return cls("constant", a=np.asarray(v, np.float32))

    @classmethod
    def uniform(cls, lo, hi):
        return cls("uniform", a=np.asarray(lo, np.float32),
                   b=np.asarray(hi, np.float32))

    @classmethod
    def table(cls, values):
        return cls("table", table=np.asarray(values, np.float32))

    def sample(self, n, rng):
        """Random draw per particle (emission-time use)."""
        if self.kind == "constant":
            return np.broadcast_to(self.a, (n,) + np.shape(self.a)).copy()
        if self.kind == "uniform":
            u = rng.rand(n, *np.shape(self.a)) if np.shape(self.a) else rng.rand(n)
            return (self.a + (self.b - self.a) * u).astype(np.float32)
        idx = rng.randint(0, len(self.table), n)
        return self.table[idx]

    def evaluate(self, t01):
        """Deterministic curve lookup (over-life use); t01 (N,), clipped
        to [0, 1] by the uniform and table curves."""
        if self.kind == "constant":
            return np.broadcast_to(self.a, np.shape(t01) + np.shape(self.a))
        if self.kind == "uniform":
            t = np.clip(t01, 0, 1)
            return self.a + (self.b - self.a) * (t[..., None] if np.shape(self.a) else t)
        x = np.clip(t01, 0, 1) * (len(self.table) - 1)
        i0 = np.floor(x).astype(np.int32)
        i1 = np.minimum(i0 + 1, len(self.table) - 1)
        f = (x - i0)
        if self.table.ndim > 1:
            f = f[..., None]
        return self.table[i0] + (self.table[i1] - self.table[i0]) * f


@dataclasses.dataclass
class ParticleEmitter:
    duration: float = 2.0
    looping: bool = True
    rate: float = 20.0
    bursts: list = dataclasses.field(default_factory=list)   # [(time, count)]
    life: Distribution = None
    size: Distribution = None                 # base size at emit
    velocity: Distribution = None             # emit speed along shape dir
    rotation: Distribution = None
    color: Distribution = None                # emit tint rgba
    emissive: float = 0.0
    acceleration: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, -9.81, 0], np.float32))
    shape: str = "point"                      # point|sphere|hemisphere|cone
    shape_radius: float = 0.0
    shape_angle: float = 0.5                  # cone half-angle
    scale_over_life: Distribution = None
    color_over_life: Distribution = None
    rotate_over_life: Distribution = None
    layer_over_life: Distribution = None      # spritesheet layer anim
    stretch_with_velocity: float = 0.0

    def __post_init__(self):
        self.life = self.life or Distribution.uniform(1.0, 2.0)
        self.size = self.size or Distribution.constant(0.1)
        self.velocity = self.velocity or Distribution.uniform(1.0, 3.0)
        self.rotation = self.rotation or Distribution.constant(0.0)
        self.color = self.color or Distribution.constant([1, 1, 1, 1])


class ParticleInstance:
    """SoA particle state: the arrays RenderList.forward_arrays reads
    (position, size, rotation, color, alive) and the simulation's."""

    def __init__(self, maxparticles, seed=0, n_emitters=1):
        n = maxparticles
        self.position = np.zeros((n, 3), np.float32)
        self.velocity = np.zeros((n, 3), np.float32)
        self.rotation = np.zeros(n, np.float32)
        self.basesize = np.zeros(n, np.float32)
        self.size = np.zeros((n, 2), np.float32)
        self.basecolor = np.ones((n, 4), np.float32)
        self.color = np.ones((n, 4), np.float32)
        self.layer = np.zeros(n, np.float32)
        self.life = np.zeros(n, np.float32)       # remaining
        self.maxlife = np.ones(n, np.float32)
        self.alive = np.zeros(n, bool)
        self.emitter = np.zeros(n, np.int32)      # owning emitter per slot
        self.time = 0.0
        # fractional emission carry, per emitter (a shared accumulator
        # would couple their rates)
        self.emit_accum = np.zeros(n_emitters, np.float64)
        self.rng = np.random.RandomState(seed)

    @property
    def count(self):
        return int(self.alive.sum())


class ParticleSystem:
    def __init__(self, maxparticles=1000, emitters=None, bound=None, spritesheet=0):
        self.maxparticles = maxparticles
        self.emitters = emitters or [ParticleEmitter()]
        self.bound = bound or Bound3([-5, -5, -5], [5, 5, 5])
        self.spritesheet = spritesheet

    def create(self, seed=0) -> ParticleInstance:
        return ParticleInstance(self.maxparticles, seed,
                                n_emitters=len(self.emitters))

    def update(self, instance: ParticleInstance, dt, transform, camera=None):
        """Advance the instance by dt under the emitters' world transform
        (camera: unused, the JAX package's signature)."""
        inst = instance
        inst.time += dt
        rng = inst.rng

        # integrate live particles, each with its owning emitter's
        # acceleration
        a = inst.alive
        if a.any():
            groups = ([(a, self.emitters[0])] if len(self.emitters) == 1 else
                      [(a & (inst.emitter == ei), em)
                       for ei, em in enumerate(self.emitters)])
            for ea, em in groups:
                if not ea.any():
                    continue
                inst.velocity[ea] += np.asarray(em.acceleration, np.float32) * dt
                inst.position[ea] += inst.velocity[ea] * dt
                inst.life[ea] -= dt
            inst.alive &= inst.life > 0

        # over-life modules, per owning emitter
        for ei, em in enumerate(self.emitters):
            a = inst.alive if len(self.emitters) == 1 else (
                inst.alive & (inst.emitter == ei))
            if not a.any():
                continue
            t01 = 1.0 - inst.life[a] / inst.maxlife[a]
            if em.scale_over_life is not None:
                s = em.scale_over_life.evaluate(t01)
                inst.size[a] = inst.basesize[a][:, None] * np.stack([s, s], -1) \
                    if np.ndim(s) == 1 else inst.basesize[a][:, None] * s
            if em.color_over_life is not None:
                inst.color[a] = inst.basecolor[a] * em.color_over_life.evaluate(t01)
            if em.rotate_over_life is not None:
                inst.rotation[a] += em.rotate_over_life.evaluate(t01) * dt
            if em.layer_over_life is not None:
                inst.layer[a] = em.layer_over_life.evaluate(t01)

        # emission
        for ei, em in enumerate(self.emitters):
            n_emit = 0
            # a non-looping emitter only emits during [0, duration]
            expired = (not em.looping and em.duration > 0
                       and inst.time - dt >= em.duration)
            if not expired:
                inst.emit_accum[ei] += em.rate * dt
                n_emit += int(inst.emit_accum[ei])
                inst.emit_accum[ei] -= int(inst.emit_accum[ei])
            if em.looping and em.duration > 0:
                t_mod = inst.time % em.duration
            else:
                t_mod = inst.time
            for btime, bcount in em.bursts:
                fired = (t_mod - dt <= btime < t_mod
                         or (btime == 0.0 and inst.time <= dt))
                if em.looping and em.duration > 0 and t_mod - dt < 0:
                    # the loop period wrapped inside this step: the
                    # window covers the end of the previous period too
                    fired = fired or btime >= (t_mod - dt) % em.duration
                if fired and not expired:
                    n_emit += bcount
            if n_emit <= 0:
                continue
            free = np.nonzero(~inst.alive)[0][:n_emit]
            n = len(free)
            if n == 0:
                continue
            pos, dirs = self._emit_shape(em, n, rng)
            world_pos = transform.transform_point(pos)
            world_dir = quat_rotate(transform.rotation_quat(), dirs)
            speed = em.velocity.sample(n, rng)
            if speed.ndim > 1:
                speed = speed[:, 0]
            inst.position[free] = world_pos
            inst.velocity[free] = world_dir * speed[:, None]
            life = em.life.sample(n, rng)
            inst.life[free] = life
            inst.maxlife[free] = np.maximum(life, 1e-5)
            inst.basesize[free] = em.size.sample(n, rng)
            inst.size[free] = inst.basesize[free][:, None]
            inst.rotation[free] = em.rotation.sample(n, rng)
            inst.basecolor[free] = em.color.sample(n, rng)
            inst.color[free] = inst.basecolor[free]
            inst.layer[free] = 0
            inst.emitter[free] = ei
            inst.alive[free] = True

    def _emit_shape(self, em, n, rng):
        """(local positions (n, 3), directions (n, 3)) of n emissions."""
        if em.shape == "sphere":
            d = rng.randn(n, 3).astype(np.float32)
            d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
            r = em.shape_radius * rng.rand(n).astype(np.float32) ** (1 / 3)
            return d * r[:, None], d
        if em.shape == "hemisphere":
            d = rng.randn(n, 3).astype(np.float32)
            d[:, 1] = np.abs(d[:, 1])
            d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
            return d * em.shape_radius, d
        if em.shape == "cone":
            phi = rng.rand(n).astype(np.float32) * 2 * np.pi
            ct = 1 - rng.rand(n).astype(np.float32) * (1 - np.cos(em.shape_angle))
            st = np.sqrt(1 - ct * ct)
            d = np.stack([st * np.cos(phi), ct, st * np.sin(phi)], -1).astype(np.float32)
            return np.zeros((n, 3), np.float32), d
        # point
        up = np.tile(np.array([0, 1, 0], np.float32), (n, 1))
        return np.zeros((n, 3), np.float32), up
