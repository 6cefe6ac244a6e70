"""Skeletal animation: Pose, Animation and the multi-channel Animator
(counterpart of datum_tpu/render/animation.py, numpy host code).

The Animator blends N weighted channels (each with its own time, rate,
looping and translation scale), accumulates the joints down the
hierarchy and composes each with its bone's inverse bind transform into
the (B, 8) dual-quaternion palette that ops/geometry.py::skin_vertices
reads.  An Animation is built from arrays (`Animation(duration, joints,
times, transforms)`) or from a pack's ANIM asset
(`Animation.from_asset(pack.animation(id))`); the Animator takes a
pack's bone table (`pack.mesh(id)["bones"]`) or (name, invbind) pairs."""

from __future__ import annotations

import numpy as np

from ..math.transform import Transform, tf_blend, tf_lerp


class Pose:
    """Bone palette (B, 8) dual-quats, identity to start."""

    def __init__(self, bonecount):
        self.bones = np.tile(Transform.identity().flat(), (bonecount, 1)).astype(np.float32)

    @property
    def bonecount(self):
        return len(self.bones)


class Animation:
    """Keyed joint animation: joints is a list of dict(name, parent,
    index, count), each joint's keys the rows index .. index + count - 1
    of times (K,) and transforms (K, 8)."""

    def __init__(self, duration, joints, times, transforms):
        self.duration = float(duration)
        self.joints = joints
        self.times = np.asarray(times, np.float32)
        self.transforms = np.asarray(transforms, np.float32)

    @classmethod
    def from_asset(cls, decoded):
        """From asset/pack.py's PackReader.animation payload."""
        return cls(decoded["duration"], decoded["joints"], decoded["times"],
                   decoded["transforms"])


class _Channel:
    __slots__ = ("animation", "time", "rate", "weight", "looping", "scale", "jointmap")

    def __init__(self, animation, jointmap):
        self.animation = animation
        self.time = 0.0
        self.rate = 0.0
        self.weight = 0.0
        self.looping = False
        self.scale = np.ones(3, np.float32)
        self.jointmap = jointmap        # anim joint i -> skeleton joint index


class Animator:
    """Blends channels into a skeleton pose each update."""

    def __init__(self, bones):
        """bones: a pack's bone table, a (B,) structured array with fields
        name (S32, NUL-padded) and transform (8,) (asset/pack.py
        BONE_DTYPE), or a list of (name, inverse bind transform (8,))
        tuples."""
        if hasattr(bones, "dtype"):
            self.bone_names = [n.split(b"\0")[0].decode() for n in bones["name"]]
            self.bind = np.asarray(bones["transform"], np.float32)
        else:
            self.bone_names = [b[0] for b in bones]
            self.bind = np.asarray([b[1] for b in bones], np.float32)
        self.pose = Pose(len(self.bind))
        self.channels: list[_Channel] = []
        # skeleton joints: built from the first animation's joints
        self._joints = None

    def _build_skeleton(self, animation: Animation):
        names = [j["name"] for j in animation.joints]
        parents = [j["parent"] for j in animation.joints]
        bone_of = {n: i for i, n in enumerate(self.bone_names)}
        self._joints = [dict(name=n, parent=p, bone=bone_of.get(n, -1))
                        for n, p in zip(names, parents)]
        self._name_to_joint = {n: i for i, n in enumerate(names)}

    def play(self, animation: Animation, weight=1.0, rate=1.0, looping=True,
             scale=(1.0, 1.0, 1.0)):
        if self._joints is None:
            self._build_skeleton(animation)
        # joints absent from the skeleton map to -1 and are skipped in
        # update
        jointmap = [self._name_to_joint.get(j["name"], -1)
                    for j in animation.joints]
        ch = _Channel(animation, jointmap)
        ch.weight = weight
        ch.rate = rate
        ch.looping = looping
        ch.scale = np.asarray(scale, np.float32)
        self.channels.append(ch)
        return ch

    def set_weight(self, channel, weight):
        channel.weight = weight

    def update(self, dt: float):
        active = False
        for ch in self.channels:
            if ch.rate != 0.0:
                ch.time += ch.rate * dt
                if ch.looping and ch.animation.duration > 0.0:
                    ch.time = ch.time % ch.animation.duration
                elif ch.time <= 0.0 or ch.time >= ch.animation.duration:
                    ch.rate = 0.0
                    ch.time = float(np.clip(ch.time, 0.0, ch.animation.duration))
                active = True
        if not active or self._joints is None:
            return

        nj = len(self._joints)
        acc = [Transform(np.zeros(4, np.float32), np.zeros(4, np.float32))
               for _ in range(nj)]

        for ch in self.channels:
            if ch.weight == 0:
                continue
            anim = ch.animation
            for ai, joint in enumerate(anim.joints):
                ji = ch.jointmap[ai]
                if ji < 0:
                    continue            # joint not in this skeleton
                i0 = joint["index"]
                count = joint["count"]
                idx = i0
                while idx + 2 < i0 + count and anim.times[idx + 1] < ch.time:
                    idx += 1
                t0, t1 = anim.times[idx], anim.times[idx + 1] if count > 1 else anim.times[idx]
                alpha = 0.0 if t1 <= t0 else float(np.clip((ch.time - t0) / (t1 - t0), 0, 1))
                a = Transform.from_flat(anim.transforms[idx])
                b = Transform.from_flat(anim.transforms[min(idx + 1, i0 + count - 1)])
                tr = tf_lerp(a, b, alpha)
                local = (Transform.translation(ch.scale * tr.translation_vec())
                         * Transform.rotation(tr.rotation_quat()))
                acc[ji] = tf_blend(acc[ji], local, ch.weight)

        world = [None] * nj
        ident = Transform.identity()
        for i, joint in enumerate(self._joints):
            # a joint with no accumulated weight holds bind pose instead
            # of normalizing the zero dual-quat
            zero = float(np.dot(acc[i].real, acc[i].real)) < 1e-12
            local = ident if zero else acc[i].normalized()
            p = joint["parent"]
            world[i] = local if p == i or world[p] is None else world[p] * local
            bone = joint["bone"]
            if 0 <= bone < self.pose.bonecount:
                palette = world[i] * Transform.from_flat(self.bind[bone])
                self.pose.bones[bone] = palette.flat()

    def palette(self):
        """(B, 8) float32 palette for the device skinning path."""
        return self.pose.bones
