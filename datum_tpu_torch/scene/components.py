"""Scene components (counterpart of datum_tpu/scene/components.py):
Name, Transform (a hierarchy with lazy world resolution and
invalidation down the children), Sprite, Mesh (its cached world bound),
Actor (an embedded Animator), Point and Spot lights and ParticleSystem
(a system and its live instance)."""

from __future__ import annotations

import numpy as np

from ..math import Transform
from ..math.bound import Bound3
from .storage import DefaultStorage


class NameComponent:
    def __init__(self, entity, name=""):
        self.entity = entity
        self.name = name

    @classmethod
    def make_storage(cls):
        return DefaultStorage(cls)


class TransformComponent:
    """Local transform + parent/children hierarchy with lazy world
    resolution (reference: scene/transformcomponent.h:18-56)."""

    def __init__(self, entity, local=None, parent=None):
        self.entity = entity
        self.local = local if local is not None else Transform.identity()
        self.parent: "TransformComponent | None" = parent
        self.children: list = []
        self._world = None
        if parent is not None:
            parent.children.append(self)

    def set_local(self, t: Transform):
        self.local = t
        self.invalidate()

    def invalidate(self):
        self._world = None
        for c in self.children:
            c.invalidate()

    @property
    def world(self) -> Transform:
        if self._world is None:
            self._world = (self.parent.world * self.local
                           if self.parent is not None else self.local)
        return self._world

    def set_parent(self, parent):
        if self.parent is not None:
            self.parent.children.remove(self)
        self.parent = parent
        if parent is not None:
            parent.children.append(self)
        self.invalidate()

    @classmethod
    def make_storage(cls):
        return DefaultStorage(cls)


class SpriteComponent:
    def __init__(self, entity, sprite=None, size=1.0, layer=0.0, tint=(1, 1, 1, 1)):
        self.entity = entity
        self.sprite = sprite
        self.size = size
        self.layer = layer
        self.tint = np.asarray(tint, np.float32)

    @classmethod
    def make_storage(cls):
        return DefaultStorage(cls)


class MeshComponent:
    """Mesh instance with cached world-space bound (reference:
    scene/meshcomponent.h:21-111)."""

    def __init__(self, entity, mesh=None, material=0, flags=0):
        self.entity = entity
        self.mesh = mesh                 # render.context.MeshHandle
        self.material = material
        self.flags = flags
        self.world_bound: Bound3 | None = None

    @classmethod
    def make_storage(cls):
        return DefaultStorage(cls)


class ActorComponent:
    """Skinned mesh with an embedded Animator (reference:
    scene/actorcomponent.h)."""

    def __init__(self, entity, mesh=None, material=0, animator=None):
        self.entity = entity
        self.mesh = mesh
        self.material = material
        self.animator = animator
        self.world_bound: Bound3 | None = None

    @classmethod
    def make_storage(cls):
        return DefaultStorage(cls)


class PointLightComponent:
    def __init__(self, entity, intensity=(1, 1, 1), attenuation=(1, 0, 0, 0),
                 range_=None):
        self.entity = entity
        self.intensity = np.asarray(intensity, np.float32)
        att = np.array(attenuation, np.float32)   # copy: never alias the caller
        if att.shape == (3,):
            att = np.append(att, 0.0)
        if range_ is not None:
            att[3] = range_
        elif att[3] == 0:
            from ..render.renderlist import _attenuation_range
            att[3] = _attenuation_range(att[:3])
        self.attenuation = att

    @property
    def range(self):
        return float(self.attenuation[3])

    @classmethod
    def make_storage(cls):
        return DefaultStorage(cls)


class SpotLightComponent:
    def __init__(self, entity, intensity=(1, 1, 1), attenuation=(1, 0, 0, 0),
                 cutoff=0.7, range_=None):
        self.entity = entity
        self.intensity = np.asarray(intensity, np.float32)
        att = np.array(attenuation, np.float32)   # copy: never alias the caller
        if att.shape == (3,):
            att = np.append(att, 0.0)
        if range_ is not None:
            att[3] = range_
        elif att[3] == 0:
            from ..render.renderlist import _attenuation_range
            att[3] = _attenuation_range(att[:3])
        self.attenuation = att
        self.cutoff = cutoff

    @classmethod
    def make_storage(cls):
        return DefaultStorage(cls)


class ParticleSystemComponent:
    def __init__(self, entity, system=None):
        self.entity = entity
        self.system = system             # render.particlesystem.ParticleSystem
        self.instance = None             # live ParticleInstance

    @classmethod
    def make_storage(cls):
        return DefaultStorage(cls)
