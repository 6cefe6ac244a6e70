"""Entity-component scene (counterpart of datum_tpu/scene): a Scene
with generation-checked entity ids, component storages, the transform
hierarchy, the per-frame systems that cull before they push draws, and
Model, the compound entity a pack's MODL asset loads into."""

from .components import (
    ActorComponent, MeshComponent, NameComponent, ParticleSystemComponent,
    PointLightComponent, SpotLightComponent, SpriteComponent, TransformComponent,
)
from .model import Model
from .scene import EntityId, Scene
from .storage import DefaultStorage
from .systems import (MESH_FLAG_OCCLUDER, fill_occlusion, gather_lights, update_actors,
                      update_meshes, update_particlesystems)

__all__ = ["ActorComponent", "DefaultStorage", "EntityId", "MESH_FLAG_OCCLUDER",
           "MeshComponent", "Model", "NameComponent", "ParticleSystemComponent",
           "PointLightComponent", "Scene", "SpotLightComponent", "SpriteComponent",
           "TransformComponent", "fill_occlusion", "gather_lights", "update_actors",
           "update_meshes", "update_particlesystems"]
