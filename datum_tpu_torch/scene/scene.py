"""Scene: entity allocation and the component storage registry
(counterpart of datum_tpu/scene/scene.py, copied).  An EntityId is an
index and a generation, so a stale handle never aliases a reused slot;
destroying an entity re-roots its children at their world pose."""

from __future__ import annotations

from typing import Type, TypeVar

T = TypeVar("T")


class EntityId:
    __slots__ = ("index", "generation")

    def __init__(self, index, generation):
        self.index = index
        self.generation = generation

    def __eq__(self, other):
        return (isinstance(other, EntityId) and self.index == other.index
                and self.generation == other.generation)

    def __hash__(self):
        return hash((self.index, self.generation))

    def __repr__(self):
        return f"EntityId({self.index}:{self.generation})"


class Scene:
    def __init__(self):
        self._generations: list[int] = []
        self._freelist: list[int] = []
        self._storages: dict[type, object] = {}

    # --- entities ---------------------------------------------------------
    def create_entity(self) -> EntityId:
        if self._freelist:
            idx = self._freelist.pop()
        else:
            idx = len(self._generations)
            self._generations.append(0)
        return EntityId(idx, self._generations[idx])

    def destroy_entity(self, entity: EntityId):
        if not self.valid(entity):
            return
        from .components import TransformComponent
        ts = self._storages.get(TransformComponent)
        if ts is not None and ts.has(entity):
            # unlink from the hierarchy: children re-root (their local
            # becomes their world-relative pose under identity) and the
            # parent's child list drops the dead node — a destroyed
            # parent must not keep composing into live children
            tc = ts.get(entity)
            parent = getattr(tc, "parent", None)
            if parent is not None and tc in getattr(parent, "children", ()):
                parent.children.remove(tc)
            for child in list(getattr(tc, "children", ())):
                w = child.world          # resolve THROUGH the dying
                child.parent = None      # parent before unlinking
                child.set_local(w)
        for storage in self._storages.values():
            if storage.has(entity):
                storage.remove(entity)
        self._generations[entity.index] += 1
        self._freelist.append(entity.index)

    def valid(self, entity: EntityId) -> bool:
        return (entity is not None and entity.index < len(self._generations)
                and self._generations[entity.index] == entity.generation)

    # --- storages ---------------------------------------------------------
    def initialise_component_storage(self, component_type: Type[T], storage=None):
        if storage is None:
            storage = component_type.make_storage()
        self._storages[component_type] = storage
        return storage

    def storage(self, component_type: Type[T]):
        if component_type not in self._storages:
            self.initialise_component_storage(component_type)
        return self._storages[component_type]

    # --- components -------------------------------------------------------
    def add_component(self, entity: EntityId, component_type: Type[T], *args, **kwargs) -> T:
        if not self.valid(entity):
            raise ValueError(f"add_component: {entity} is not a live entity")
        return self.storage(component_type).add(entity, *args, **kwargs)

    def get_component(self, entity: EntityId, component_type: Type[T]) -> T:
        return self.storage(component_type).get(entity)

    def has_component(self, entity: EntityId, component_type: Type[T]) -> bool:
        return component_type in self._storages and self._storages[component_type].has(entity)

    def remove_component(self, entity: EntityId, component_type: Type[T]):
        self.storage(component_type).remove(entity)

    def entities_with(self, component_type: Type[T]):
        return self.storage(component_type).entities()
