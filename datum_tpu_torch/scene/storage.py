"""Component storage (counterpart of datum_tpu/scene/storage.py,
copied): rows of component objects with an entity -> row map,
swap-remove, and `column` for a dense numpy view of one field."""

from __future__ import annotations

import numpy as np


class DefaultStorage:
    def __init__(self, component_factory):
        self._factory = component_factory
        self._index: dict = {}          # EntityId -> row
        self._entities: list = []
        self._rows: list = []

    def add(self, entity, *args, **kwargs):
        comp = self._factory(entity, *args, **kwargs)
        if entity in self._index:
            # re-adding replaces the row in place (appending would
            # orphan the old component: systems keep iterating it and a
            # later swap-remove can resurrect the stale index)
            self._rows[self._index[entity]] = comp
            return comp
        self._index[entity] = len(self._rows)
        self._entities.append(entity)
        self._rows.append(comp)
        return comp

    def get(self, entity):
        return self._rows[self._index[entity]]

    def has(self, entity):
        return entity in self._index

    def remove(self, entity):
        row = self._index.pop(entity)
        last = len(self._rows) - 1
        if row != last:
            self._rows[row] = self._rows[last]
            self._entities[row] = self._entities[last]
            self._index[self._entities[row]] = row
        self._rows.pop()
        self._entities.pop()

    def entities(self):
        return list(self._entities)

    def rows(self):
        return self._rows

    def __len__(self):
        return len(self._rows)

    def column(self, attr, dtype=np.float32):
        """Dense (N, ...) array of one field across all rows."""
        return np.asarray([getattr(r, attr) for r in self._rows], dtype=dtype)
