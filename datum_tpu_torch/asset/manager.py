"""AssetManager: an id-indexed multi-pack catalog with background
decoding (counterpart of datum_tpu/asset/manager.py).

Each loaded pack's assets get ids offset by the pack's base id;
`request()` never blocks: it returns the decoded payload if resident,
else schedules a decode on the worker pool and returns None; a decode
that raised is parked (`error()`) and not retried.  An LRU byte budget
evicts cold payloads unless a `guard()` barrier is held.  Payloads are
decoded numpy trees (PackReader's typed decoders), ready for
asset/upload.py's DeviceUploader.  PackWatcher reloads a pack whose
file changed, within the id range the pack held when it was loaded.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

from .pack import PackReader


class Asset:
    __slots__ = ("id", "pack", "local_id", "info")

    def __init__(self, id, pack, local_id, info):
        self.id = id
        self.pack = pack
        self.local_id = local_id
        self.info = info

    @property
    def type(self):
        return self.info.type

    @property
    def fields(self):
        return self.info.fields


class AssetManager:
    def __init__(self, budget_bytes: int = 256 * 1024 * 1024, workers: int = 4):
        self._packs: list[PackReader] = []
        self._assets: dict[int, Asset] = {}
        self._resident: OrderedDict[int, object] = OrderedDict()
        self._loading: dict[int, Future] = {}      # asset id -> its decode
        self._failed: dict[int, BaseException] = {}
        self._sizes: dict[int, int] = {}
        self._used = 0
        self._budget = budget_bytes
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="asset")
        self._barriers = 0

    # --- catalog ----------------------------------------------------------
    def load(self, path) -> int:
        """Load a pack's chunk directory; returns the pack's base id."""
        with self._lock:
            baseid = (max(self._assets) + 1) if self._assets else 0
            reader = PackReader(path)
            self._packs.append(reader)
            for local_id, info in reader.assets.items():
                self._assets[baseid + local_id] = Asset(baseid + local_id, reader, local_id, info)
            return baseid

    def find(self, asset_id: int) -> Optional[Asset]:
        return self._assets.get(asset_id)

    def __contains__(self, asset_id: int):
        return asset_id in self._assets

    # --- payload streaming ------------------------------------------------
    def request(self, asset_id: int):
        """Non-blocking: decoded payload if resident, else None (schedules
        load).  A decode that raised is NOT retried — error() exposes the
        exception (silent per-frame retry loops hide corrupt packs)."""
        with self._lock:
            self._reap()
            if asset_id in self._resident:
                self._resident.move_to_end(asset_id)
                return self._resident[asset_id]
            if (asset_id not in self._loading and asset_id in self._assets
                    and asset_id not in self._failed):
                self._loading[asset_id] = self._pool.submit(self._background_load, asset_id)
            return None

    def error(self, asset_id: int):
        """The exception a background decode raised for this id, if any."""
        with self._lock:
            self._reap()
            return self._failed.get(asset_id)

    def _reap(self):
        """Under the lock: drop the finished decodes from _loading and park
        the exception of each that raised (its future holds it)."""
        for aid, fut in list(self._loading.items()):
            if fut.done():
                del self._loading[aid]
                if fut.exception() is not None:
                    self._failed[aid] = fut.exception()

    def load_sync(self, asset_id: int):
        """Blocking load (decoded payload), bypassing the worker pool."""
        with self._lock:
            if asset_id in self._resident:
                self._resident.move_to_end(asset_id)
                return self._resident[asset_id]
            asset = self._assets[asset_id]
        payload = self._decode(asset_id)
        self._install(asset_id, payload, asset)
        return payload

    def ready(self, asset_id: int) -> bool:
        with self._lock:
            return asset_id in self._resident

    def _background_load(self, asset_id: int):
        """A worker's decode; an exception stays in its future, which
        _reap parks for error() (no retry)."""
        with self._lock:
            asset = self._assets.get(asset_id)
        if asset is not None:
            payload = self._decode(asset_id)
            self._install(asset_id, payload, asset)

    def _decode(self, asset_id: int):
        asset = self._assets[asset_id]
        reader = asset.pack
        decoders = {
            "catl": lambda: reader.catalog(asset.local_id),
            "text": lambda: reader.text(asset.local_id),
            "imag": lambda: reader.image(asset.local_id),
            "mesh": lambda: reader.mesh(asset.local_id),
            "matl": lambda: reader.material(asset.local_id),
            "anim": lambda: reader.animation(asset.local_id),
            "modl": lambda: reader.model(asset.local_id),
            "font": lambda: reader.font(asset.local_id),
            "part": lambda: reader.particlesystem(asset.local_id),
        }
        return decoders[asset.type]()

    def _install(self, asset_id: int, payload, asset=None):
        with self._lock:
            cur = self._assets.get(asset_id)
            if cur is None or (asset is not None and cur is not asset):
                return      # catalog changed mid-load (hot reload): stale
            size = cur.info.datasize
            # a concurrent load_sync/background pair may both install:
            # replace, don't double-count
            if asset_id in self._resident:
                self._used -= self._sizes.pop(asset_id, 0)
                del self._resident[asset_id]
            # LRU-evict cold payloads over budget (resident set acts as the
            # slot ring; barriers pin everything while > 0)
            while self._used + size > self._budget and self._resident and self._barriers == 0:
                old_id, _ = self._resident.popitem(last=False)
                self._used -= self._sizes.pop(old_id, 0)
            self._resident[asset_id] = payload
            self._sizes[asset_id] = size
            self._used += size

    # --- eviction barrier (reference: src/asset.h:159-219 asset_guard) ----
    def acquire_barrier(self):
        with self._lock:
            self._barriers += 1

    def release_barrier(self):
        with self._lock:
            self._barriers -= 1

    class _Guard:
        def __init__(self, mgr):
            self.mgr = mgr

        def __enter__(self):
            self.mgr.acquire_barrier()
            return self.mgr

        def __exit__(self, *exc):
            self.mgr.release_barrier()

    def guard(self):
        return AssetManager._Guard(self)

    def close(self):
        """Stop the worker pool (after the decodes it has taken)."""
        self._pool.shutdown(wait=True)


class PackWatcher:
    """Hot-reload support: polls pack file mtimes and reloads changed
    packs into the manager (the engine's live-edit loop; the reference
    reloads assets on pack rebuild during development).

    Usage:
        watcher = PackWatcher(manager)
        ...each frame: for asset_id in watcher.poll(): invalidate(asset_id)
    """

    def __init__(self, manager: AssetManager):
        import os

        self._mgr = manager
        self._mtimes = {}
        self._bases = {}        # path -> (base id, reserved id count)
        for base, reader in self._iter_packs():
            if reader.path is None:
                continue        # loaded from bytes: nothing to watch
            # reserved id range: load() assigns the NEXT pack's base as
            # max global id + 1, so this pack owns [base, base+max+1)
            self._bases[reader.path] = (base, max(reader.assets) + 1)
            if os.path.exists(reader.path):
                self._mtimes[reader.path] = os.stat(reader.path).st_mtime_ns

    def _iter_packs(self):
        mgr = self._mgr
        for reader in mgr._packs:
            base = next((aid - a.local_id for aid, a in mgr._assets.items()
                         if a.pack is reader), 0)
            yield base, reader

    def poll(self):
        """Returns ids of assets whose pack changed on disk (and reloads
        their catalog + evicts stale resident payloads)."""
        import os

        from .pack import PackReader

        changed = []
        mgr = self._mgr
        for path, (base, reserved) in list(self._bases.items()):
            if not os.path.exists(path):
                continue
            m = os.stat(path).st_mtime_ns
            if m == self._mtimes.get(path):
                continue
            self._mtimes[path] = m
            reader = PackReader(path)
            with mgr._lock:
                for i, (pi, r) in enumerate(
                        [(p.path, p) for p in mgr._packs]):
                    if pi == path:
                        mgr._packs[i] = reader
                for local_id, info in reader.assets.items():
                    if local_id >= reserved:
                        # the pack GREW past its reserved id range —
                        # those global ids belong to the next pack
                        from ..debug.debug import log_once
                        log_once(f"hot reload {path}: new asset "
                                 f"{local_id} exceeds the pack's "
                                 f"reserved {reserved} ids; restart to "
                                 "pick it up")
                        continue
                    aid = base + local_id
                    mgr._assets[aid] = Asset(aid, reader, local_id, info)
                    if aid in mgr._resident:
                        mgr._used -= mgr._sizes.pop(aid, 0)
                        del mgr._resident[aid]
                    mgr._failed.pop(aid, None)
                    changed.append(aid)
                # assets REMOVED by the rebuild: drop their catalog
                # entries (a stale entry would serve the old reader)
                for local_id in range(reserved):
                    aid = base + local_id
                    a = mgr._assets.get(aid)
                    if (a is not None and a.pack is not reader
                            and local_id not in reader.assets):
                        del mgr._assets[aid]
                        if aid in mgr._resident:
                            mgr._used -= mgr._sizes.pop(aid, 0)
                            del mgr._resident[aid]
        return changed
