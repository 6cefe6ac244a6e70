"""Files, worker pool and input state (counterpart of
datum_tpu/platform/platform.py): Platform opens, reads and closes file
handles, submits work to a thread pool and carries the terminate flag;
GameInput is the polled input snapshot."""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor


class FileHandle:
    __slots__ = ("_f", "_lock")

    def __init__(self, path):
        self._f = open(path, "rb")
        self._lock = threading.Lock()

    def read(self, position, nbytes):
        with self._lock:
            self._f.seek(position)
            return self._f.read(nbytes)

    def close(self):
        self._f.close()


class WorkQueue:
    """A thread pool whose completed items a semaphore counts: submit
    fans work out, wait(count) joins that many completions."""

    def __init__(self, workers=4):
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="datum-worker")
        self._sem = threading.Semaphore(0)

    def submit(self, fn, *args):
        """Run fn(*args) on a worker; its completion (or its exception,
        which the item's future keeps) counts toward wait()."""
        self._pool.submit(fn, *args).add_done_callback(lambda _: self._sem.release())

    def wait(self, count):
        """Block until `count` submitted items have completed."""
        for _ in range(count):
            self._sem.acquire()


class GameInput:
    """Polled input snapshot: keys, mouse, text and controllers."""

    def __init__(self):
        self.keys = [False] * 256
        self.mouse_x = 0.0
        self.mouse_y = 0.0
        self.mouse_dx = 0.0
        self.mouse_dy = 0.0
        self.mouse_buttons = [False] * 5
        self.mouse_wheel = 0.0
        self.text = ""
        self.controllers = []

    def key_pressed(self, code):
        return self.keys[code % 256]


class Platform:
    def __init__(self, workers=4):
        self._handles: dict[int, FileHandle] = {}
        self._next = 1
        self.workqueue = WorkQueue(workers)
        self.terminated = False

    # --- files ------------------------------------------------------------
    def open_handle(self, identifier) -> int:
        h = self._next
        self._next += 1
        self._handles[h] = FileHandle(identifier)
        return h

    def read_handle(self, handle, position, nbytes) -> bytes:
        return self._handles[handle].read(position, nbytes)

    def close_handle(self, handle):
        self._handles.pop(handle).close()

    # --- work -------------------------------------------------------------
    def submit_work(self, fn, *args):
        self.workqueue.submit(fn, *args)

    def terminate(self):
        self.terminated = True
