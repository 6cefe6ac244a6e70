"""Platform layer (counterpart of datum_tpu/platform): file handles, the
worker pool that particle systems and instance updates fan out to, the
polled input snapshot, and the two host loops (a fixed-timestep loop and
a dedicated update thread with a triple-buffered hand-off).  Frames go
to a FrameSink: PNG files (written with zlib) or a callback."""

from .host import FrameSink, TripleBuffer, run_game_loop, run_threaded_loop
from .platform import FileHandle, GameInput, Platform, WorkQueue

__all__ = ["FileHandle", "FrameSink", "GameInput", "Platform", "TripleBuffer",
           "WorkQueue", "run_game_loop", "run_threaded_loop"]
