"""torch_device_ms: device time a frame of every kernel that is not one
of the program's hand-written kernels (its csrc/ library), over the
profiled window: torch's own ops."""


def read(r):
    s = sum(sec for name, sec in r.window.kernels() if name not in r.window.library)
    return s / r.frames_profiled * 1e3 if s > 0 else None
