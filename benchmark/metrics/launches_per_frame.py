"""launches_per_frame: kernel-launch API calls on the host a frame over
the profiled window (cudaLaunchKernel and its variants)."""


def read(r):
    return r.window.launches / r.frames_profiled if r.window.launches else None
