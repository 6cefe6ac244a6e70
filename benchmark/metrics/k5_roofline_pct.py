"""k5_roofline_pct: K5 (csrc/raster_v1.cu, the deferred branch's
visibility raster): the sum of its bounds over the launches of the
profiled window (framebench.roofline_raster, from each launch's own
inputs, captured as the frame calls it) over its device time in the same
window, found by kernel name. None when the kernel did not run."""

from framebench import roofline_raster

KERNEL = "raster_v1_kernel"
# the program functions whose arguments are the kernel's inputs (the
# kernel on CUDA tensors, its plain version on CPU tensors)
CAPTURE = ("datum_tpu_torch.ops.raster_v1_cuda", ("raster_v1_cuda", "raster_v1_reference"))


def work(inp):
    return roofline_raster.k5_bound(inp)[0]


def read(r):
    bounds = r.work.get("k5_roofline_pct")
    device_s = r.window.kernel_s(KERNEL) * r.frames_profiled
    if not bounds or device_s <= 0:
        return None
    return 100.0 * sum(bounds) / device_s
