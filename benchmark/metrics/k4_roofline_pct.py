"""k4_roofline_pct: K4 (csrc/raster_blend.cu, the weighted-blend OIT
accumulation; twice a frame on the deferred branch, the translucents and
then the particles): the sum of its bounds over the launches of the
profiled window (framebench.roofline_raster, from each launch's own
inputs, captured as the frame calls it) over its device time in the same
window, found by kernel name. None when the kernel did not run or its
wrapper was not called (a replayed CUDA graph launches K4 without it)."""

from framebench import roofline_raster

KERNEL = "raster_blend_kernel"
# the program functions whose arguments are the kernel's inputs (the
# kernel on CUDA tensors, its plain version on CPU tensors)
CAPTURE = ("datum_tpu_torch.ops.raster_blend_cuda",
           ("raster_blend_cuda", "raster_blend_reference"))


def work(inp):
    return roofline_raster.k4_bound(inp)[0]


def read(r):
    bounds = r.work.get("k4_roofline_pct")
    device_s = r.window.kernel_s(KERNEL) * r.frames_profiled
    if not bounds or device_s <= 0:
        return None
    return 100.0 * sum(bounds) / device_s
