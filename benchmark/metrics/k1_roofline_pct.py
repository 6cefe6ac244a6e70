"""k1_roofline_pct: K1 (csrc/raster_shade.cu, the fused raster and
attribute interpolation): the sum of its bounds over the launches of the
profiled window (framebench.roofline, from each launch's own inputs,
captured as the frame calls it) over its device time in the same window,
found by kernel name. None when the kernel did not run."""

from framebench import roofline

KERNEL = "raster_shade_kernel"
# the program functions whose arguments are the kernel's inputs (the
# kernel on CUDA tensors, its plain version on CPU tensors)
CAPTURE = ("datum_tpu_torch.ops.raster_cuda", ("raster_shade_cuda", "raster_shade_reference"))


def work(inp):
    b = roofline.k1_bound(inp)
    return None if b is None else b[0]


def read(r):
    bounds = r.work.get("k1_roofline_pct")
    device_s = r.window.kernel_s(KERNEL) * r.frames_profiled
    if not bounds or device_s <= 0:
        return None
    return 100.0 * sum(bounds) / device_s
