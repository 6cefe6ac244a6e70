"""device_idle_pct: the share of the profiled window in which the device
ran no operation: 1 - the union of the device operations' intervals
(kernels, copies, sets) over the window's span, from the trace's
timeline.  Read from the window that records the CUDA activity alone,
which leaves the host near its untraced pace (the full trace's host
overhead would read the device idler than it is); on a machine without
that window, from the full one."""


def read(r):
    w = r.device_window or r.window
    return 100.0 * (1.0 - w.busy_s / w.window_s) if w.window_s > 0 and w.device_ops else None
