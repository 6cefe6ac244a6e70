"""enqueue_ms: the host's time in render_frame a frame, from its call to
its return (no synchronize: the frame graph's dispatch, convert.to_torch
and any host sync inside it), the mean of the benchmark's span over the
window's frames."""


def read(r):
    s = (r.spans or {}).get("enqueue")
    return sum(s) / len(s) * 1e3 if s else None
