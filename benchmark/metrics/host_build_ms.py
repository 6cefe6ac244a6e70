"""host_build_ms: the host's frame build a frame (steps 1-3 of the loop:
make_renderlist, RenderContext.frame_draws with the host expansion,
make_sceneset), the mean of the benchmark's span over the window's
frames."""


def read(r):
    s = (r.spans or {}).get("build")
    return sum(s) / len(s) * 1e3 if s else None
