"""Debug and profiling layer (counterpart of datum_tpu/debug): the
timed-block event ring with frame markers, device pass times, resource
gauges, statistics, live-tunable menu values, the binary dump and the
in-frame overlay; the program's tracing switch and its spans."""

from .debug import (
    PREFIX, DebugLog, begin_timed_block, debug_menu_value, end_timed_block,
    frame_marker, g_debuglog, gpu_block, load_debuglog, log_once, resource_use,
    set_debug_menu_value, set_tracing, span, statistic_hit, stream_debuglog,
    timed_block, traced, tracing,
)
from .overlay import debug_menu_adjust, render_debug_overlay

__all__ = ["PREFIX", "DebugLog", "begin_timed_block", "debug_menu_adjust", "debug_menu_value",
           "end_timed_block", "frame_marker", "g_debuglog", "gpu_block", "load_debuglog",
           "log_once", "render_debug_overlay", "resource_use", "set_debug_menu_value",
           "set_tracing", "span", "statistic_hit", "stream_debuglog", "timed_block",
           "traced", "tracing"]
