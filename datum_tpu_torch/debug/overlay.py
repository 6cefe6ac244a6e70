"""In-frame debug overlay: frame-time bars, the block list, gauges and
the value menu, blitted onto a presented u8 frame on the host
(counterpart of datum_tpu/debug/overlay.py, copied)."""

from __future__ import annotations

import numpy as np

from ..render.sprite import Font, draw_text
from .debug import g_debuglog

_font = None


def _get_font():
    global _font
    if _font is None:
        _font = Font.builtin()
    return _font


def render_debug_overlay(image: np.ndarray, fps=None, log=None):
    """Draw profiling overlay onto a uint8 frame in place."""
    log = log or g_debuglog
    font = _get_font()
    y = 8
    if fps is not None:
        draw_text(image, font, f"FPS: {fps:.1f}", 8, y, tint=(1, 1, 0.3, 1))
        y += 10

    times = log.block_times(frames_back=1)
    total = sum(times.values()) or 1e-9
    barw = min(200, image.shape[1] - 120)
    for name, secs in sorted(times.items(), key=lambda kv: -kv[1])[:12]:
        ms = secs * 1000
        draw_text(image, font, f"{name[:14]}", 8, y, tint=(1, 1, 1, 0.9))
        draw_text(image, font, f"{ms:7.2f} MS", 100, y, tint=(0.6, 1, 0.6, 0.9))
        frac = min(secs / total, 1.0)
        x0 = 170
        image[y:y + 6, x0:x0 + int(barw * frac), 1] = 200
        image[y:y + 6, x0:x0 + int(barw * frac), 0] = 80
        y += 9
        if y > image.shape[0] - 20:
            break

    for name, (used, cap) in list(log.gauges.items())[:8]:
        draw_text(image, font, f"{name[:14]}", 8, y, tint=(0.8, 0.8, 1, 0.9))
        draw_text(image, font, f"{used}/{cap}", 100, y, tint=(0.8, 0.8, 1, 0.9))
        y += 9

    # live-tunable value menu, the selected entry highlighted (adjust
    # with debug_menu_adjust)
    sel = getattr(log, "menu_selection", 0)
    for i, (name, value) in enumerate(list(log.menu_values.items())[:10]):
        tint = (1, 0.8, 0.2, 1) if i == sel else (0.7, 0.7, 0.7, 0.9)
        draw_text(image, font, f"{name[:16]}", 8, y, tint=tint)
        draw_text(image, font, f"{value:.4g}", 120, y, tint=tint)
        y += 9
    return image


def debug_menu_adjust(direction=0, delta=0.0, log=None):
    """Navigate and edit the live value menu: direction moves the
    selection (up/down), delta adds delta * |value| to the selected
    value (delta where it is 0); returns the selected name."""
    log = log or g_debuglog
    names = list(log.menu_values.keys())
    if not names:
        return None
    sel = getattr(log, "menu_selection", 0)
    sel = int(np.clip(sel + direction, 0, len(names) - 1))
    log.menu_selection = sel
    if delta:
        name = names[sel]
        v = log.menu_values[name]
        log.menu_values[name] = v + delta * (abs(v) if v else 1.0)
    return names[sel]
