"""Offline profile-timeline viewer (counterpart of
datum_tpu/tools/debugviewer.py): the debug ring's binary dump
(debug.stream_debuglog) as a self-contained HTML/SVG timeline, one lane
per nesting depth, one strip per frame, the device passes below, and a
table of each block's mean time a frame.

    python -m datum_tpu_torch.tools.debugviewer dump.gltd [out.html]

A block's colour is picked by hash(name), as the JAX tool picks it:
Python salts str hashes per process (PYTHONHASHSEED), so the colours,
and the HTML, differ from run to run unless the seed is fixed.
"""

from __future__ import annotations

import html
import sys

from ..debug.debug import ENTRY_BEGIN, ENTRY_END, ENTRY_FRAME, ENTRY_GPU, load_debuglog

_PALETTE = ["#4c8fd6", "#d6874c", "#67bf6b", "#c95f5f", "#9b6fd6",
            "#c9b14f", "#55b8b2", "#d66fa8", "#8a8f4a", "#6f86d6"]


def _color(name):
    return _PALETTE[hash(name) % len(_PALETTE)]


def build_spans(events):
    """Pair BEGIN/END into (frame, name, t0, t1, depth) spans; GPU entries
    become (frame, name, seconds) items.  Returns (spans, gpu, each
    frame's first marker time)."""
    spans, gpu, stack = [], [], []
    frame = 0
    frame_t0 = {}
    for e in events:
        if e["kind"] == ENTRY_FRAME:
            frame = e["frame"]
            frame_t0.setdefault(frame, e["time"])
            stack = []
        elif e["kind"] == ENTRY_BEGIN:
            stack.append((e["name"], e["time"]))
        elif e["kind"] == ENTRY_END:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == e["name"]:
                    spans.append((e["frame"], e["name"], stack[i][1], e["time"], i))
                    del stack[i:]
                    break
        elif e["kind"] == ENTRY_GPU:
            gpu.append((e["frame"], e["name"], e["extra"]))
    return spans, gpu, frame_t0


def render_html(events, title="datum_tpu profile"):
    """The timeline page of load_debuglog's events."""
    spans, gpu, frame_t0 = build_spans(events)
    if not spans and not gpu:
        return f"<html><body><h2>{html.escape(title)}: empty log</h2></body></html>"

    frames = sorted({s[0] for s in spans} | {g[0] for g in gpu})
    lane_h, strip_h, width = 16, 90, 1100
    rows = []
    summary = {}
    for fi, fr in enumerate(frames):
        fspans = [s for s in spans if s[0] == fr]
        t0 = min((s[2] for s in fspans), default=frame_t0.get(fr, 0.0))
        t1 = max((s[3] for s in fspans), default=t0 + 1e-3)
        dur = max(t1 - t0, 1e-6)
        y0 = fi * strip_h
        rows.append(f'<text x="4" y="{y0 + 12}" class="lbl">frame {fr}'
                    f' — {dur * 1e3:.2f} ms</text>')
        for _, name, b, e, depth in fspans:
            x = 120 + (b - t0) / dur * (width - 130)
            w = max((e - b) / dur * (width - 130), 1.0)
            y = y0 + 16 + depth * lane_h
            summary[name] = summary.get(name, 0.0) + (e - b)
            rows.append(
                f'<rect x="{x:.1f}" y="{y}" width="{w:.1f}" height="{lane_h - 2}"'
                f' fill="{_color(name)}"><title>{html.escape(name)}: '
                f'{(e - b) * 1e3:.3f} ms</title></rect>')
            if w > 40:
                rows.append(f'<text x="{x + 3:.1f}" y="{y + 11}" class="bar">'
                            f'{html.escape(name)}</text>')
        gx = 120
        for _, name, d in [g for g in gpu if g[0] == fr]:
            w = max(d / dur * (width - 130), 1.0)
            y = y0 + strip_h - lane_h - 2
            summary[name] = summary.get(name, 0.0) + d
            rows.append(
                f'<rect x="{gx:.1f}" y="{y}" width="{w:.1f}" height="{lane_h - 2}"'
                f' fill="#777" stroke="#333"><title>gpu {html.escape(name)}: '
                f'{d * 1e3:.3f} ms</title></rect>')
            gx += w
    height = len(frames) * strip_h + 20

    table = "".join(
        f"<tr><td>{html.escape(k)}</td><td>{v * 1e3 / max(len(frames), 1):.3f}</td></tr>"
        for k, v in sorted(summary.items(), key=lambda kv: -kv[1]))
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(title)}</title><style>
body {{ font: 13px sans-serif; background: #1b1d21; color: #ddd }}
.lbl {{ font: 11px sans-serif; fill: #ccc }}
.bar {{ font: 10px sans-serif; fill: #111 }}
table {{ border-collapse: collapse }} td {{ border: 1px solid #444; padding: 2px 8px }}
</style></head><body><h2>{html.escape(title)}</h2>
<svg width="{width}" height="{height}">{''.join(rows)}</svg>
<h3>mean per-frame (ms)</h3><table><tr><th>block</th><th>ms</th></tr>{table}</table>
</body></html>"""


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print(__doc__)
        return 1
    events = load_debuglog(argv[0])
    out = argv[1] if len(argv) > 1 else argv[0] + ".html"
    with open(out, "w") as f:
        f.write(render_html(events, title=argv[0]))
    print(f"wrote {out} ({len(events)} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
