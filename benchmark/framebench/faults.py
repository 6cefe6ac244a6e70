"""Faults planted under the timed path, each of which has to make a run's
`correct` false: the CPU tests plant them in a small run, calibrate.py
(--fault) in a run at a cell's own size on the card.  Each wraps the
program's render_frame."""

from __future__ import annotations


def stale(render):
    """A step that returns its state unchanged: the previous frame again."""
    last = {}

    def broken(cfg, state, draws, ss, *, device, prev=None):
        out = render(cfg, state, draws, ss, device=device, prev=prev)
        out, last["out"] = last.get("out", out), out
        return out
    return broken


def half_batch(render):
    """Half of the batch left out: the second half of the frame's
    opaque triangles collapsed to a point."""
    def broken(cfg, state, draws, ss, *, device, prev=None):
        drop = draws["t_valid"].nonzero()[0]
        drop = drop[len(drop) // 2:]
        tris = draws["tris"].copy()
        tris[drop] = tris[drop, :1]
        draws = dict(draws, tris=tris)
        return render(cfg, state, draws, ss, device=device, prev=prev)
    return broken


def altered(render):
    """An answer altered where it is produced: one 32x128 tile of the
    image inverted."""
    def broken(cfg, state, draws, ss, *, device, prev=None):
        out = render(cfg, state, draws, ss, device=device, prev=prev)
        image = out["image"].clone()
        image[:32, :128] = 255 - image[:32, :128]
        return dict(out, image=image)
    return broken


FAULTS = dict(stale=stale, half_batch=half_batch, altered=altered)


def broken_side(side, fault):
    """The Side `side` with its render_frame broken by `fault`."""
    from .loop import Side

    return Side(side.scenes, side.make_sceneset, fault(side.render_frame))
