"""Whether the window's frames are right: the program's outputs against
the plain reference's (plainframe) on the same inputs.

The reference rebuilds the scene (meshes, materials, textures, the sky
bake and the IBL) from the configuration itself and renders each
compared frame from its time t.  The compared frames are two kinds:

- the chain: the set-up's warm frames and the window's first frame, in
  order.  The reference renders them with its own SSAO history, from
  none at the run's first frame, so the program's history is checked
  through every step up to a timed frame;
- the sample: frames drawn from the window by the seed.  Rendering the
  hundreds of frames before each would take the reference minutes, so
  there it takes the program's `prev`, the history that the program's
  previous frame left, and follows the program one frame at a time.

Each frame's own history out (ao_prev) is compared too.

The numbers, each the worst over the compared frames: image_rmse and
image_max (the u8 image, in levels), depth_max (the reverse-Z depth),
vis_mismatch (the share of pixels whose triangle id differs), lum_rel
(the luminance's relative gap), ao_max (the history's AO channel) and
overflow_diff (main-bin entries dropped, program against reference).
"""

from __future__ import annotations

import contextlib
import math

import torch

OUTPUTS = ("image", "depth", "vis", "luminance", "bin_overflow")


def to_host(out):
    """The compared outputs of one frame, on the host."""
    host = {k: out[k].detach().cpu() for k in OUTPUTS}
    if out.get("ao_prev") is not None:
        host["ao"] = out["ao_prev"]["ao"].detach().cpu()
    return host


def prev_to_host(prev):
    return None if prev is None else {k: v.detach().cpu() for k, v in prev.items()}


def compare(prog, ref):
    """The numbers of one frame (module docstring)."""
    d = prog["image"].double() - ref["image"].double()
    lum_p, lum_r = float(prog["luminance"]), float(ref["luminance"])
    out = dict(
        image_rmse=math.sqrt(float((d * d).mean())),
        image_max=float(d.abs().max()),
        depth_max=float((prog["depth"].double() - ref["depth"].double()).abs().max()),
        vis_mismatch=float((prog["vis"] != ref["vis"]).double().mean()),
        lum_rel=abs(lum_p - lum_r) / max(abs(lum_r), 1e-30),
        overflow_diff=float(abs(int(prog["bin_overflow"]) - int(ref["bin_overflow"]))))
    if "ao" in ref:
        out["ao_max"] = (float((prog["ao"][..., 0].double() - ref["ao"][..., 0].double())
                               .abs().max()) if "ao" in prog else math.inf)
    return out


def worst(readings):
    """Each number's largest reading over frames (NaN counts as inf)."""
    keys = {k for r in readings for k in r}
    return {k: max((math.inf if math.isnan(r[k]) else r[k]) for r in readings if k in r)
            for k in sorted(keys)}


def judge(numbers, limits):
    """(correct, {name: {value, limit}}) over the numbers that have a
    limit; a number the frames did not give counts as failed."""
    compared = {k: dict(value=numbers.get(k, math.inf), limit=float(v))
                for k, v in sorted(limits.items())}
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return ok, compared


@contextlib.contextmanager
def matmul_precision(tf32):
    """TF32 matmuls on (the control) or off (the frame's contract)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def render_reference(scene, state, draws, ss, device, prev, tf32=False):
    """The plain reference's frame; with tf32 the control: the same frame
    with its matmuls in TF32, the precision below the configuration's."""
    from plainframe.convert import to_torch
    from plainframe.render import frame as plain

    with matmul_precision(tf32), torch.no_grad():
        return plain._frame(scene.cfg, state, to_torch(draws, device),
                            to_torch(ss, device),
                            None if prev is None else to_torch(prev, device))


class Reference:
    """The plain reference's scene for one cell, built on `device`."""

    def __init__(self, cell, device):
        from . import loop

        self.side = loop.reference_side()
        self.scene = loop.build_scene(self.side, cell.config, cell.traffic, device)
        self.state = self.scene.ctx.device_state(device)
        self.device = device

    def frame(self, t, prev, tf32=False):
        """(the frame at t on the host, its history out on the device)."""
        draws, ss = self.scene.inputs(self.side, t)
        out = render_reference(self.scene, self.state, draws, ss, self.device, prev, tf32)
        return to_host(out), out.get("ao_prev")


def reference_frames(reference, chain, sample, tf32=False):
    """The reference's outputs of the compared frames, in order: the
    chain's (t, ...) with its own history from none, then the sample's
    (t, outputs, prev) each from the program's prev."""
    prev = None
    for t, *_ in chain:
        out, prev = reference.frame(t, prev, tf32)
        yield out
    del prev
    for t, _, p in sample:
        yield reference.frame(t, p, tf32)[0]


def readings(reference, chain, sample, tf32=False):
    """compare() of each compared frame of the program (the chain's (t,
    outputs), the sample's (t, outputs, prev)) against the reference."""
    programs = [c[1] for c in chain] + [c[1] for c in sample]
    return [compare(prog, ref) for prog, ref in
            zip(programs, reference_frames(reference, chain, sample, tf32))]
