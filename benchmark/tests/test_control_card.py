"""On the card (marker cuda): the cell's program frames stay inside its
limits and the control, the reference with its matmuls in TF32, breaks
one of them: the calibration's readings on one seed, at the cell's own
size and load (a 2 s window).  python -m pytest -m cuda benchmark/tests"""

import pytest
import torch

from framebench import check, runner, spec


@pytest.mark.cuda
def test_control_fails_and_program_passes(card):
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell("datumtest-2160p")
    fl, rng = runner.program_loop(cell, card, 2**31 + 99)
    chain = runner.warm(fl, cell.traffic)
    sample, first, _, _ = runner.window(fl, cell.traffic, 2.0, rng)
    chain, sampled = runner.compared_frames(fl, chain, first, sample)
    del fl, first, sample
    reference = check.Reference(cell, card)
    refs = list(check.reference_frames(reference, chain, sampled))
    frames = chain + sampled
    prog = [check.compare(f[1], r) for f, r in zip(frames, refs)]
    ctl = [check.compare(c, r) for c, r in zip(
        check.reference_frames(reference, chain, sampled, tf32=True), refs)]
    assert check.judge(check.worst(prog), cell.limits)[0]
    assert not check.judge(check.worst(ctl), cell.limits)[0]
