"""On the card (marker cuda), for each cell this deployment added: the
program's frames stay inside the cell's limits, and the control (the
reference with its matmuls in TF32) breaks one of them, or, where the
control breaks none, each planted fault does: the calibration's readings
on one seed at the cell's own size and load (a 2 s window).
python -m pytest -m cuda benchmark/tests"""

import pytest
import torch

from framebench import check, faults, loop, runner, spec

SEED = 2**31 + 199


def _readings(cell, card, reference, side=None, tf32=False):
    """(the program's numbers, the control's or None) on one seed."""
    fl, rng = runner.program_loop(cell, card, SEED, side)
    chain = runner.warm(fl, cell.traffic)
    sample, first, _, _ = runner.window(fl, cell.traffic, 2.0, rng)
    chain, sampled = runner.compared_frames(fl, chain, first, sample)
    del fl, first, sample
    refs = list(check.reference_frames(reference, chain, sampled))
    prog = check.worst([check.compare(f[1], r) for f, r in zip(chain + sampled, refs)])
    ctl = None
    if tf32:
        ctl = check.worst([check.compare(c, r) for c, r in zip(
            check.reference_frames(reference, chain, sampled, tf32=True), refs)])
    return prog, ctl


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["datumtest-deferred-1080p", "datumtest-1080p"])
def test_program_passes_and_the_control_or_the_faults_fail(card, name):
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(name)
    reference = check.Reference(cell, card)
    prog, ctl = _readings(cell, card, reference, tf32=True)
    assert check.judge(prog, cell.limits)[0], prog
    if check.judge(ctl, cell.limits)[0]:
        for fault in sorted(faults.FAULTS):
            side = faults.broken_side(loop.program_side(), faults.FAULTS[fault])
            broken, _ = _readings(cell, card, reference, side)
            assert not check.judge(broken, cell.limits)[0], (fault, broken)
