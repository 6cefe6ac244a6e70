#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,... \
        [--control-seeds 3,4,5] [--fault stale|half_batch|altered] \
        [--seconds S] --out FILE

For each seed, a run's own steps at the cell's size and load: a loop
from the seed's t0, its warm frames and a window of --seconds with the
run's chain and sample of frames, then each compared number of the
program's frames against the plain reference (the lower readings).  For
each control seed also the control's numbers: the reference itself, put
in the program's place with its matmuls in TF32, the precision below the
configuration's f32 (carrying its own history along the chain), against
the reference (the upper readings).  With --fault the program runs with
that fault (framebench/faults.py) planted under its render_frame, and
its readings are the fault's.  The program's scene and the reference's
are built once.  Writes one JSON object to FILE; needs a CUDA device.
"""

import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
os.environ["TRITON_CACHE_DIR"] = str(HERE.parent / ".bench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE.parent / ".bench_cache" / "torch_extensions")
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv):
    import argparse

    import torch

    from framebench import check, faults, loop, runner, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    side = loop.program_side()
    if args.fault:
        side = faults.broken_side(side, faults.FAULTS[args.fault])
    scene = loop.build_scene(side, cell.config, cell.traffic, device)
    state = scene.ctx.device_state(device)
    reference = check.Reference(cell, device)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = dict(workload=cell.name, kind=torch.cuda.get_device_name(device),
               fault=args.fault, seeds=[])
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        fl, rng = runner.program_loop(cell, device, seed, side, scene, state)
        chain = runner.warm(fl, cell.traffic)
        sample, first, events, _ = runner.window(fl, cell.traffic, args.seconds, rng)
        chain, sampled = runner.compared_frames(fl, chain, first, sample)
        del fl, first, sample, events
        frames = chain + sampled
        refs = list(check.reference_frames(reference, chain, sampled))
        prog = [check.compare(f[1], r) for f, r in zip(frames, refs)]
        row = dict(seed=seed, chain_t=[f[0] for f in chain], sample_t=[f[0] for f in sampled],
                   program=check.worst(prog), program_by_frame=prog,
                   overflow=[int(f[1]["bin_overflow"]) for f in frames])
        if seed in control:
            ctl = [check.compare(c, r) for c, r in zip(
                check.reference_frames(reference, chain, sampled, tf32=True), refs)]
            row["control"] = check.worst(ctl)
        out["seeds"].append(row)
        print(json.dumps(row), f"({time.perf_counter() - t:.1f} s)", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
