#!/usr/bin/env python3
"""The frame benchmark of datum_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cell's CUDA
devices; prints the result as the last line of its standard output and
the compared numbers beside their limits as the last lines of its
standard error.  Exits non-zero, printing no result, without the devices
or when jax, jaxlib, flax or datum_tpu is loaded.  Kernel caches stay in
fixed directories of the checkout: the port's nvcc build in
datum_tpu_torch/_build/, Triton's and torch's extension caches in
.bench_cache/.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
sys.path[:0] = [str(HERE), str(ROOT)]

from framebench import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T_START))
