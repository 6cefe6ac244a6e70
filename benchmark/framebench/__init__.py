"""The frame benchmark of datum_tpu_torch (the PyTorch and CUDA port).

spec: BENCHMARK.json and the files it names by name (a configuration's
sizes, a traffic mix's parameters, a cell's limits, a per-layer metric's
reader).  loop: the closed 60 Hz frame loop.  trace: one torch.profiler
window read into device intervals, launches and host spans.  roofline:
the operations and bytes of K1 and K2 and the card's peaks.  check: the
comparison of the window's frames with the plain reference (plainframe).
runner: one run of one cell, ending in the result line.  guard: the
modules no run may hold.
"""
