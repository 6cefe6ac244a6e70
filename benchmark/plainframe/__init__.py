"""A frozen copy of datum_tpu_torch's frame path in plain PyTorch: the
benchmark's reference.

The modules are the port's, copied at the commit that added the
benchmark, with their relative imports kept inside this package and every
kernel dispatch pointed at the kernel's plain PyTorch version, on every
device: the reference launches no hand-written kernel, holds no launch
code and imports nothing of datum_tpu_torch, datum_tpu or jax.  Entry
points: scenes.datumtest_scene builds the scene, render.frame.render_frame
renders one frame.
"""
