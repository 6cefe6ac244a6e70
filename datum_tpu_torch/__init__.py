"""datum_tpu_torch — the datum_tpu renderer on PyTorch and CUDA (Hopper).

A second package beside the JAX reference `datum_tpu`, with the same
module layout: `render/` holds the host side and the frame graph,
`ops/` the device ops, and every Pallas kernel of the main path becomes
a hand-written CUDA kernel under `csrc/` (built with nvcc at first use,
see ops/_kernels.py).  The package imports torch and numpy, never jax
and nothing of `datum_tpu`: it keeps its own copies of the numpy host
math (`math/`) and of the env-BRDF LUT (`data/envbrdf64.npy`).

Entry points: `scenes.datumtest_scene` builds the scene,
`render.frame.render_frame` renders one frame on a given device,
`render.context.RenderContext.render` draws a render list (its sprites
and text included) on the context's device, `convert.to_torch` moves
numpy state (or the JAX package's state) onto a device, and
`examples/city.py` runs the city example app (`scene/`: the ECS with
frustum and occlusion culling; `debug/`: the profiling ring and its
overlay).  `asset/` reads and writes .pack files (its LZ4 codec is
`csrc/lz4.cpp`, built with g++ at first use), decodes them on worker
threads and uploads them to the card on a CUDA side stream;
`scene/model.py` loads a pack's model into the ECS; `tools/` holds the
pack tools; `packscene.py` writes the packs the tests read from a seed.
"""
