"""The asteroids example on the port against tests/golden/asteroids.png
(CPU; the harness of test_torch_examples_basic.py): 96 spinning
icospheres from a 3-level LOD chain whose transforms are computed on the
platform's worker pool.  RMSE < 2/255 (measured 2.2e-5); the pool's
transforms equal the same transforms computed in order."""

import types

import numpy as np

from test_torch_examples_basic import rmse, run_example
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)


def test_asteroids_matches_golden(tmp_path):
    state, img, gold = run_example("asteroids", tmp_path)
    assert rmse(img, gold) < 2 / 255, rmse(img, gold)
    lods = [m.trianglecount for m in state["lods"]]
    assert lods == [1280, 320, 80]


def test_asteroid_transforms_on_the_pool():
    """update() fans 4 chunks of the 96 transforms out to the worker pool
    and joins them; each equals the transform computed on this thread."""
    from datum_tpu_torch.examples import asteroids
    from datum_tpu_torch.math import Transform

    state = asteroids.init(types.SimpleNamespace(width=32, height=16, device="cpu"))
    for _ in range(2):
        asteroids.update(state, 1 / 60)
    t = state["t"]
    for i in range(len(state["centers"])):
        rot = Transform.rotation(state["axes"][i], state["spins"][i] * t)
        m = (Transform.translation(state["centers"][i]) * rot).matrix()[:3, :]
        m[:, :3] *= state["radii"][i]
        np.testing.assert_array_equal(state["transforms"][i], m)
