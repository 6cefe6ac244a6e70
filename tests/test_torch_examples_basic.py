"""The pack-free example apps on the port against their goldens (CPU):
each example module runs through its harness (main with --cpu --frames 3
--width 320 --height 160, datum_tpu/tools/update_goldens.py's config)
and its saved frame is held to tests/golden/<name>.png at RMSE < 2/255.
The goldens are the JAX package's frames.  This file: triangle,
material and skybox (ocean's golden is held in test_torch_ocean.py
through the example module; stardust and datumtest in
test_torch_examples_particles.py; asteroids in
test_torch_examples_asteroids.py).

Measured RMSE on this CPU: triangle 0, material 0.00710 (the JAX
package's own frame is 0.00710 from this golden too: the port's frame is
within 4.8e-5 of it), skybox 0.00119 (the re-bake every 8th step)."""

import importlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = Path(__file__).parent / "golden"
GOLDEN_ARGS = ["--cpu", "--frames", "3", "--width", "320", "--height", "160"]


def rmse(a, b):
    return float(np.sqrt(np.mean((a / 255.0 - b / 255.0) ** 2)))


def run_example(name, tmp_path):
    """The port's example `name` through its harness at the golden's
    config: (its state, its saved frame as float32, the golden)."""
    mod = importlib.import_module(f"datum_tpu_torch.examples.{name}")
    out = tmp_path / f"{name}.png"
    state = mod.main(GOLDEN_ARGS + ["--out", str(out)])
    img = np.asarray(Image.open(out).convert("RGB")).astype(np.float32)
    gold = np.asarray(Image.open(GOLDEN / f"{name}.png").convert("RGB")).astype(np.float32)
    assert img.shape == gold.shape == (160, 320, 3)
    return state, img, gold


@pytest.mark.parametrize("name", ["triangle", "material", "skybox"])
def test_example_matches_golden(name, tmp_path):
    state, img, gold = run_example(name, tmp_path)
    assert state["ctx"].device.type == "cpu"
    assert rmse(img, gold) < 2 / 255, rmse(img, gold)


def test_skybox_rebakes_on_the_schedule(monkeypatch):
    """The skybox example re-bakes where int(t * 60) % 8 == 0 with t a
    Python float summed from 1/60 steps, as the JAX example does: at
    steps 8 and 16 of 24 (the sum reaches 23.999... at step 24), each on
    the context's device, and the context keeps the re-baked sky.  (The
    golden's 3 steps re-bake nothing.)"""
    import types

    from datum_tpu_torch.examples import skybox
    from datum_tpu_torch.render import skybox as sky_mod

    calls = []
    orig = sky_mod.render_skybox

    def counted(sb, params=None, device="cuda"):
        calls.append((round(state["t"] * 60), str(device)))
        return orig(sb, params, device=device)

    monkeypatch.setattr(sky_mod, "render_skybox", counted)
    state = skybox.init(types.SimpleNamespace(width=32, height=16, device="cpu"))
    want, t = [], 0.0
    for i in range(24):
        t += 1 / 60
        if int(t * 60) % 8 == 0:
            want.append((round(t * 60), "cpu"))
        skybox.update(state, 1 / 60)
    assert isinstance(state["t"], float) and state["t"] == t
    assert calls == want and len(calls) >= 2
    assert state["ctx"].skybox is state["skybox"]
