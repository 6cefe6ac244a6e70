"""The local-environment frame in the port against the JAX package's
frame (CPU): tests/test_fastpath_features.py's probe scene (a red box
environment probe around a metallic sphere on a metallic floor, under a
flat grey skybox) with two SH probes pushed from the host, at 256x128,
on the megakernel branch (the probe fields at quarter resolution, K2's
edm group) and on the deferred branch (use_shade_kernel=False: K1, the
gbuffer and the XLA lighting's per-pixel probe lookup).

One state (the JAX package's, through convert.to_torch) and one
sceneset go through both frames.  Tolerances: u8 image RMSE <= 2/255
and mean |d| <= 0.5 levels, vis equal on >= 99.9% of pixels, luminance
within rel 1e-4.  The port's frame must differ from its frame without
the probe and redden the sphere, as test_env_probe_tints_fast_path
requires of the JAX frame.
"""

import jax
import numpy as np
import pytest
import torch

from test_fastpath_features import _base_cfg, _probe_scene
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)
from datum_tpu.render import RenderContext as JaxRenderContext
from datum_tpu.render import frame as jax_frame
from datum_tpu.render.types import make_sceneset as jax_make_sceneset

from datum_tpu_torch.ops import shade_cuda
from datum_tpu_torch.ops.shade_cuda import shade_deferred_cuda, shade_deferred_envd
from datum_tpu_torch.render.frame import attach_host_expansion, render_frame
from datum_tpu_torch.render.renderlist import RenderList
from datum_tpu_torch.render.types import make_sceneset

# two SH probes (position, radius, 9x3 coefficients): a warm one by the
# sphere and a cool one over the floor
_RNG = np.random.RandomState(21)


def _sh(dc):
    sh = _RNG.uniform(0.0, 0.3, (9, 3)).astype(np.float32)
    sh[0] += np.float32(dc)
    return sh


SH_PROBES = [dict(position=[0.5, 1.0, 1.0], radius=3.0, sh=_sh([0.9, 0.5, 0.2])),
             dict(position=[-2.0, 0.2, 0.0], radius=4.0, sh=_sh([0.2, 0.4, 0.9]))]


def _inputs(use_shade_kernel, with_probe=True):
    """(cfg, numpy state, draws, sceneset) of the probe scene from the JAX
    package's host side, SH probes pushed."""
    cfg = _base_cfg(use_shade_kernel=use_shade_kernel)
    ctx = JaxRenderContext(cfg)
    cam, params, rl = _probe_scene(with_probe)(ctx)
    for p in SH_PROBES:
        rl.push_probe(p["position"], p["sh"], radius=p["radius"])
    ss = jax_make_sceneset(cam, params, point_lights=rl.point_lights,
                           spot_lights=rl.spot_lights, probes=rl.probes)
    draws = rl.draw_arrays(cfg.max_instances, ctx.default_material)
    ctx.expand_host(draws)
    return cfg, ctx, draws, ss


def _port(cfg, ctx, draws, ss):
    pdraws = dict(draws)
    attach_host_expansion(ctx.pool, pdraws, cfg.max_vertices, cfg.max_triangles,
                          cfg.max_translucent_tris)
    state = jax.tree.map(np.asarray, ctx.device_state())
    return render_frame(cfg, state, pdraws, ss, device="cpu")


@pytest.mark.parametrize("use_shade_kernel", [True, False], ids=["megakernel", "deferred"])
def test_probe_frame_matches_jax_frame(use_shade_kernel, monkeypatch):
    """On the megakernel branch K2's plain version runs once with the edm
    group (no kernel launches on the CPU); on the deferred branch not at
    all."""
    cfg, ctx, draws, ss = _inputs(use_shade_kernel)
    assert int(ss["probes"]["count"]) == 2
    assert "envprobes" in ctx.device_state()["ibl"]
    ref = jax.tree.map(np.asarray, jax_frame.render_frame(cfg, ctx.device_state(), draws, ss))
    calls = []
    plain = shade_cuda.shade_deferred_reference
    monkeypatch.setattr(shade_cuda, "shade_deferred_reference",
                        lambda **kw: calls.append(kw["envd"]) or plain(**kw))
    n_k2 = shade_deferred_cuda.launches, shade_deferred_envd.launches
    out = _port(cfg, ctx, draws, ss)
    assert (shade_deferred_cuda.launches, shade_deferred_envd.launches) == n_k2
    assert calls == ([True] if use_shade_kernel else [])
    a = ref["image"].astype(np.float32)
    b = out["image"].numpy().astype(np.float32)
    assert b.shape == (128, 256, 3) and b.mean() > 10
    assert np.abs(a - b).mean() <= 0.5
    assert np.sqrt(((a - b) ** 2).mean()) <= 2.0
    lum_a, lum_b = float(ref["luminance"]), float(out["luminance"])
    assert abs(lum_b - lum_a) <= 1e-4 * abs(lum_a), (lum_a, lum_b)
    assert (ref["vis"] == out["vis"].numpy()).mean() >= 0.999


@pytest.mark.parametrize("use_shade_kernel", [True, False], ids=["megakernel", "deferred"])
def test_probe_tints_the_port_frame(use_shade_kernel):
    """The red box probe moves the frame and reddens the metallic sphere
    (test_env_probe_tints_fast_path's checks, on the port's frame)."""
    imgs = [_port(*_inputs(use_shade_kernel, with_probe=w))["image"].numpy()
            .astype(np.float32) / 255.0 for w in (True, False)]
    with_p, without = imgs
    d = np.abs(with_p - without)
    assert d.mean() > 0.01, d.mean()
    ball, ball0 = with_p[30:80, 100:156], without[30:80, 100:156]
    assert (ball[..., 0].mean() - ball[..., 2].mean()
            > ball0[..., 0].mean() - ball0[..., 2].mean() + 0.02)


def test_sceneset_probes_match_jax():
    """RenderList.push_probe and make_sceneset(probes=, n_probe=) pack the
    JAX package's probe table (exact); past n_probe probes are dropped."""
    from datum_tpu.render.renderlist import RenderList as JaxRenderList
    from datum_tpu.render.camera import Camera as JaxCamera
    from datum_tpu.render.types import RenderParams as JaxRenderParams

    from datum_tpu_torch.render.camera import Camera
    from datum_tpu_torch.render.types import RenderParams

    jrl, trl = JaxRenderList(), RenderList()
    for rl in (jrl, trl):
        for p in SH_PROBES * 2:
            rl.push_probe(p["position"], p["sh"], radius=p["radius"])
        rl.push_probe([1, 2, 3], np.ones((9, 3), np.float32))
    prev = np.eye(4, dtype=np.float32) * 2
    for n in (8, 3):
        a = jax_make_sceneset(JaxCamera(), JaxRenderParams(), probes=jrl.probes,
                              n_probe=n, prevview=prev)
        b = make_sceneset(Camera(), RenderParams(), probes=trl.probes, n_probe=n,
                          prevview=prev)
        for k in ("position", "sh", "count"):
            np.testing.assert_array_equal(b["probes"][k], a["probes"][k])
        np.testing.assert_array_equal(b["prevview"], a["prevview"])
        assert int(b["probes"]["count"]) == min(5, n)
