"""Box environment probes in the port against the JAX package (CPU).

ops/envprobe.py (the slab test, the deferred lighting's per-pixel
override and the megakernel's reduced-resolution fields),
RenderContext.add_environment's tables and K2's plain version with the
`edm` override group, each fed the same inputs made with numpy.
Tolerances: the probe functions and the probe tables atol 2e-5 / rtol
1e-4 (the mips and quad tables atol 1e-5: both packages prefilter the
same cubemap in f32); K2 as tests/test_torch_shade.py holds it — 99.98%
of values within atol 2e-5 / rtol 1e-4, the rest (specular peaks, where
XLA's CPU rsqrt differs by an ulp) within rtol 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_shade as shade_t
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)
from datum_tpu.ops import envprobe as jenv
from datum_tpu.ops.common import FrameConfig as JaxFrameConfig
from datum_tpu.ops.sampling import flatten_cube_mips_quad as jflatq
from datum_tpu.ops.shade_pallas import shade_deferred_pallas
from datum_tpu.render.context import RenderContext as JaxRenderContext
from datum_tpu.render.envmap import EnvMap as JaxEnvMap

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops import envprobe
from datum_tpu_torch.ops.common import FrameConfig
from datum_tpu_torch.ops.shade_cuda import BF16_NAMES, shade_deferred, shade_inputs
from datum_tpu_torch.render.context import RenderContext
from datum_tpu_torch.render.envmap import EnvMap

TOL = dict(atol=2e-5, rtol=1e-4)


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _envs(count=2, sizes=(8, 4, 2)):
    """Two overlapping boxes (the second rotated) with random mip chains:
    numpy tables of the JAX package's layout, flatqs included."""
    rng = np.random.RandomState(5)
    c, s = np.cos(0.4), np.sin(0.4)
    rot = np.float32([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    mips = [rng.uniform(0.0, 3.0, (2, 6, n, n, 3)).astype(np.float32) for n in sizes]
    envs = dict(position=np.float32([[0.0, 1.0, 0.0], [1.0, 1.5, 0.5]]),
                inv_rot=np.stack([np.eye(3, dtype=np.float32), rot.T]),
                halfdim=np.float32([[2.0, 1.5, 2.0], [1.5, 2.0, 1.0]]),
                mips=mips, count=np.int32(count))
    envs["flatqs"] = [jax.tree.map(np.asarray, jflatq([jnp.asarray(m[i]) for m in mips]))
                      for i in range(2)]
    return envs


def _rays(n=32):
    """World positions in and around the boxes, bent specular and diffuse
    directions, roughness: (n, n, 3) x 3 and (n, n)."""
    rng = np.random.RandomState(9)
    wp = rng.uniform([-3, -1, -3], [3, 4, 3], (n, n, 3)).astype(np.float32)
    sdir = _unit(rng.normal(size=(n, n, 3))) * np.float32(rng.uniform(0.6, 1.0, (n, n, 1)))
    ddir = _unit(rng.normal(size=(n, n, 3))) * np.float32(rng.uniform(0.6, 1.0, (n, n, 1)))
    rough = rng.uniform(0.0, 1.0, (n, n)).astype(np.float32)
    return wp, sdir.astype(np.float32), ddir.astype(np.float32), rough


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_ray_box_exit_matches():
    """The slab test, with direction components at and below the 1e-8
    guard."""
    rng = np.random.RandomState(2)
    o = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d[:8, 0] = 0.0
    d[8:16, 1] = -1e-9
    d[16:24, 2] = 3e-9
    h = np.float32([1.0, 2.0, 0.5])
    a = jenv.ray_box_exit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(h))
    b = envprobe.ray_box_exit(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(h))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL)


@pytest.mark.parametrize("count", [2, 1])
def test_env_probe_lookup_matches(count):
    """The deferred lighting's per-pixel override: the earliest box wins
    where two overlap, and a box at or past the count is skipped."""
    envs = _envs(count)
    wp, sdir, ddir, rough = _rays()
    rng = np.random.RandomState(4)
    spec0 = rng.uniform(0, 1, wp.shape).astype(np.float32)
    dif0 = rng.uniform(0, 1, wp.shape).astype(np.float32)
    args = (wp, sdir, ddir, rough)
    a = jenv.env_probe_lookup(*map(jnp.asarray, args), _j(envs), jnp.asarray(spec0),
                              jnp.asarray(dif0))
    tenvs = to_torch(envs, "cpu")
    b = envprobe.env_probe_lookup(*map(torch.from_numpy, args), tenvs,
                                  torch.from_numpy(spec0), torch.from_numpy(dif0))
    hit = np.any(np.asarray(a[0]) != spec0, -1)
    assert 0.1 < hit.mean() < 0.9, hit.mean()
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL)


@pytest.mark.parametrize("count", [2, 1])
def test_env_probe_fields_match(count):
    """The megakernel branch's fields from the per-probe quad tables:
    specular, diffuse and the hit mask."""
    envs = _envs(count)
    args = _rays()
    a = jenv.env_probe_fields(*map(jnp.asarray, args), _j(envs))
    b = envprobe.env_probe_fields(*map(torch.from_numpy, args), to_torch(envs, "cpu"))
    assert 0.1 < float(np.asarray(a[2]).mean()) < 0.9
    np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL)


def test_add_environment_state_matches_jax():
    """add_environment's tables (one cubemap prefiltered at levels=4, a
    rotated box and an axis-aligned one) equal the JAX package's
    device_state()["ibl"]["envprobes"]."""
    rng = np.random.RandomState(6)
    sky = [rng.uniform(0, 1, (6, n, n, 3)).astype(np.float32) for n in (16, 8, 4)]
    cubes = [rng.uniform(0, 2, (6, 16, 16, 3)).astype(np.float32) for _ in range(2)]
    quat = [0.9238795, 0.0, 0.3826834, 0.0]
    jctx = JaxRenderContext(JaxFrameConfig(width=64, height=32))
    tctx = RenderContext(FrameConfig(width=64, height=32), device="cpu")
    jctx.set_skybox(JaxEnvMap(sky))
    tctx.set_skybox(EnvMap(sky))
    for ctx in (jctx, tctx):
        ctx.add_environment([0, 1, 0], [3, 2, 3], cubes[0], levels=4)
        ctx.add_environment([1, 2, 0], [1, 1, 2], cubes[1], rotation=quat, levels=4)
    a = to_torch(jax.tree.map(np.asarray, jctx.device_state()["ibl"]["envprobes"]), "cpu")
    b = tctx.device_state("cpu")["ibl"]["envprobes"]
    assert int(b["count"]) == int(a["count"]) == 2
    for k in ("position", "inv_rot", "halfdim"):
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-6)
    assert len(b["mips"]) == len(a["mips"]) == 3
    for x, y in zip(a["mips"], b["mips"]):
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-5)
    for ta, tb in zip(a["flatqs"], b["flatqs"]):
        np.testing.assert_allclose(tb[0].numpy(), ta[0].numpy(), atol=1e-5)
        for x, y in zip(ta[1:], tb[1:]):
            np.testing.assert_array_equal(y.numpy(), x.numpy())


def _edm_planes():
    """The edr/edg/edb/edm planes: edm spans 0..1 with a band of values
    that round to exactly 0.5 in bf16 (which keep the SH-9 term) and a
    band just above it."""
    H, W = shade_t.H, shade_t.W
    rng = np.random.RandomState(13)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    edm = (xx / (W - 1)).astype(np.float32)
    edm[:, 100:110] = np.float32(0.5)
    edm[:, 110:120] = np.float32(0.5 + 2.0 ** -10)        # bf16 rounds it to 0.5
    edm[:, 120:130] = np.float32(0.5 + 2.0 ** -7)         # the next bf16 value up
    return dict(edr=rng.uniform(0, 2, (H, W)).astype(np.float32),
                edg=rng.uniform(0, 2, (H, W)).astype(np.float32),
                edb=rng.uniform(0, 2, (H, W)).astype(np.float32), edm=edm)


@pytest.mark.parametrize("probes", [False, True])
def test_k2_edm_group_matches_pallas(probes):
    """K2's plain version with the edm group against the JAX kernel in
    interpret mode (with SH probes, the override precedes their blend);
    the values that round to 0.5 keep the SH-9 diffuse, the next bf16
    value takes the probe's."""
    ss, g = shade_t._scene(probes=probes), dict(shade_t._gplanes(), **_edm_planes())
    kw = dict(proj=jnp.asarray(ss["proj"]), invview=jnp.asarray(ss["invview"]),
              interpret=True)
    a = np.asarray(shade_deferred_pallas(shade_t._jax_tree(g), shade_t._jax_tree(ss),
                                         **kw))
    tss = shade_t._torch_tree(ss)
    tg = shade_t._torch_tree(g)
    inp = shade_inputs(tg, tss, proj=tss["proj"], invview=tss["invview"])
    assert inp["envd"] and inp["planes"].shape[0] == len(BF16_NAMES) + 3 + 4
    b = shade_deferred(tg, tss, proj=tss["proj"], invview=tss["invview"]).numpy()
    assert b.shape == a.shape and np.isfinite(b).all()
    close = np.isclose(b, a, atol=2e-5, rtol=1e-4)
    assert close.mean() >= 0.9998, (~close).sum()
    np.testing.assert_allclose(b, a, atol=2e-5, rtol=5e-3)
    g0 = {k: v for k, v in g.items() if not k.startswith("ed")}
    base = shade_deferred(shade_t._torch_tree(g0), tss, proj=tss["proj"],
                          invview=tss["invview"]).numpy()
    cov = g["visf"] >= 0
    moved = np.abs(b - base).max(-1) > 0
    assert not moved[:, 100:120][cov[:, 100:120]].any()
    assert moved[:, 120:130][cov[:, 120:130]].all()
    assert not moved[:, :100][cov[:, :100]].any()
