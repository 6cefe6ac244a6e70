"""The FFT ocean of the port against the JAX package (CPU), and the ocean
example's golden frame through the port.

Tolerances:
- phillips_spectrum, wave_frequencies, water_color_lut and the grid
  mesh: bit-equal (the same numpy);
- ocean_maps: atol 1e-5 of each map's max |value| (torch's and XLA's
  FFTs sum in other orders);
- displace_grid, ocean_lut_uv and Ocean.vertex_data: atol 1e-5, rtol
  1e-5 (the maps' error carried through the bilinear taps);
- the ocean example module at the golden's config (320x160, 3 updates
  of 1/60 s, the deferred default path with no kernel) against
  tests/golden/ocean.png: RMSE < 2/255 and mean |d| <= 0.5 levels.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)
from datum_tpu.ops import ocean as jocean

from datum_tpu_torch.ops import ocean
from datum_tpu_torch.render import primitives

GOLDEN = Path(__file__).parent / "golden" / "ocean.png"
TOL = dict(atol=1e-5, rtol=1e-5)
SPECTRA = [dict(n=64, size=64.0, wind=(9.0, 3.0), amplitude=4e-4, seed=0),
           dict(n=32, size=6.0, wind=(8.0, 4.0), amplitude=2e-3, seed=3),
           dict(n=64, size=16.0, wind=(0.0, 0.0), amplitude=2e-5, seed=1)]


@pytest.mark.parametrize("kw", SPECTRA, ids=["example", "test-scene", "no-wind"])
def test_spectrum_bit_equal(kw):
    a, b = jocean.phillips_spectrum(**kw), ocean.phillips_spectrum(**kw)
    assert a.dtype == b.dtype == np.complex64 and np.array_equal(a, b)
    for x, y in zip(jocean.wave_frequencies(kw["n"], kw["size"]),
                    ocean.wave_frequencies(kw["n"], kw["size"])):
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)


def _maps(kw, t, chop):
    h0 = ocean.phillips_spectrum(**kw)
    f = ocean.wave_frequencies(kw["n"], kw["size"])
    a = jocean.ocean_maps(h0, *f, jnp.float32(t), chop)
    b = ocean.ocean_maps(torch.from_numpy(h0), *(torch.from_numpy(x) for x in f),
                         torch.tensor(t, dtype=torch.float32), chop)
    return [np.asarray(x) for x in a], [y.numpy() for y in b]


@pytest.mark.parametrize("t", [0.0, 1.05, 37.5])
@pytest.mark.parametrize("kw", SPECTRA[:2], ids=["example", "test-scene"])
def test_ocean_maps_match_jax(kw, t):
    a, b = _maps(kw, t, 1.6)
    for x, y in zip(a, b):
        assert y.shape == (kw["n"], kw["n"], 3) and y.dtype == np.float32
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-5 * np.abs(x).max())
    assert np.abs(a[0][..., 1]).max() > 0            # the surface has waves


def _grid(n1=33, size=16.0, shift=(0.0, 0.0)):
    xs = np.linspace(0, size, n1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="xy")
    g = np.stack([gx + shift[0], np.zeros_like(gx), gz + shift[1]], -1)
    return g.reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("case", ["plain", "flow-below-0", "swell"])
def test_displace_grid_matches_jax(case):
    """The bilinear taps wrap with a floor-mod: the flow moves grid
    coordinates below 0 (case flow-below-0); the swell adds its Gerstner
    term and slope."""
    kw = SPECTRA[1]
    (ja, jn), (ta, tn) = _maps(kw, 2.0, 1.2)
    base = _grid(shift=(-7.3, -2.1) if case == "flow-below-0" else (0.0, 0.0))
    swell = (0.4, 0.8, 0.6, 9.0) if case == "swell" else (0.0, 0.0, 0.0, 1.0)
    a = jocean.displace_grid(jnp.asarray(base), ja, jn, 6.0, swell)
    b = ocean.displace_grid(torch.from_numpy(base), torch.from_numpy(ta),
                            torch.from_numpy(tn), 6.0, swell)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL)


def test_water_lut_and_lut_uv_match_jax():
    assert np.array_equal(ocean.water_color_lut(), jocean.water_color_lut())
    assert np.array_equal(ocean.water_color_lut(32, deep=(0.1, 0.1, 0.2)),
                          jocean.water_color_lut(32, deep=(0.1, 0.1, 0.2)))
    rng = np.random.RandomState(2)
    pos = rng.randn(4096, 3).astype(np.float32) * 3
    nrm = rng.randn(4096, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    for kw in (dict(), dict(foamwavescale=0.5, foamwaveheight=0.2, foamshorescale=0.3,
                            waterdepth=2.0, foamplane=(0.1, 0.9, 0.0, -0.5))):
        a = jocean.ocean_lut_uv(jnp.asarray(pos), jnp.asarray(nrm), (1.0, 8.0, 3.0), **kw)
        b = ocean.ocean_lut_uv(torch.from_numpy(pos), torch.from_numpy(nrm),
                               (1.0, 8.0, 3.0), **kw)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("flow", [(0.0, 0.0), (0.3, -0.2)], ids=["still", "flow"])
def test_ocean_vertex_data_matches_jax(flow):
    """Ocean (its mesh in the pool, its spectrum) and vertex_data after
    two updates, with and without the flow, against the JAX package's:
    the slab's offset and count exact, its rows within TOL, its padding
    0; the slab's tensors on the context's device."""
    from datum_tpu.ops.common import FrameConfig as JConfig
    from datum_tpu.render import RenderContext as JaxRenderContext
    from datum_tpu.render.ocean import Ocean as JOcean
    from datum_tpu.render.ocean import OceanParams as JParams

    from datum_tpu_torch.ops.common import FrameConfig
    from datum_tpu_torch.render.context import RenderContext
    from datum_tpu_torch.render.ocean import Ocean, OceanParams

    pk = dict(wind=(9.0, 3.0), choppiness=1.6, swellamplitude=0.4, flow=flow)
    cfg = dict(width=64, height=32, max_vertices=1 << 12, max_triangles=1 << 13)
    jctx, ctx = JaxRenderContext(JConfig(**cfg)), RenderContext(FrameConfig(**cfg),
                                                                device="cpu")
    for c in (jctx, ctx):                 # the ocean's mesh lands at offset 4
        c.add_mesh(*primitives.unit_quad())
    jo = JOcean(jctx, grid=24, patch_size=16.0, params=JParams(**pk))
    to = Ocean(ctx, grid=24, patch_size=16.0, params=OceanParams(**pk))
    np.testing.assert_array_equal(ctx.pool.triangles, jctx.pool.triangles)
    np.testing.assert_array_equal(ctx.pool.texcoords, jctx.pool.texcoords)
    np.testing.assert_array_equal(to.mesh.maxcorner, jo.mesh.maxcorner)
    for o in (jo, to):
        o.update(1 / 60)
        o.update(0.75)
    a = jo.vertex_data(1024, (3.0, 9.0, 20.0))
    b = to.vertex_data(1024, (3.0, 9.0, 20.0))
    assert int(b["offset"]) == int(a["offset"]) == 4 and int(b["count"]) == 625
    for k in ("positions", "normals", "texcoords"):
        assert b[k].device == ctx.device and b[k].shape[0] == 1024
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), **TOL)
        assert not b[k][625:].any()
    with pytest.raises(ValueError, match="max_dynamic_vertices"):
        to.vertex_data(600)


def test_ocean_example_matches_golden():
    """The ocean example module (datum_tpu_torch/examples/ocean.py, the
    port of examples/ocean.py) at the golden's 320x160 on the CPU: its
    init, three updates of 1/60 s, then the frame the golden holds
    (through the module's render: FrameConfig's default deferred path,
    use_pallas off, the scan raster; the harness renders after each
    update, and the earlier frames leave no state behind), against
    tests/golden/ocean.png."""
    import types

    from PIL import Image

    from datum_tpu_torch.examples import ocean as example

    w, h = 320, 160
    state = example.init(types.SimpleNamespace(width=w, height=h, device="cpu"))
    for _ in range(3):
        example.update(state, 1 / 60)
    img = example.render(state).astype(np.float32)
    ctx = state["ctx"]
    gold = np.asarray(Image.open(GOLDEN).convert("RGB")).astype(np.float32)
    assert img.shape == gold.shape == (h, w, 3) and ctx.bin_overflow == 0
    d = img - gold
    rmse = float(np.sqrt(np.mean((d / 255.0) ** 2)))
    assert rmse < 2 / 255 and np.abs(d).mean() <= 0.5, (rmse, np.abs(d).mean())
