"""The city example on the port against the JAX package (CPU), at the
golden's config (examples/city.py at 320x160; datum_tpu/tools/
update_goldens.py): 43 of 73 meshes survive frustum + occlusion culling,
and the frame (with its two depth-tested gizmos) is held to the JAX
package's frame with its shadow cascades run un-jitted at RMSE < 2/255
(measured 2.0e-5).

tests/golden/city.png is the JAX package's jitted frame, and the port's
own frame misses it by RMSE 0.03094 (the street's shadows).  The cause is
shown here on the frame's own cascade inputs: XLA:CPU contracts the
jitted shadow setup's products into FMAs, so six zero-area triangles of
the lat-long spheres (two corners at one world position) keep a det of
rounding residue that passes the setup's relative degeneracy test, and
each wins one texel of the cascade stack at a depth off its corners'.
They raise the maxima of cascades 2 and 3, which build_esm takes as
zmax, and so move every ESM shadow of those cascades.  The port's setup
rejects these triangles, as the JAX function does un-jitted: the port's
stack equals the un-jitted one bit for bit.  With those six texels of
the jitted stack written into the port's stack (chip_smoke's
CITY_GOLDEN_SLIVERS, which the test derives and checks), the port's
frame holds the golden at RMSE < 2/255 over the whole frame.
"""

import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from datum_tpu.ops import raster as jraster
from datum_tpu.ops import shadow as jshadow

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu_torch.ops import raster as traster
from datum_tpu_torch.ops import shadow as tshadow

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "city.png"


def _rmse(a, b):
    return float(np.sqrt(np.mean((a / 255.0 - b / 255.0) ** 2)))


def _golden():
    return np.asarray(Image.open(GOLDEN).convert("RGB"))


def _jax_city_module():
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import city as jcity
    finally:
        sys.path.remove(str(REPO / "examples"))
    return jcity


def _port_city():
    """The port's city frame at the golden's config (one frame: the scene
    does not move, so frame 3 is frame 1) and the example's state."""
    from datum_tpu_torch.examples import city as tcity

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = types.SimpleNamespace(width=320, height=160, device="cpu", cpu=True)
        state = tcity.init(args)
        img = tcity.render(state)
    finally:
        torch.set_num_threads(threads)
    return state, img


@pytest.fixture(scope="module")
def city():
    return _port_city()


def _jax_city_frame(cascades):
    """The JAX package's city frame (its jitted frame) at the golden's
    config with datum_tpu.ops.shadow.render_shadow_cascades replaced by
    cascades.  The jit caches are cleared before and after: the frame's
    jit would otherwise reuse a trace made with another replacement."""
    jcity = _jax_city_module()
    jax.clear_caches()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jshadow, "render_shadow_cascades", cascades)
            js = jcity.init(types.SimpleNamespace(width=320, height=160))
            return js, jcity.render(js)
    finally:
        jax.clear_caches()


@pytest.fixture(scope="module")
def jax_city():
    """examples/city.py through the JAX package's own path (the jitted
    frame) at the golden's config, with the sun cascades' inputs, keyword
    arguments and stack read out of the jitted frame by a callback."""
    orig = jshadow.render_shadow_cascades
    cap = {}

    def read_out(world_pos, tris, shadowview, **kw):
        out = orig(world_pos, tris, shadowview, **kw)
        cap["kw"] = kw

        def keep(w, t, v, o):
            cap["inputs"] = (np.asarray(w), np.asarray(t), np.asarray(v))
            cap["stack"] = np.asarray(o)

        jax.debug.callback(keep, world_pos, tris, shadowview, out)
        return out

    _, img = _jax_city_frame(read_out)
    return img, cap


def _jax_cascade_stack(world_pos, tris, shadowview, *, res, bin_capacity, big_capacity):
    """datum_tpu/ops/shadow.py::_render_cascade_stack on the scan raster
    (the city's path: one stack, use_pallas off), returning the raster's
    winning triangle ids beside the depth: (S, res, res) each."""
    p0 = world_pos[tris[:, 0]].T
    p1 = world_pos[tris[:, 1]].T
    p2 = world_pos[tris[:, 2]].T
    shared = ((tris[:, 0] == tris[:, 1]) | (tris[:, 1] == tris[:, 2])
              | (tris[:, 0] == tris[:, 2]))
    n = shadowview.shape[0]
    tiles_x, tiles_y, vh = res // jraster.TILE_W, (res * n) // jraster.TILE_H, res * n
    T = p0.shape[1]
    parts = {f"{c}{j}": [] for c in "xyzw" for j in range(3)}
    for s in range(n):
        m = shadowview[s]
        off = (2.0 * s - (n - 1)) / n
        for j, p in enumerate((p0, p1, p2)):
            cx = m[0, 0] * p[0] + m[0, 1] * p[1] + m[0, 2] * p[2] + m[0, 3]
            cy = m[1, 0] * p[0] + m[1, 1] * p[1] + m[1, 2] * p[2] + m[1, 3]
            cz = m[2, 0] * p[0] + m[2, 1] * p[1] + m[2, 2] * p[2] + m[2, 3]
            cw = m[3, 0] * p[0] + m[3, 1] * p[1] + m[3, 2] * p[2] + m[3, 3]
            parts[f"x{j}"].append(cx)
            parts[f"y{j}"].append(cy * (1.0 / n) + off * cw)
            parts[f"z{j}"].append(cz)
            parts[f"w{j}"].append(cw)
    comps = {k: jnp.concatenate(v) for k, v in parts.items()}
    band = jnp.arange(n * T, dtype=jnp.int32) // T
    band_lo = -1.0 + band.astype(jnp.float32) * (2.0 / n)
    setup = jraster.triangle_setup_comps(
        comps, jnp.tile(shared, n), res, vh, tiles_x, tiles_y, cull=-1, max_span=4,
        ylim=(band_lo, band_lo + 2.0 / n))
    bins, _, big, _ = jraster.bin_triangles(
        setup, n * T, tiles_x, tiles_y, bin_capacity, big_capacity, max_span=4,
        depth_prio=setup["zbound"], return_zub=True,
        tri_block=(n, (tiles_x * tiles_y) // n))
    depth, vis = jraster.raster(setup, bins, big, tiles_x, tiles_y, res, vh)
    return depth.reshape(n, res, res), vis.reshape(n, res, res)


def _port_cascade_stack(world_pos, tris, shadowview, *, res, bin_capacity, big_capacity):
    """The port's render_shadow_cascades without K3 (the scan raster),
    returning the winning triangle ids beside the depth."""
    (stack,) = tshadow.cascade_stacks(torch.tensor(world_pos), torch.tensor(tris),
                                      torch.tensor(shadowview), res=res)
    bins, _, big_ids = tshadow.bin_stack(stack, bin_capacity, big_capacity)
    depth, vis = traster.raster(stack["setup"], bins, big_ids, stack["tiles_x"],
                                stack["tiles_y"], res, stack["height"])
    n = shadowview.shape[0]
    return depth.reshape(n, res, res).numpy(), vis.reshape(n, res, res).numpy()


def _zero_area(world_pos, tris, ids):
    """Where the id (a triangle of the stack: slice * T + triangle) names a
    triangle with two corners at one world position."""
    c = world_pos[tris[np.maximum(ids, 0) % tris.shape[0]]]        # (..., 3, 3)
    same = lambda i, j: np.all(c[..., i, :] == c[..., j, :], axis=-1)
    return (ids >= 0) & (same(0, 1) | same(1, 2) | same(0, 2))


def test_city_culls_43_of_73(city):
    state, img = city
    assert state["stats"] == (43, 73)
    assert img.shape == (160, 320, 3) and img.dtype == np.uint8
    assert state["ctx"].bin_overflow == 0
    assert tuple(state["ctx"].last_depth.shape) == (160, 320)


def test_city_frame_matches_the_jax_frame(city):
    """examples/city.py through the JAX package, with its shadow cascades
    computed un-jitted (a callback into the same JAX function), against
    the port's frame: RMSE < 2/255.  The gizmos are drawn in both."""
    orig = jshadow.render_shadow_cascades

    def eager_cascades(world_pos, tris, shadowview, **kw):
        shape = jax.ShapeDtypeStruct((shadowview.shape[0], kw["res"], kw["res"]),
                                     jnp.float32)
        run = lambda w, t, v: np.asarray(orig(np.asarray(w), np.asarray(t),
                                              np.asarray(v), **kw))
        return jax.pure_callback(run, shape, world_pos, tris, shadowview)

    js, want = _jax_city_frame(eager_cascades)
    want = want.astype(np.float32)
    got = city[1].astype(np.float32)
    assert js["stats"] == city[0]["stats"]
    assert _rmse(got, want) < 2.0 / 255.0
    assert np.abs(got - want).mean() <= 0.5


def test_city_golden_gap_is_zero_area_slivers(jax_city):
    """On the cascade inputs of the JAX package's jitted city frame (which
    is tests/golden/city.png, pixel for pixel): the jitted stack's texels
    won by zero-area triangles are chip_smoke.CITY_GOLDEN_SLIVERS; the
    port's stack equals the un-jitted JAX stack bit for bit and no
    zero-area triangle wins a texel of it; outside those texels the
    jitted stack's per-cascade maxima (build_esm's zmax) are the port's
    (to 1e-4: XLA's FMAs also round the clip transforms apart, by ~3e-6
    in depth), and with them cascades 2 and 3's maxima rise above the
    port's."""
    img, cap = jax_city
    np.testing.assert_array_equal(img, _golden())
    w, t, v = cap["inputs"]
    kw = cap["kw"]
    assert kw["far_res"] is None and not kw["use_pallas"]
    sizes = dict(res=kw["res"], bin_capacity=kw["bin_capacity"],
                 big_capacity=kw["big_capacity"])
    jdepth, jvis = map(np.asarray, jax.jit(functools.partial(_jax_cascade_stack, **sizes))(
        w, t, v))
    np.testing.assert_array_equal(jdepth, cap["stack"])      # the frame's own stack

    sliver = _zero_area(w, t, jvis)
    found = tuple((int(s), int(y), int(x), float(jdepth[s, y, x]))
                  for s, y, x in np.argwhere(sliver))
    assert found == chip_smoke.CITY_GOLDEN_SLIVERS

    pdepth, pvis = _port_cascade_stack(w, t, v, **sizes)
    eager = np.asarray(jshadow.render_shadow_cascades(w, t, v, **kw))     # un-jitted
    np.testing.assert_array_equal(pdepth, eager)
    assert not _zero_area(w, t, pvis).any()

    zmax_jit, zmax_port = jdepth.max(axis=(1, 2)), pdepth.max(axis=(1, 2))
    np.testing.assert_allclose(np.where(sliver, 0.0, jdepth).max(axis=(1, 2)), zmax_port,
                               rtol=1e-4)
    np.testing.assert_allclose(zmax_jit[:2], zmax_port[:2], rtol=1e-4)
    assert np.all(zmax_jit[2:] > 1.3 * zmax_port[2:])


def test_city_frame_against_the_golden():
    """The port's city frame with the six texels of CITY_GOLDEN_SLIVERS
    written into its cascade stack against tests/golden/city.png: RMSE
    < 2/255 over the whole frame (measured 1.7e-5)."""
    with chip_smoke.golden_slivers():
        state, img = _port_city()
    gold = _golden().astype(np.float32)
    img = img.astype(np.float32)
    assert state["stats"] == (43, 73)
    assert _rmse(img, gold) < 2.0 / 255.0
    assert np.abs(img - gold).mean() <= 0.5


def test_city_example_runs_without_jax(tmp_path):
    """The example harness on the CPU at 64x32 with the debug overlay,
    with jax and the JAX package made unimportable (as on the machine
    with the card): it writes a PNG and loads none of them."""
    out = tmp_path / "city.png"
    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['datum_tpu'] = None\n"
            "import torch\ntorch.set_num_threads(1)\n"
            "from datum_tpu_torch.examples import city\n"
            "import datum_tpu_torch.debug, datum_tpu_torch.scene, "
            "datum_tpu_torch.render.overlay, datum_tpu_torch.render.occlusion, "
            "datum_tpu_torch.render.sprite, datum_tpu_torch.ops.sprite_pass\n"
            f"state = city.main(['--cpu', '--frames', '1', '--width', '64', '--height', "
            f"'32', '--overlay', '--out', {str(out)!r}])\n"
            "loaded = [m for m, v in sys.modules.items() if v is not None and"
            " (m.startswith('jax') or m == 'datum_tpu' or m.startswith('datum_tpu.'))]\n"
            "assert not loaded, loaded\nprint('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
    assert "saved" in res.stdout
    img = np.asarray(Image.open(out).convert("RGB"))
    assert img.shape == (32, 64, 3) and img.mean() > 10
