"""Why the datumtest example's golden needs the city's treatment (CPU).

tests/golden/datumtest.png is the JAX package's jitted frame of
examples/datumtest.py at 320x160 after 3 frames, and the port's own
frame misses it by RMSE 0.0221 (the far floor's shadows).  The cause is
the city golden's (test_torch_city.py; ROADMAP Queue 3), shown here on
the frame's own sun-cascade inputs: XLA:CPU contracts the jitted shadow
setup's products into FMAs, so three degenerate triangles of the
lat-long spheres (two corners at one position, or three collinear
corners: their cross product is 0 or ~1e-17) keep a det of rounding
residue that passes the setup's relative degeneracy test, and each wins
one texel of the 4 x 1024^2 stack at a depth off its corners'.  They
raise the maxima of cascades 1 and 2 (build_esm's zmax) 7- and 6-fold,
and so move every ESM shadow of those cascades.  The port's setup
rejects these triangles, as the JAX function does un-jitted: the port's
stack equals the un-jitted one bit for bit.  (The FMA-rounded depth
priorities also keep other triangles at the cut of saturated bins, which
moves a few thousand texels of cascades 1-3 by more than 1e-3; with the
three texels alone written in, test_torch_examples_particles.py holds
the port's frame to the golden at RMSE < 2/255.)  The cascade inputs are
the same in the 3 frames: the scene's casters do not move.
"""

import functools
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from datum_tpu.ops import shadow as jshadow

from test_torch_city import _jax_cascade_stack, _port_cascade_stack
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent


def _degenerate(world_pos, tris, ids):
    """Where the id (a triangle of the stack: slice * T + triangle) names a
    degenerate triangle: the sine of its angle at corner 0 at most 1e-6
    (two corners at one position, or three collinear corners)."""
    c = world_pos[tris[np.maximum(ids, 0) % tris.shape[0]]]         # (..., 3, 3)
    e1, e2 = c[..., 1, :] - c[..., 0, :], c[..., 2, :] - c[..., 0, :]
    cross = np.linalg.norm(np.cross(e1, e2), axis=-1)
    return (ids >= 0) & (cross <= 1e-6 * np.linalg.norm(e1, axis=-1)
                         * np.linalg.norm(e2, axis=-1))


@pytest.fixture(scope="module")
def jax_datumtest():
    """examples/datumtest.py through the JAX package's own path (the
    jitted frame, 3 frames at the golden's config), with the sun
    cascades' inputs, keyword arguments and stack of each frame read out
    of the jitted frame by a callback.  The jit caches are cleared before
    and after: the frame's jit would otherwise reuse another trace."""
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import datumtest as jdt
    finally:
        sys.path.remove(str(REPO / "examples"))
    orig = jshadow.render_shadow_cascades
    frames = []

    def read_out(world_pos, tris, shadowview, **kw):
        out = orig(world_pos, tris, shadowview, **kw)
        if kw["res"] == 1024:                         # the sun's (the spot's is 256)
            def keep(w, t, v, o):
                frames.append(dict(kw=kw, inputs=(np.asarray(w), np.asarray(t),
                                                  np.asarray(v)), stack=np.asarray(o)))
            jax.debug.callback(keep, world_pos, tris, shadowview, out)
        return out

    jax.clear_caches()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jshadow, "render_shadow_cascades", read_out)
            state = jdt.init(types.SimpleNamespace(width=320, height=160))
            for _ in range(3):
                jdt.update(state, 1 / 60)
                img = jdt.render(state)
    finally:
        jax.clear_caches()
    return img, frames


def test_datumtest_golden_gap_is_degenerate_slivers(jax_datumtest):
    """On the cascade inputs of the JAX package's jitted datumtest frame
    (which is tests/golden/datumtest.png, pixel for pixel; the same in
    each of the 3 frames): the jitted stack's texels won by degenerate
    triangles are chip_smoke.DATUMTEST_GOLDEN_SLIVERS; the port's stack
    equals the un-jitted JAX stack bit for bit and no degenerate triangle
    wins a texel of it; each sliver is its cascade's maximum, cascade
    0's maximum is the port's, and the slivers raise cascades 1 and 2's
    more than 5-fold above the port's."""
    img, frames = jax_datumtest
    np.testing.assert_array_equal(img, np.asarray(Image.open(
        REPO / "tests" / "golden" / "datumtest.png").convert("RGB")))
    assert len(frames) == 3
    for f in frames[1:]:
        for a, b in zip(f["inputs"] + (f["stack"],), frames[0]["inputs"]
                        + (frames[0]["stack"],)):
            np.testing.assert_array_equal(a, b)
    w, t, v = frames[-1]["inputs"]
    kw = frames[-1]["kw"]
    assert kw["far_res"] is None and not kw["use_pallas"]
    sizes = dict(res=kw["res"], bin_capacity=kw["bin_capacity"],
                 big_capacity=kw["big_capacity"])
    jdepth, jvis = map(np.asarray, jax.jit(functools.partial(_jax_cascade_stack, **sizes))(
        w, t, v))
    np.testing.assert_array_equal(jdepth, frames[-1]["stack"])    # the frame's own
    assert jdepth.shape == chip_smoke.DATUMTEST_GOLDEN_STACK

    sliver = _degenerate(w, t, jvis)
    found = tuple((int(s), int(y), int(x), float(jdepth[s, y, x]))
                  for s, y, x in np.argwhere(sliver))
    assert found == chip_smoke.DATUMTEST_GOLDEN_SLIVERS

    torch.set_num_threads(2)             # the scan raster of 4 x 1024^2 texels
    pdepth, pvis = _port_cascade_stack(w, t, v, **sizes)
    eager = np.asarray(jshadow.render_shadow_cascades(w, t, v, **kw))     # un-jitted
    np.testing.assert_array_equal(pdepth, eager)
    assert not _degenerate(w, t, pvis).any()

    zmax_jit, zmax_port = jdepth.max(axis=(1, 2)), pdepth.max(axis=(1, 2))
    np.testing.assert_allclose(zmax_jit[0], zmax_port[0], rtol=1e-4)
    assert np.all(zmax_jit[1:3] > 5 * zmax_port[1:3])
    assert all(d == zmax_jit[s] for s, _, _, d in found)      # each its cascade's max
