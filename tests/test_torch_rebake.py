"""The port's re-bake entry points against the JAX package (CPU).

- SkyBox, render_skybox, convolve and project (EnvMap.project) at a
  16^2 sky and 8 GGX samples: the mips and the SH-9 within rtol 1e-4,
  atol 1e-6 (the same bakes, float sums taken in another order by two
  libraries), the tables on the caller's device.
- RenderContext.update_material and update_texture on a rendered
  context (tests/test_frame.py's edit pattern: a textured quad, its
  texture swapped from red to blue, then its material made emissive,
  then its albedo map rebound): the device state after each edit equals
  a context built with the edited values from the start (exactly) and
  the JAX context's state after the same edit (the material rows and
  the texture pool exactly, the material-map table exactly); each
  128x64 frame after an edit against the JAX context's frame: RMSE
  < 2/255 and mean |d| <= 0.5 levels.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu.render import envmap as jenv
from datum_tpu.render import skybox as jsky

from datum_tpu_torch.render import envmap as tenv
from datum_tpu_torch.render import skybox as tsky

BAKE = dict(rtol=1e-4, atol=1e-6)


def _mips_close(jmips, tmips):
    assert len(jmips) == len(tmips)
    for a, b in zip(jmips, tmips):
        assert b.device.type == "cpu" and b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **BAKE)


@pytest.fixture(scope="module")
def skies():
    j = jsky.SkyBox(size=16, convolve_samples=8)
    t = tsky.SkyBox(size=16, convolve_samples=8, device="cpu")
    return j, t


def test_skybox_matches(skies):
    j, t = skies
    assert t.size == j.size == 16 and t.device.type == "cpu"
    _mips_close(j.mips, t.mips)


def test_render_skybox_matches(skies):
    """A re-bake under a new sun (the skybox example's edit) replaces the
    mips with the JAX package's re-bake's."""
    j, t = skies
    ang = 0.6 + 0.1 * np.sin(0.5)
    sd = np.array([-np.cos(ang), -np.sin(ang), -0.5], np.float32)
    sd /= np.linalg.norm(sd)
    jp = jsky.SkyBoxParams(sundirection=tuple(sd), exposure=1.3)
    tp = tsky.SkyBoxParams(sundirection=tuple(sd), exposure=1.3)
    before = [m.clone() for m in t.mips]
    assert jsky.render_skybox(j, jp) is j
    assert tsky.render_skybox(t, tp, device="cpu") is t
    assert t.params is tp
    _mips_close(j.mips, t.mips)
    assert not torch.allclose(before[0], t.mips[0])


def test_convolve_and_project_match():
    """convolve re-filters a map's levels from its top level (over as many
    levels as it holds); project's SH-9 from the top level."""
    rng = np.random.RandomState(3)
    top = rng.rand(6, 16, 16, 3).astype(np.float32) * 4
    mips = [top, top.reshape(6, 8, 2, 8, 2, 3).mean((2, 4)),
            top.reshape(6, 4, 4, 4, 4, 3).mean((2, 4))]
    j, t = jenv.EnvMap(mips), tenv.EnvMap(mips)
    assert jenv.convolve(j, samples=8) is j
    assert tenv.convolve(t, samples=8, device="cpu") is t
    _mips_close(j.mips, t.mips)
    a, b = jenv.project(j), tenv.project(t, device="cpu")
    assert isinstance(b, tenv.Irradiance) and b.sh.shape == (9, 3)
    np.testing.assert_allclose(b.sh, a.sh, **BAKE)
    np.testing.assert_allclose(t.project(device="cpu").sh, a.sh, **BAKE)


def test_from_cubemap_bakes_on_the_callers_device():
    """from_cubemap keeps its levels on the device it was given; the
    context's tables follow the sky's levels."""
    from datum_tpu_torch.render.context import RenderContext

    cube = np.random.RandomState(0).rand(6, 8, 8, 3).astype(np.float32)
    env = tenv.EnvMap.from_cubemap(cube, samples=4, device="cpu")
    assert [m.shape[1] for m in env.mips] == [8, 4]
    ctx = RenderContext(device="cpu")
    ctx.set_skybox(env)
    ibl = ctx.host_state()["ibl"]
    assert ibl["flatp"][0].device.type == "cpu" and ibl["sh"].shape == (9, 3)


# ---- live edits -------------------------------------------------------

RED, BLUE, GREEN = ([255, 0, 0, 255], [0, 0, 255, 255], [0, 200, 40, 255])


def _edit_scene(pkg, **mat_kw):
    """tests/test_frame.py's live-edit scene at 128x64 in pkg ("jax" or
    "torch"): (ctx, camera, params, renderlist factory, texture ids,
    material id); the quad's texture starts red, and a green texture sits
    in the next slot."""
    if pkg == "jax":
        from datum_tpu.math import Transform
        from datum_tpu.ops.common import FrameConfig
        from datum_tpu.render import (Camera, RenderContext, RenderList,
                                      RenderParams, primitives)
        ctx_kw = {}
    else:
        from datum_tpu_torch.math import Transform
        from datum_tpu_torch.ops.common import FrameConfig
        from datum_tpu_torch.render import primitives
        from datum_tpu_torch.render.camera import Camera
        from datum_tpu_torch.render.context import RenderContext
        from datum_tpu_torch.render.renderlist import RenderList
        from datum_tpu_torch.render.types import RenderParams
        ctx_kw = dict(device="cpu")
    cfg = FrameConfig(width=128, height=64, max_vertices=512, max_triangles=512,
                      max_instances=4, bin_capacity=64, big_capacity=8,
                      enable_shadows=False, texture_filter="bilinear")
    ctx = RenderContext(cfg, **ctx_kw)
    qv, qi = primitives.unit_quad()
    quad = ctx.add_mesh(qv, qi)
    tex = ctx.add_texture(np.full((8, 8, 4), mat_kw.pop("texel", RED), np.uint8))
    green = ctx.add_texture(np.full((4, 4, 4), GREEN, np.uint8))
    mat = ctx.add_material(**dict(dict(color=(1, 1, 1, 1), albedomap=tex), **mat_kw))
    cam = Camera()
    cam.set_projection(np.radians(60), 2.0)
    cam.lookat(np.array([0.0, 0.0, 3.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=128, height=64)
    params.ambientintensity = 1.0

    def make_rl():
        rl = RenderList()
        rl.push_mesh(quad, Transform.identity(), mat)
        return rl

    return ctx, cam, params, make_rl, (tex, green), mat


def _render(pkg, scene):
    ctx, cam, params, make_rl = scene[:4]
    if pkg == "jax":
        return ctx.render(cam, make_rl(), params)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return ctx.render(cam, make_rl(), params)
    finally:
        torch.set_num_threads(threads)


def _state_equal(a, b, path="state"):
    """Two device-state trees (tensors or jax/numpy arrays) equal, value
    for value, on the keys of a."""
    if isinstance(a, dict):
        for k in a:
            _state_equal(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _state_equal(x, y, f"{path}[{i}]")
        return
    x = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    y = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert x.shape == y.shape, path
    np.testing.assert_array_equal(x, y, err_msg=path)


EDITS = [("texture", dict(texel=BLUE)),
         ("material", dict(texel=BLUE, emissive=0.9)),
         ("binding", dict(texel=BLUE, emissive=0.9, albedomap=4))]     # 4: the green slot


@pytest.fixture(scope="module")
def edited():
    """Each edit in turn on a rendered port context and a rendered JAX
    context; per edit the port's device state, its frame and the JAX
    frame and state after it."""
    js, ts = _edit_scene("jax"), _edit_scene("torch")
    first = (_render("jax", js), _render("torch", ts))
    out = {}
    for name, _ in EDITS:
        for pkg, sc in (("jax", js), ("torch", ts)):
            ctx, (tex, green), mat = sc[0], sc[4], sc[5]
            if name == "texture":
                ctx.update_texture(tex, np.full((8, 8, 4), BLUE, np.uint8))
            elif name == "material":
                ctx.update_material(mat, emissive=0.9)
            else:
                ctx.update_material(mat, albedomap=green)
        t_state = ts[0]._state                 # patched, not rebuilt
        jstate = jax.tree.map(np.array, js[0]._device)     # copies: CPU jax arrays
        # may alias the context's host arrays, which the next edit changes
        out[name] = dict(t_state=t_state, j_state=jstate,
                         t_img=_render("torch", ts), j_img=_render("jax", js))
        assert ts[0]._state is not None
    return first, out


def test_first_frames_match(edited):
    (j, t), _ = edited
    d = t.astype(np.float32) - j.astype(np.float32)
    assert np.sqrt(np.mean((d / 255) ** 2)) < 2 / 255 and np.abs(d).mean() <= 0.5
    assert t[20:44, 48:80, 0].mean() > 1.5 * t[20:44, 48:80, 2].mean()     # red


@pytest.mark.parametrize("name,fresh_kw", EDITS, ids=[e[0] for e in EDITS])
def test_edit_matches_fresh_context_and_jax(edited, name, fresh_kw):
    _, out = edited
    o = out[name]
    fresh = _edit_scene("torch", **dict(fresh_kw))
    _render("torch", fresh)
    _state_equal(fresh[0]._state, o["t_state"])
    for k in ("materials", "matmaps", "textures"):
        _state_equal(o["j_state"][k], o["t_state"][k], k)
    d = o["t_img"].astype(np.float32) - o["j_img"].astype(np.float32)
    assert np.sqrt(np.mean((d / 255) ** 2)) < 2 / 255 and np.abs(d).mean() <= 0.5
    c = o["t_img"][20:44, 48:80].astype(np.float32)
    if name == "texture":
        assert c[..., 2].mean() > 1.5 * c[..., 0].mean()           # blue after
    if name == "binding":          # the table rebuilt for the new triple
        tables = [out[n]["t_state"]["matmaps"]["table"] for n in ("material", name)]
        assert tables[0].shape != tables[1].shape or not torch.equal(*tables)
