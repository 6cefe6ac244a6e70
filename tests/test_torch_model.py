"""Model.load, the pack-driven animation and the pack example apps on the
port against the JAX package (CPU).

- Model.load in both packages on one pack written here (RGBA, BC3 and
  RGBE textures, 3 materials, 2 meshes, 5 instances): the contexts' host
  state (pool arrays, material rows, textures, tex_native, the
  material-map table) and the entities' world transforms equal exactly.
  The JAX Model.load takes `mips[0][0]` of every image as its layer-0 top
  mip, which for a BC3 image (a flat block array) is one byte, and
  raises; its reader here hands it BC3 mips split by layer, so that it
  decodes what the port decodes (the JAX package is not edited).
- Animation.from_asset and Animator(pack bones): the palettes within
  1e-6 of the JAX palettes over 30 updates of a 3-clip crossfade.
- The teapot (on an OBJ written here, through obj_to_pack) and the
  character (on the rigged pack) apps at 128x64, one frame each, through
  their init/update/render, against the JAX apps with
  datum_tpu.asset.PackReader redirected to the test's packs: RMSE <
  2/255.
- The pack scene (packscene.pack_scene) from a pack against the same
  scene built in memory: equal frames on the CPU.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import datum_tpu.asset as jasset
from datum_tpu.asset import pack as jpack
from datum_tpu.render.animation import Animation as JAnimation
from datum_tpu.render.animation import Animator as JAnimator

from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu_torch import packscene
from datum_tpu_torch.asset import pack as tpack
from datum_tpu_torch.render.animation import Animation, Animator
from datum_tpu_torch.tools.bc import encode_bc3
from datum_tpu_torch.tools.objparser import obj_to_pack

REPO = Path(__file__).resolve().parent.parent


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) / 255.0
                                  - np.asarray(b, np.float64) / 255.0) ** 2)))


class _LayeredBC3(jpack.PackReader):
    """The JAX reader with each BC3 mip split by layer (see the module's
    docstring)."""

    def image(self, asset_id):
        img = super().image(asset_id)
        if img["format"] == jpack.IMAGE_RGBA_BC3:
            img["mips"] = [m.reshape(img["layers"], -1) for m in img["mips"]]
        return img


def _model_pack():
    rng = np.random.RandomState(21)
    w = tpack.PackWriter()
    rgba = rng.randint(0, 2 ** 32, (1, 16, 8), dtype=np.uint64).astype(np.uint32)
    w.write_image(10, 8, 16, 1, 1, tpack.IMAGE_RGBA, rgba.tobytes())
    bc = encode_bc3(rng.randint(0, 256, (8, 8, 4)).astype(np.uint8))
    w.write_image(11, 8, 8, 1, 2, tpack.IMAGE_RGBA_BC3, bc.tobytes() + bc[:16].tobytes(),
                  compress=True)
    rgbe = rng.randint(0, 2 ** 32, (1, 4, 4), dtype=np.uint64).astype(np.uint32)
    w.write_image(12, 4, 4, 1, 1, tpack.IMAGE_RGBE, rgbe.tobytes())
    sv, si = packscene.primitives.unit_sphere(8, 4)
    cv, ci = packscene.primitives.unit_cube()
    for aid, (v, i) in ((20, (sv, si)), (21, (cv, ci))):
        va = packscene.vertex_array(v)
        w.write_mesh(aid, va, np.asarray(i, np.uint32), va["position"].min(0),
                     va["position"].max(0), compress=aid == 21)
    mat = lambda **kw: dict(dict(color=rng.rand(4).astype(np.float32), metalness=0.3,
                                 roughness=0.6, reflectivity=0.5, emissive=0.1,
                                 albedomap=0, surfacemap=0, normalmap=0), **kw)
    w.write_model(1, [dict(type=0, texture=10), dict(type=2, texture=11),
                      dict(type=0, texture=12), dict(type=1, texture=0)],
                  [mat(albedomap=1, normalmap=2), mat(albedomap=3, surfacemap=4),
                   mat(surfacemap=1, normalmap=9)],
                  [20, 21],
                  [dict(mesh=i % 2, material=i % 3, childcount=0,
                        transform=np.concatenate([rng.randn(4) * [0.2, 0.2, 0.2, 1],
                                                  rng.randn(4)]).astype(np.float32))
                   for i in range(5)])
    return w.finish()


def test_model_load_state_equal():
    from datum_tpu.ops.common import FrameConfig as JConfig
    from datum_tpu.render import RenderContext as JContext
    from datum_tpu.render.texturepool import build_matmap_pool as jmatmaps
    from datum_tpu.scene import Model as JModel
    from datum_tpu.scene import Scene as JScene
    from datum_tpu.scene import TransformComponent as JTC

    from datum_tpu_torch.ops.common import FrameConfig
    from datum_tpu_torch.render.context import RenderContext
    from datum_tpu_torch.scene import Model, Scene, TransformComponent

    data = _model_pack()
    kw = dict(width=64, height=32, max_vertices=1024, max_triangles=1024)
    tctx, jctx = RenderContext(FrameConfig(**kw), device="cpu"), JContext(JConfig(**kw))
    ts, js = Scene(), JScene()
    tm = Model.load(ts, tctx, tpack.PackReader(data), 1)
    jm = JModel.load(js, jctx, _LayeredBC3(data), 1)
    assert (tm.materials, tm.textures) == (jm.materials, jm.textures)
    assert len(tm.entities) == len(jm.entities) == 5
    assert tctx.n_textures == jctx.n_textures == 6 and tctx.n_materials == 4
    for name in ("positions", "texcoords", "normals", "tangents", "bone_idx", "bone_wt",
                 "morph", "triangles", "mesh_vtx_offset", "mesh_vtx_count",
                 "mesh_tri_offset", "mesh_tri_count"):
        assert np.array_equal(getattr(tctx.pool, name), getattr(jctx.pool, name)), name
    for name in ("mat_color", "mat_metalness", "mat_roughness", "mat_reflectivity",
                 "mat_emissive", "mat_absorb", "mat_albedomap", "mat_surfacemap",
                 "mat_normalmap", "textures"):
        assert np.array_equal(getattr(tctx, name), getattr(jctx, name)), name
    assert tctx.tex_native.keys() == jctx.tex_native.keys()
    for k in tctx.tex_native:
        a, b = tctx.tex_native[k], jctx.tex_native[k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    table = tctx.host_state()["matmaps"]
    triples = [(int(jctx.mat_albedomap[m]), int(jctx.mat_surfacemap[m]),
                int(jctx.mat_normalmap[m])) for m in range(jctx.n_materials)]
    jt, jb, jsz = jmatmaps(triples, jctx.tex_native, max_size=jctx.config.matmap_max_size)
    assert np.array_equal(table["table"], jt)
    assert np.array_equal(table["base"][:len(jb)], jb)
    for te, je in zip(tm.entities, jm.entities):
        tw = ts.get_component(te, TransformComponent).world
        jw = js.get_component(je, JTC).world
        assert np.array_equal(tw.flat(), jw.flat())


def test_model_load_without_the_bc3_split_fails_in_jax():
    """The JAX defect the reader above works around (not the port's)."""
    from datum_tpu.ops.common import FrameConfig as JConfig
    from datum_tpu.render import RenderContext as JContext
    from datum_tpu.scene import Model as JModel
    from datum_tpu.scene import Scene as JScene

    with pytest.raises(ValueError, match="reshape"):
        JModel.load(JScene(), JContext(JConfig(width=64, height=32, max_vertices=1024,
                                               max_triangles=1024)),
                    jpack.PackReader(_model_pack()), 1)


@pytest.fixture(scope="module")
def rigged_pack(tmp_path_factory):
    path = tmp_path_factory.mktemp("rig") / "character.pack"
    w = tpack.PackWriter()
    packscene.write_character(w)
    path.write_bytes(w.finish())
    return path


def test_pack_animation_palettes(rigged_pack):
    t, j = tpack.PackReader(rigged_pack), jpack.PackReader(rigged_pack)
    tm, jm = t.mesh(packscene.ID_COLUMN), j.mesh(packscene.ID_COLUMN)
    ta, ja = Animator(tm["bones"]), JAnimator(jm["bones"])
    assert ta.bone_names == ja.bone_names == ["root", "mid", "tip"]
    assert np.array_equal(ta.bind, ja.bind)
    tch, jch = [], []
    for aid in packscene.ID_CLIPS:
        anim = Animation.from_asset(t.animation(aid))
        assert anim.duration == packscene.CLIPS[aid - 2][3]
        tch.append(ta.play(anim, weight=0.0, rate=1.0 + 0.1 * aid))
        jch.append(ja.play(JAnimation.from_asset(j.animation(aid)), weight=0.0,
                           rate=1.0 + 0.1 * aid))
    moved = 0.0
    for step in range(30):
        tt = step / 20.0
        w = (max(0.0, np.cos(tt)), min(1.0, tt), 0.3 * np.sin(tt) ** 2)
        for c, d, wi in zip(tch, jch, w):
            c.weight = d.weight = wi
        before = ta.palette().copy()
        ta.update(1 / 60)
        ja.update(1 / 60)
        np.testing.assert_allclose(ta.palette(), ja.palette(), atol=1e-6, rtol=0)
        moved = max(moved, float(np.abs(ta.palette() - before).max()))
    assert moved > 1e-3


def _jax_app(name, redirect):
    """examples/<name>.py's module with datum_tpu.asset.PackReader
    reading `redirect` in place of the reference pack."""
    sys.path.insert(0, str(REPO / "examples"))
    try:
        mod = __import__(name)
    finally:
        sys.path.remove(str(REPO / "examples"))
    orig = jasset.PackReader
    return mod, lambda path: orig(str(redirect))


def _frames(name, pack, monkeypatch):
    """(port frame, JAX frame) of the app at 128x64 after one update."""
    import importlib

    tmod = importlib.import_module(f"datum_tpu_torch.examples.{name}")
    ts = tmod.init(types.SimpleNamespace(width=128, height=64, device="cpu", pack=str(pack)))
    tmod.update(ts, 1 / 60)
    timg = tmod.render(ts)
    jmod, reader = _jax_app(name, pack)
    monkeypatch.setattr(jasset, "PackReader", reader)
    js = jmod.init(types.SimpleNamespace(width=128, height=64))
    jmod.update(js, 1 / 60)
    jimg = np.asarray(jmod.render(js))
    assert ts["ctx"].bin_overflow == 0
    return timg, jimg


def test_teapot_app_matches_jax(tmp_path, monkeypatch):
    obj = tmp_path / "vase.obj"
    obj.write_text(packscene.lathe_obj(0, 24, 12))
    obj_to_pack(obj, tmp_path / "vase.pack")
    timg, jimg = _frames("teapot", tmp_path / "vase.pack", monkeypatch)
    assert timg.shape == jimg.shape == (64, 128, 3)
    assert timg.mean() > 10 and _rmse(timg, jimg) < 2 / 255, _rmse(timg, jimg)


def test_character_app_matches_jax(rigged_pack, monkeypatch):
    timg, jimg = _frames("character", rigged_pack, monkeypatch)
    assert timg.shape == jimg.shape == (64, 128, 3)
    assert timg.mean() > 10 and _rmse(timg, jimg) < 2 / 255, _rmse(timg, jimg)


def test_pack_scene_equals_memory_scene(tmp_path):
    """The pack-loaded scene and its in-memory twin: equal host state and
    equal frames over 2 frames of the animation (64x32, 8^2 maps)."""
    assets = packscene.scene_assets(sphere_detail=6, grid=(3, 2), map_size=8, mapped=(1, 4))
    col = packscene.rigged_column()
    packscene.write_scene_pack(tmp_path / "s.pack", assets, col)
    reader = tpack.PackReader(tmp_path / "s.pack")
    kw = dict(max_vertices=2048, max_triangles=2048, bin_capacity=512, big_capacity=16,
              use_pallas=True, enable_material_maps=True, texture_filter="mip_half",
              enable_shadows=False, max_translucent_draws=2, max_translucent_tris=512,
              max_particle_quads=256, max_decals_active=2, decal_textures=False,
              max_palettes=2, max_bones=8, matmap_max_size=8)
    frames, states = [], []
    for src in (dict(pack=reader), dict(assets=assets, column=col)):
        ctx, cam, params, make_rl, _, _ = packscene.pack_scene(64, 32, device="cpu",
                                                               **src, **kw)
        frames.append([ctx.render(cam, make_rl(0.1 * f, 1 / 60), params) for f in range(2)])
        states.append(ctx.host_state())
    for k in ("geometry", "materials", "matmaps"):
        for name, a in states[0][k].items():
            assert np.array_equal(a, states[1][k][name]), (k, name)
    assert np.array_equal(frames[0][0], frames[1][0])
    assert np.array_equal(frames[0][1], frames[1][1])
    assert not np.array_equal(frames[0][0], frames[0][1])
    assert torch.get_num_threads() == 1
