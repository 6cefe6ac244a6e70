"""RenderContext: persistent pools + device state (counterpart of
datum_tpu/render/context.py, the host side the port needs).

The geometry pool (with its skinning rig rows), the material and
texture tables (the water material's colour LUT among them), the
material-map
mip table (`_rebuild_matmaps`, with the `packed10` per-material rows),
the fitted colour-grading polynomial, the skybox environment (its mip
chain, mip-pair table, SH-9 and the env-BRDF LUT) and the box
environment probes (`add_environment`: their stacked mip chains and one
quad-packed table each) and the shelf-packed overlay atlas of the
sprites and the font (`overlay_info`) are numpy, as in the JAX package;
`device_state(device)` returns them as torch tensors on `device`.  An
ocean's dynamic-vertex slab is computed each frame on the context's
device (render/ocean.py) and rides in the frame's draws.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..convert import to_torch
from ..debug.debug import traced
from ..ops.common import FrameConfig

TEX_SIZE = 256
MAX_MATERIALS = 256
MAX_TEXTURES = 64
# a grading LUT grades through its fitted polynomial when the fit's max
# error is within this (~2/255), else through the exact trilinear tap
LUT_POLY_TOL = 0.008

# the port's tracked env-BRDF LUT: a byte-for-byte copy of the JAX
# package's bake_envbrdf(64, 128) file; read only, never written
_ENVBRDF_LUT = Path(__file__).resolve().parents[1] / "data" / "envbrdf64.npy"

# fixed texture ids
TEX_WHITE = 0
TEX_FLAT_NORMAL = 1
TEX_UNIT_SURFACE = 2


class MeshHandle:
    __slots__ = ("mesh_id", "vertexcount", "trianglecount", "mincorner", "maxcorner")

    def __init__(self, mesh_id, vertexcount, trianglecount, mincorner, maxcorner):
        self.mesh_id = mesh_id
        self.vertexcount = vertexcount
        self.trianglecount = trianglecount
        self.mincorner = np.asarray(mincorner, np.float32)
        self.maxcorner = np.asarray(maxcorner, np.float32)

    def bound(self):
        from ..math.bound import Bound3
        return Bound3(self.mincorner, self.maxcorner)


def _to_rgba_u8(image):
    """Promote any image (float [0,1] or u8; gray/RGB/RGBA) to RGBA u8."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3 + [np.full_like(img, 255)], -1)
    if img.shape[2] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
    return img


def _resample_nearest(img, size):
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img
    yi = (np.arange(size) * h // size).clip(0, h - 1)
    xi = (np.arange(size) * w // size).clip(0, w - 1)
    return img[yi][:, xi]


class GeometryPool:
    """Append-only host mirror of the device geometry pool."""

    def __init__(self, max_vertices, max_triangles, max_meshes=1024):
        self.positions = np.zeros((max_vertices, 3), np.float32)
        self.texcoords = np.zeros((max_vertices, 2), np.float32)
        self.normals = np.zeros((max_vertices, 3), np.float32)
        self.tangents = np.zeros((max_vertices, 4), np.float32)
        self.bone_idx = np.zeros((max_vertices, 4), np.int32)
        self.bone_wt = np.zeros((max_vertices, 4), np.float32)
        self.bone_wt[:, 0] = 1.0          # default: bone 0 (identity)
        self.morph = np.zeros((max_vertices, 6), np.float32)
        self.triangles = np.zeros((max_triangles, 3), np.int32)
        self.mesh_vtx_offset = np.zeros(max_meshes, np.int32)
        self.mesh_vtx_count = np.zeros(max_meshes, np.int32)
        self.mesh_tri_offset = np.zeros(max_meshes, np.int32)
        self.mesh_tri_count = np.zeros(max_meshes, np.int32)
        self.n_vertices = 0
        self.n_triangles = 0
        self.n_meshes = 0

    def add_mesh(self, vertices, indices, mincorner=None, maxcorner=None,
                 rig=None) -> MeshHandle:
        """vertices: dict of arrays (position, texcoord, normal, tangent,
        and for a terrain its geomorph targets morph_position and
        morph_normal, stored as deltas for the vertex stage) or a pack's
        structured vertex array (asset/pack.py VERTEX_DTYPE); indices:
        (K,) or (K/3, 3) mesh-local triangle indices; mincorner and
        maxcorner: the handle's bounds (default: the positions'); rig: a
        structured array with fields bone (4 int) and weight (4 float)
        per vertex (default: bone 0 at weight 1)."""
        if isinstance(vertices, np.ndarray) and vertices.dtype.names:
            vertices = {k: vertices[k] for k in vertices.dtype.names}
        pos = np.asarray(vertices["position"], np.float32)
        uv = np.asarray(vertices.get("texcoord", np.zeros((len(pos), 2))), np.float32)
        nrm = np.asarray(vertices.get("normal", np.tile([0, 0, 1.0], (len(pos), 1))), np.float32)
        tan = np.asarray(vertices.get("tangent", np.tile([1.0, 0, 0, 1], (len(pos), 1))), np.float32)
        tris = np.asarray(indices, np.int32).reshape(-1, 3)
        nv, nt = len(pos), len(tris)
        v0, t0 = self.n_vertices, self.n_triangles
        if v0 + nv > len(self.positions) or t0 + nt > len(self.triangles):
            raise RuntimeError("geometry pool exhausted")
        self.positions[v0:v0 + nv] = pos
        self.texcoords[v0:v0 + nv] = uv
        self.normals[v0:v0 + nv] = nrm
        self.tangents[v0:v0 + nv] = tan
        if rig is not None:
            self.bone_idx[v0:v0 + nv] = rig["bone"]
            self.bone_wt[v0:v0 + nv] = rig["weight"]
        if "morph_position" in vertices:
            self.morph[v0:v0 + nv, :3] = (
                np.asarray(vertices["morph_position"], np.float32) - pos)
            if "morph_normal" in vertices:
                self.morph[v0:v0 + nv, 3:6] = (
                    np.asarray(vertices["morph_normal"], np.float32) - nrm)
        self.triangles[t0:t0 + nt] = tris + v0     # pool-global vertex ids
        m = self.n_meshes
        self.mesh_vtx_offset[m] = v0
        self.mesh_vtx_count[m] = nv
        self.mesh_tri_offset[m] = t0
        self.mesh_tri_count[m] = nt
        self.n_vertices += nv
        self.n_triangles += nt
        self.n_meshes += 1
        if mincorner is None:
            mincorner, maxcorner = pos.min(0), pos.max(0)
        return MeshHandle(m, nv, nt, mincorner, maxcorner)

    def host_arrays(self):
        """The device geometry arrays, as numpy (attr12 = position, uv,
        normal, tangent rows: one gather per vertex)."""
        return dict(
            positions=self.positions, texcoords=self.texcoords,
            normals=self.normals, tangents=self.tangents,
            attr12=np.concatenate([self.positions, self.texcoords,
                                   self.normals, self.tangents], axis=1),
            bone_idx=self.bone_idx, bone_wt=self.bone_wt, morph6=self.morph,
            triangles=self.triangles,
            mesh_vtx_offset=self.mesh_vtx_offset,
            mesh_vtx_count=self.mesh_vtx_count,
            mesh_tri_offset=self.mesh_tri_offset,
            mesh_tri_count=self.mesh_tri_count,
        )


class RenderContext:
    """Owns the pools; `device_state(device)` uploads them, and `render`
    draws one frame on the context's device (the card unless the caller
    names another)."""

    def __init__(self, config: FrameConfig | None = None, device="cuda"):
        max_materials, max_textures = MAX_MATERIALS, MAX_TEXTURES
        self.config = config or FrameConfig()
        self.device = torch.device(device)
        cfg = self.config
        self.pool = GeometryPool(cfg.max_vertices, cfg.max_triangles)

        self.mat_color = np.zeros((max_materials, 4), np.float32)
        self.mat_metalness = np.zeros(max_materials, np.float32)
        self.mat_roughness = np.ones(max_materials, np.float32)
        self.mat_reflectivity = np.full(max_materials, 0.5, np.float32)
        self.mat_emissive = np.zeros(max_materials, np.float32)
        self.mat_absorb = np.zeros(max_materials, np.float32)
        self.mat_albedomap = np.zeros(max_materials, np.int32)
        self.mat_surfacemap = np.full(max_materials, TEX_UNIT_SURFACE, np.int32)
        self.mat_normalmap = np.full(max_materials, TEX_FLAT_NORMAL, np.int32)
        self.n_materials = 0

        self.textures = np.zeros((max_textures, TEX_SIZE, TEX_SIZE, 4), np.uint8)
        self.tex_native = {}    # id -> native-size (H, W, 4) u8 (mip source)
        self.n_textures = 0
        self.add_texture(np.full((1, 1, 4), 255, np.uint8))            # white
        self.add_texture(np.tile(np.array([[[128, 128, 255, 255]]], np.uint8),
                                 (1, 1, 1)))                           # flat normal
        self.add_texture(np.full((1, 1, 4), 255, np.uint8))            # unit surface
        self.default_material = self.add_material(color=(0.75, 0.75, 0.75, 1.0),
                                                  metalness=0.0, roughness=1.0,
                                                  reflectivity=0.5)
        self.colorlut = None
        self.colorlut_poly = None
        self.skybox = None
        self._ao_prev = None
        self._state = None         # render()'s device state, until a pool changes
        self.last_depth = None     # the last frame's depth plane (on self.device)
        self.luminance = 0.18      # the last frame's log-average luminance
        self.bin_overflow = 0
        self._ibl = None
        self._envbrdf = None
        self._envprobes = []
        self._overlay_images = []  # (RGBA u8 image, layers) per sprite id
        self._overlay_font = None
        self._overlay_cache = None

    def set_skybox(self, skybox):
        """Attach an EnvMap/SkyBox as the global environment; its flat,
        quad-packed and mip-pair tables and SH-9 are baked here, once, on
        the device its mips lie on (the megakernel path reads the
        mip-pair table, the deferred path the flat and quad ones).  The
        tables stay tensors there until device_state moves them."""
        self._state = None
        from ..ops.ibl import sh_project
        from ..ops.sampling import (flatten_cube_mips, flatten_cube_mips_pair,
                                    flatten_cube_mips_quad)

        self.skybox = skybox
        mips = list(skybox.mips)
        self._ibl = dict(
            mips=tuple(mips),
            flat=flatten_cube_mips(mips),
            flatq=flatten_cube_mips_quad(mips),
            flatp=flatten_cube_mips_pair(mips),
            sh=sh_project(mips[0][..., :3]),
            envbrdf=self.envbrdf_lut())

    def add_environment(self, position, halfdim, cubemap, rotation=None,
                        levels=5):
        """Local environment probe box: a world box (position, halfdim,
        rotation as a w, x, y, z quaternion) whose cubemap (6, S, S, 3+)
        lights the pixels inside it; its specular mip chain is
        prefiltered here, once.  Every probe of a context shares one
        cubemap size (device_state raises otherwise)."""
        self._state = None
        from ..math import quat_to_matrix
        from ..ops.ibl import build_specular_mips

        mips = build_specular_mips(torch.as_tensor(np.asarray(cubemap, np.float32)),
                                   levels)
        rot = np.eye(3, dtype=np.float32) if rotation is None \
            else np.asarray(quat_to_matrix(rotation), np.float32)
        self._envprobes.append(dict(
            position=np.asarray(position, np.float32), inv_rot=rot.T,
            halfdim=np.asarray(halfdim, np.float32),
            mips=[m.numpy() for m in mips]))

    def _envprobe_state(self):
        """The probes' tables (the JAX package's ibl["envprobes"]):
        stacked positions, inverse rotations, half sizes and mip levels,
        one quad-packed mip table per probe (the megakernel branch's
        fields tap it) and the count."""
        from ..ops.sampling import flatten_cube_mips_quad

        eps = self._envprobes
        if len({tuple(m.shape for m in e["mips"]) for e in eps}) != 1:
            raise ValueError("environment probes must share cubemap size")
        return dict(
            position=np.stack([e["position"] for e in eps]),
            inv_rot=np.stack([e["inv_rot"] for e in eps]),
            halfdim=np.stack([e["halfdim"] for e in eps]),
            mips=[np.stack([e["mips"][lv] for e in eps])
                  for lv in range(len(eps[0]["mips"]))],
            flatqs=[tuple(t.numpy() for t in flatten_cube_mips_quad(
                [torch.from_numpy(m) for m in e["mips"]])) for e in eps],
            count=np.int32(len(eps)))

    def envbrdf_lut(self):
        """Split-sum env-BRDF LUT (64, 64, 3): the port's tracked copy of
        bake_envbrdf(64, 128), read only (ops.ibl.bake_envbrdf reproduces
        it to 1e-5; tests hold the copy equal to the JAX package's file)."""
        if self._envbrdf is None:
            self._envbrdf = np.load(_ENVBRDF_LUT)
        return self._envbrdf

    def set_colorlut(self, lut, poly_tol=LUT_POLY_TOL):
        """3D grading LUT (S, S, S, 3) in [0, 1].  The frame grades through
        its fitted degree-4 polynomial when the fit's max error is within
        poly_tol, else through the exact trilinear tap (poly_tol=0 forces
        the exact tap)."""
        self._state = None
        from ..ops.composite import fit_lut_poly

        self.colorlut = np.asarray(lut, np.float32)
        self.colorlut_poly = None
        if poly_tol > 0:
            coeffs, err = fit_lut_poly(self.colorlut)
            if err <= poly_tol:
                self.colorlut_poly = coeffs

    def add_material(self, color=(1, 1, 1, 1), metalness=0.0, roughness=1.0,
                     reflectivity=0.5, emissive=0.0, albedomap=TEX_WHITE,
                     surfacemap=TEX_UNIT_SURFACE, normalmap=TEX_FLAT_NORMAL,
                     absorb=0.0) -> int:
        self._state = None
        i = self.n_materials
        self.mat_absorb[i] = absorb
        self.mat_color[i] = color
        self.mat_metalness[i] = metalness
        self.mat_roughness[i] = roughness
        self.mat_reflectivity[i] = reflectivity
        self.mat_emissive[i] = emissive
        self.mat_albedomap[i] = albedomap
        self.mat_surfacemap[i] = surfacemap
        self.mat_normalmap[i] = normalmap
        self.n_materials += 1
        return i

    def add_texture(self, image: np.ndarray) -> int:
        """Add an RGBA uint8 image (any size; resampled to TEX_SIZE)."""
        self._state = None
        img = _to_rgba_u8(image)
        i = self.n_textures
        self.tex_native[i] = img
        self.textures[i] = _resample_nearest(img, TEX_SIZE)
        self.n_textures += 1
        return i

    def add_mesh(self, vertices, indices, **kw) -> MeshHandle:
        """GeometryPool.add_mesh (mincorner=, maxcorner=, rig=)."""
        self._state = None
        return self.pool.add_mesh(vertices, indices, **kw)

    def add_water_material(self, color=(1, 1, 1, 1), metalness=0.0,
                           roughness=0.08, reflectivity=0.9, absorb=0.35,
                           **lut_kw) -> int:
        """Water material: the procedural (depth, facing) colour LUT
        (ops/ocean.py::water_color_lut) as its albedo map; ocean vertices
        carry LUT coordinates."""
        from ..ops.ocean import water_color_lut

        tex = self.add_texture(water_color_lut(**lut_kw))
        return self.add_material(color=color, metalness=metalness,
                                 roughness=roughness, absorb=absorb,
                                 reflectivity=reflectivity, albedomap=tex)

    def add_sprite(self, image, layers=1) -> int:
        """Register an overlay sprite image (RGBA; layers stacked
        vertically) for the device sprite pass; returns the sprite id
        RenderList.push_sprite takes."""
        self._state = None
        self._overlay_cache = None
        self._overlay_images.append((_to_rgba_u8(image), int(layers)))
        return len(self._overlay_images) - 1

    def set_overlay_font(self, font=None):
        """Attach a Font whose atlas joins the overlay atlas (None: the
        builtin 5x7 font); RenderList.push_text draws with it."""
        self._state = None
        self._overlay_cache = None
        if font is None:
            from .sprite import Font
            font = Font.builtin()
        self._overlay_font = font

    def overlay_info(self):
        """The shelf-packed overlay atlas (RGBA u8, a power-of-two width at
        least 64 and the widest entry), each sprite's atlas rect (uv0,
        uv1 in pixels) and layer count, and the font's glyph table placed
        at its atlas origin (RenderList.sprite_arrays reads it)."""
        if self._overlay_cache is None:
            font = self._overlay_font
            entries = [im for im, _ in self._overlay_images]
            if font is not None:
                fa = font.atlas
                if fa.ndim == 2:
                    fa = np.stack([np.full_like(fa, 255)] * 3 + [fa], -1)
                entries = entries + [fa]
            if not entries:
                entries = [np.full((1, 1, 4), 255, np.uint8)]
            aw = max(64, max(e.shape[1] for e in entries))
            aw = int(2 ** np.ceil(np.log2(aw)))
            cx, cy, sh_h = 0, 0, 0
            rects = []
            for e in entries:
                h_, w_ = e.shape[:2]
                if cx + w_ > aw and cx > 0:
                    cy += sh_h
                    cx, sh_h = 0, 0
                rects.append((cx, cy))
                cx += w_
                sh_h = max(sh_h, h_)
            atlas = np.zeros((int(cy + sh_h), aw, 4), np.uint8)
            for e, (x, y) in zip(entries, rects):
                atlas[y:y + e.shape[0], x:x + e.shape[1]] = e
            uv0 = [np.array(r, np.float32) for r in rects[:len(self._overlay_images)]]
            uv1 = [r + np.array([e.shape[1], e.shape[0]], np.float32)
                   for r, (e, _) in zip(uv0, self._overlay_images)]
            info = dict(atlas=atlas, uv0=uv0, uv1=uv1,
                        layers=[n for _, n in self._overlay_images])
            if font is not None:
                info["font"] = dict(
                    origin=np.array(rects[-1], np.float32),
                    x=np.asarray(font.x), y=np.asarray(font.y),
                    width=np.asarray(font.width), height=np.asarray(font.height),
                    offsetx=np.asarray(font.offsetx),
                    offsety=np.asarray(font.offsety),
                    advance=np.asarray(font.advance), glyph_index=font.glyph_index)
            self._overlay_cache = info
        return self._overlay_cache

    def host_state(self):
        """The device state as a numpy tree (the layout of the JAX
        package's RenderContext.device_state); the skybox's tables are
        the tensors set_skybox baked, on the sky's device."""
        state = dict(geometry=self.pool.host_arrays(),
                     materials=self._material_arrays(), textures=self.textures)
        self._rebuild_matmaps(state)
        if self._ibl is not None:
            state["ibl"] = self._ibl
            if self._envprobes:
                state["ibl"] = dict(self._ibl, envprobes=self._envprobe_state())
        if self.colorlut_poly is not None:
            state["colorlut_poly"] = self.colorlut_poly
        elif self.colorlut is not None:
            state["colorlut"] = self.colorlut
        if self.config.max_overlay_sprites > 0:
            state["overlay_atlas"] = (self.overlay_info()["atlas"].astype(np.float32)
                                      / np.float32(255.0))
        return state

    def device_state(self, device):
        """The pools as torch tensors on `device`."""
        return to_torch(self.host_state(), device)

    def _material_arrays(self):
        return dict(color=self.mat_color, metalness=self.mat_metalness,
                    roughness=self.mat_roughness, reflectivity=self.mat_reflectivity,
                    emissive=self.mat_emissive, albedomap=self.mat_albedomap,
                    surfacemap=self.mat_surfacemap, normalmap=self.mat_normalmap)

    def _rebuild_matmaps(self, state, rows_only=False):
        """Combined material-map mip table (one 48-byte quad row per texel
        holds albedo+surface+normal) and the packed per-material rows
        (color rgb, emissive, metalness, roughness, reflectivity, albedo
        id, matmap base, matmap size, absorb, 0) the raster reads.
        rows_only: re-pack the rows with the last table's bases and sizes
        (the table depends only on the map triples and their texels)."""
        from .texturepool import build_matmap_pool

        nm = self.mat_color.shape[0]
        if not rows_only:
            triples = [(int(self.mat_albedomap[m]), int(self.mat_surfacemap[m]),
                        int(self.mat_normalmap[m]))
                       for m in range(max(self.n_materials, 1))]
            table, base, size = build_matmap_pool(
                triples, self.tex_native, max_size=self.config.matmap_max_size)
            base_full = np.zeros(nm, np.int32)
            size_full = np.ones(nm, np.int32)
            base_full[:len(triples)] = base
            size_full[:len(triples)] = size
            state["matmaps"] = dict(table=table, base=base_full, size=size_full)
            self._matmap_rows = (base_full, size_full)
        base_full, size_full = self._matmap_rows
        packed = np.concatenate([
            self.mat_color[:, :3],
            self.mat_emissive[:, None], self.mat_metalness[:, None],
            self.mat_roughness[:, None], self.mat_reflectivity[:, None],
            self.mat_albedomap[:, None].astype(np.float32),
            base_full[:, None].astype(np.float32),
            size_full[:, None].astype(np.float32),
            self.mat_absorb[:, None],
            np.zeros((nm, 1), np.float32)], axis=1)
        state["materials"] = dict(state["materials"],
                                  packed10=packed.astype(np.float32))

    def update_material(self, i, **fields):
        """Live-edit material i (fields: color, metalness, roughness,
        reflectivity, emissive, absorb, albedomap, surfacemap, normalmap).
        A rendered context's device state keeps everything but the
        material rows, which are re-packed and uploaded; an edit of a map
        binding also rebuilds and uploads the material-map table."""
        for k, v in fields.items():
            getattr(self, f"mat_{k}")[i] = v
        if self._state is not None:
            self._upload_materials(rows_only=not (
                {"albedomap", "surfacemap", "normalmap"} & fields.keys()))

    def update_texture(self, i, image):
        """Live-edit texture slot i (any image, resampled to TEX_SIZE).  A
        rendered context's device pool gets that one slot patched in
        place, and the material-map table (whose mips come from the
        texels) is rebuilt and uploaded."""
        img = _to_rgba_u8(image)
        self.tex_native[i] = img
        self.textures[i] = _resample_nearest(img, TEX_SIZE)
        if self._state is not None:
            self._state["textures"][i] = torch.from_numpy(self.textures[i]).to(
                self.device)
            self._upload_materials()

    def _upload_materials(self, rows_only=False):
        """Replace the device state's material rows (and, unless
        rows_only, its material-map table) with the host's."""
        part = dict(materials=self._material_arrays())
        self._rebuild_matmaps(part, rows_only=rows_only)
        self._state = dict(self._state, **to_torch(part, self.device))

    def expand_host(self, draws):
        """Attach the host-precomputed draw expansion (numpy) in place
        (frame.expand_draws_host), to draws["translucent"] too when the
        draws carry it."""
        from .frame import attach_host_expansion

        cfg = self.config
        return attach_host_expansion(self.pool, draws, cfg.max_vertices,
                                     cfg.max_triangles, cfg.max_translucent_tris)

    @traced("build.draws")
    def frame_draws(self, renderlist, camera):
        """The draws tree of one frame, as the JAX package's
        RenderContext.render builds it: the draw arrays (with the
        skinning palettes under enable_skinning) plus, for the capacities
        the config carries, the particle billboards ("forward"), the
        translucent draws, the decals, the fog planes, the overlay sprites
        and text (split to the viewport's overlay region) and the
        dynamic-vertex slab ("dyn": the first ocean's vertices on its
        device, else a zero slab of count 0); then the host expansion."""
        cfg = self.config
        draws = renderlist.draw_arrays(
            cfg.max_instances, self.default_material,
            max_palettes=cfg.max_palettes if cfg.enable_skinning else 0,
            max_bones=cfg.max_bones)
        if cfg.max_particle_quads > 0:
            draws["forward"] = renderlist.forward_arrays(cfg.max_particle_quads,
                                                         camera)
        if cfg.max_translucent_draws > 0:
            draws["translucent"] = renderlist.translucent_arrays(
                cfg.max_translucent_draws, self.default_material)
        if cfg.max_decals_active > 0:
            draws["decals"] = renderlist.decal_arrays(cfg.max_decals_active)
        if cfg.max_fog_planes > 0:
            draws["fogplanes"] = renderlist.fogplane_arrays(cfg.max_fog_planes)
        if cfg.max_overlay_sprites > 0:
            draws["sprites"] = renderlist.sprite_arrays(
                self.overlay_info(), cfg.max_overlay_sprites, self.overlay_region())
        if cfg.max_dynamic_vertices > 0:
            md = cfg.max_dynamic_vertices
            if renderlist.oceans:
                draws["dyn"] = renderlist.oceans[0].vertex_data(md, camera.position)
            else:
                draws["dyn"] = dict(
                    positions=np.zeros((md, 3), np.float32),
                    normals=np.zeros((md, 3), np.float32),
                    texcoords=np.zeros((md, 2), np.float32),
                    offset=np.int32(0), count=np.int32(0))
        return self.expand_host(draws)

    def overlay_region(self):
        """The sprite pass's window side: FrameConfig.overlay_region, at
        most the padded viewport."""
        cfg = self.config
        return min(cfg.overlay_region, cfg.padded_width, cfg.padded_height)

    def resize(self, width, height):
        """Render at a new viewport size from the next frame: every pool
        and the device state carry over; the depth plane and the SSAO
        history reset."""
        if (width, height) == (self.config.width, self.config.height):
            return
        self.config = dataclasses.replace(self.config, width=int(width),
                                          height=int(height))
        self.last_depth = None
        self._ao_prev = None

    def render(self, camera, renderlist, params, sceneset=None):
        """Render one frame on self.device; returns a numpy uint8 (height,
        width, 3) image (the JAX package's RenderContext.render).  The
        renderlist's SH probes go into the sceneset, its sprites and text
        into the frame's sprite pass (max_overlay_sprites > 0).  With
        params.scale != 1 the frame renders at (round(width * scale) & ~1,
        round(height * scale) & ~1), at least 2 each, a nearest blit by
        integer indices scales it back to the viewport, and the sprites
        composite after the blit, in display coordinates.  With
        ssao_temporal, the frame's AO feeds the next frame's temporal
        reprojection; the history is keyed on the rendered size and
        resets when it changes.  Sets self.luminance, self.bin_overflow
        (a nonzero count also goes to the debug gauge
        "raster.bin_overflow" and is logged once) and self.last_depth:
        the frame's reverse-Z depth cropped to the rendered size, a
        tensor on self.device."""
        from ..debug.debug import log_once, resource_use
        from ..ops.composite import to_u8_image
        from ..ops.sprite_pass import composite_sprites
        from . import frame as frame_mod
        from .types import make_sceneset

        cfg = self.config
        scale = float(getattr(params, "scale", 1.0) or 1.0)
        if scale != 1.0:
            cfg = dataclasses.replace(
                cfg, width=max(int(round(cfg.width * scale)) & ~1, 2),
                height=max(int(round(cfg.height * scale)) & ~1, 2))
        if sceneset is None:
            sceneset = make_sceneset(camera, params,
                                     point_lights=renderlist.point_lights,
                                     spot_lights=renderlist.spot_lights,
                                     probes=renderlist.probes)
        draws = self.frame_draws(renderlist, camera)
        sprites_display = draws.pop("sprites", None) if scale != 1.0 else None
        prev = None
        if cfg.ssao_temporal and cfg.enable_ssao and self._ao_prev is not None:
            prev = {k: v for k, v in self._ao_prev.items() if k != "_cfg"}
            if self._ao_prev["_cfg"] != (cfg.width, cfg.height):
                prev = None                # resolution changed mid-run
        if self._state is None:
            self._state = self.device_state(self.device)
        out = frame_mod.render_frame(cfg, self._state, draws,
                                     sceneset, device=self.device, prev=prev)
        if cfg.ssao_temporal and "ao_prev" in out:
            self._ao_prev = dict(out["ao_prev"], _cfg=(cfg.width, cfg.height))
        self.luminance = float(out["luminance"])
        self.bin_overflow = int(out["bin_overflow"])
        if self.bin_overflow:
            resource_use("raster.bin_overflow", self.bin_overflow, cfg.bin_capacity)
            log_once(f"raster: {self.bin_overflow} (tile, tri) pairs dropped — "
                     "raise FrameConfig.bin_capacity or bin_max_span")
        self.last_depth = out["depth"][:cfg.height, :cfg.width]
        img = out["image"]
        if scale != 1.0:
            vh, vw = self.config.height, self.config.width
            dev = img.device
            yi = torch.arange(vh, device=dev) * img.shape[0] // vh
            xi = torch.arange(vw, device=dev) * img.shape[1] // vw
            img = img[yi.clamp(0, img.shape[0] - 1)][:, xi.clamp(0, img.shape[1] - 1)]
            if sprites_display is not None:
                # a tensor divisor: the card divides by a host scalar through
                # its reciprocal, the reference's division is exact
                rgb = img.to(torch.float32) / torch.tensor(255.0, device=dev)
                img = to_u8_image(composite_sprites(
                    rgb, to_torch(sprites_display, dev), self._state["overlay_atlas"],
                    self.overlay_region()))
        return img.cpu().numpy()


def render_fallback(width, height, tick=0):
    """The loader frame shown before the scene is ready: a dark scan
    background and the animated "DATUM TPU / LOADING..." title in the
    builtin font, a numpy uint8 (height, width, 3) image."""
    from .sprite import Font, draw_text

    img = np.zeros((height, width, 3), np.uint8)
    ys = (np.arange(height)[:, None] + tick) % 32
    img[..., 2] = (ys < 2) * 24
    font = Font.builtin()
    text = "DATUM TPU"
    tw = len(text) * 6 * 2
    draw_text(img, font, text, (width - tw) // 2, height // 2 - 8,
              tint=(0.9, 0.9, 1.0, 1.0), scale=2)
    draw_text(img, font, "LOADING" + "." * (1 + tick // 20 % 3), (width - tw) // 2,
              height // 2 + 14, tint=(0.5, 0.5, 0.6, 1.0))
    return img
