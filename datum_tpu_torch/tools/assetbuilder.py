"""The core asset pack (counterpart of datum_tpu/tools/assetbuilder.py).

build_core_pack writes core.pack with the built-in meshes, the LUTs, the
default and procedural textures, the default material, particle system
and debug font, and one TEXT asset per shader entry.  A shader entry
holds no SPIR-V: it names the port's function that implements the
pipeline (KERNEL_REGISTRY; a part after '#' is a label), so the pack
keeps the reference's id layout, magic and version.  The bakes run on
the port's own ops.  pack_ttf_font writes a TrueType font as FONT + IMAG.

    python -m datum_tpu_torch.tools.assetbuilder [OUT.pack]
"""

from __future__ import annotations

import numpy as np

from ..asset.corepack import CORE_MAGIC, CORE_VERSION, CoreAsset
from ..asset.pack import PackWriter, VERTEX_DTYPE, IMAGE_RGBA, IMAGE_RGBE, IMAGE_F32
from ..math import color as color_codec
from ..render import primitives


def _mesh_payload(verts_dict, idx):
    n = len(verts_dict["position"])
    v = np.zeros(n, VERTEX_DTYPE)
    v["position"] = verts_dict["position"]
    v["texcoord"] = verts_dict["texcoord"]
    v["normal"] = verts_dict["normal"]
    v["tangent"] = verts_dict["tangent"]
    return v, np.asarray(idx, np.int32)


# every kernel-backed pipeline in the core pack: id -> the port's
# implementing symbol (module.function; the K5 raster stands for the JAX
# package's raster_pallas, the K1 entry for raster_shade_pallas)
KERNEL_REGISTRY = {
    CoreAsset.cluster_comp: "datum_tpu_torch.ops.cluster.bin_lights",
    CoreAsset.lighting_comp: "datum_tpu_torch.ops.lighting_pass.shade_deferred",
    CoreAsset.ssao_comp: "datum_tpu_torch.ops.ssao.hbao",
    CoreAsset.ssr_comp: "datum_tpu_torch.ops.ssr.ssr",
    CoreAsset.depth_blit_comp: "datum_tpu_torch.ops.raster_v1_cuda.raster_v1",
    # the Hi-Z pyramid (reference data/depth.mip.comp): ssr2's
    # direction-binned dense march needs no mip walk
    CoreAsset.depth_mip_comp: "datum_tpu_torch.ops.ssr2.ssr_binned",
    CoreAsset.esm_gen_comp: "datum_tpu_torch.ops.shadow.build_esm",
    CoreAsset.esm_hblur_comp: "datum_tpu_torch.ops.blur.gaussian_blur",
    CoreAsset.esm_vblur_comp: "datum_tpu_torch.ops.blur.gaussian_blur",
    CoreAsset.fog_density_comp: "datum_tpu_torch.ops.fog.build_fog_volume",
    CoreAsset.fog_scatter_comp: "datum_tpu_torch.ops.fog.build_fog_volume",
    CoreAsset.luminance_comp: "datum_tpu_torch.render.frame._frame#luminance",
    CoreAsset.bloom_luma_comp: "datum_tpu_torch.ops.bloom.bloom",
    CoreAsset.bloom_hblur_comp: "datum_tpu_torch.ops.blur.gaussian_blur",
    CoreAsset.bloom_vblur_comp: "datum_tpu_torch.ops.blur.gaussian_blur",
    CoreAsset.color_hblur_comp: "datum_tpu_torch.ops.blur.gaussian_blur",
    CoreAsset.color_vblur_comp: "datum_tpu_torch.ops.blur.gaussian_blur",
    CoreAsset.convolve_comp: "datum_tpu_torch.ops.ibl.convolve_cubemap",
    CoreAsset.project_comp: "datum_tpu_torch.ops.ibl.sh_project",
    CoreAsset.skybox_gen_comp: "datum_tpu_torch.ops.skybox_gen.generate_skybox",
    CoreAsset.ocean_sim_comp: "datum_tpu_torch.ops.ocean.ocean_maps",
    CoreAsset.ocean_fftx_comp: "datum_tpu_torch.ops.ocean.ocean_maps#ifft2",
    CoreAsset.ocean_ffty_comp: "datum_tpu_torch.ops.ocean.ocean_maps#ifft2",
    CoreAsset.ocean_map_comp: "datum_tpu_torch.ops.ocean.ocean_maps",
    CoreAsset.ocean_gen_comp: "datum_tpu_torch.ops.ocean.displace_grid",
    CoreAsset.geometry_frag: "datum_tpu_torch.ops.raster_cuda.raster_shade",
    CoreAsset.prepass_frag: "datum_tpu_torch.ops.raster_v1_cuda.raster_v1",
    CoreAsset.shadow_frag: "datum_tpu_torch.ops.shadow.render_shadow_cascades",
    CoreAsset.model_geometry_vert: "datum_tpu_torch.ops.geometry.transform_vertices_rigid",
    CoreAsset.actor_geometry_vert: "datum_tpu_torch.ops.geometry.transform_vertices_skinned",
    CoreAsset.weightblend_frag: "datum_tpu_torch.ops.blend.resolve_oit",
    CoreAsset.particle_frag: "datum_tpu_torch.ops.blend.raster_blend",
    CoreAsset.composite_frag: "datum_tpu_torch.ops.composite.composite",
    CoreAsset.sprite_frag: "datum_tpu_torch.render.sprite.blit_sprite",
    CoreAsset.fogplane_frag: "datum_tpu_torch.ops.fog.apply_fog_planes",
    CoreAsset.ocean_frag: "datum_tpu_torch.ops.ocean.ocean_lut_uv",
    CoreAsset.water_frag: "datum_tpu_torch.render.water.Water",
    CoreAsset.foilage_geometry_vert: "datum_tpu_torch.render.frame._frame#foliage",
    CoreAsset.gizmo_frag: "datum_tpu_torch.render.overlay.draw_gizmo",
    CoreAsset.wireframe_frag: "datum_tpu_torch.render.overlay.draw_wireframe",
    CoreAsset.stencilmask_frag: "datum_tpu_torch.render.overlay.draw_fill",
    CoreAsset.stencilfill_frag: "datum_tpu_torch.render.overlay.draw_fill",
    CoreAsset.outline_frag: "datum_tpu_torch.render.overlay.draw_outline",
    CoreAsset.line_frag: "datum_tpu_torch.render.overlay.draw_lines",
}


def build_core_pack(path, *, envbrdf_size=64, skybox_size=64, lut_size=16,
                    compress=True):
    """Build core.pack.  Returns the catalog dict."""
    w = PackWriter()
    catalog = {int(k): v for k, v in KERNEL_REGISTRY.items()}
    w.write_catalog(CoreAsset.catalog, CORE_MAGIC, CORE_VERSION,
                    {int(k): str(v) for k, v in KERNEL_REGISTRY.items()})

    # default textures
    white = np.full((1, 4, 4), 0xFFFFFFFF, np.uint32)
    w.write_image(CoreAsset.white_diffuse, 4, 4, 1, 1, IMAGE_RGBA, white.tobytes())
    nominal = color_codec.pack_rgba(np.tile([0.5, 0.5, 1.0, 1.0], (1, 4, 4, 1)))
    w.write_image(CoreAsset.nominal_normal, 4, 4, 1, 1, IMAGE_RGBA, nominal.tobytes())
    zero = np.zeros((1, 4, 4), np.uint32)
    w.write_image(CoreAsset.zero_depth, 4, 4, 1, 1, IMAGE_RGBA, zero.tobytes())

    # built-in meshes
    for cid, make in [(CoreAsset.unit_quad, primitives.unit_quad),
                      (CoreAsset.unit_cube, primitives.unit_cube),
                      (CoreAsset.unit_cone, primitives.unit_cone),
                      (CoreAsset.unit_hemi, primitives.unit_hemi),
                      (CoreAsset.unit_sphere, primitives.unit_sphere)]:
        vd, idx = make()
        v, i = _mesh_payload(vd, idx)
        w.write_mesh(cid, v, i, v["position"].min(0), v["position"].max(0),
                     compress=compress)

    # line-list meshes for the overlay pipelines (reference: corepack.h
    # line_quad/cube/cone).  The pack mesh format is triangle-list; each
    # line segment (a, b) encodes as the degenerate triangle (a, b, b) —
    # the overlay reader decodes pairs from the first two indices.
    for cid, make in [(CoreAsset.line_quad, primitives.line_quad),
                      (CoreAsset.line_cube, primitives.line_cube),
                      (CoreAsset.line_cone, primitives.line_cone)]:
        pos, edges = make()
        v = np.zeros(len(pos), VERTEX_DTYPE)
        v["position"] = pos
        v["normal"] = [0, 0, 1]
        v["tangent"] = [1, 0, 0, 1]
        tri = np.stack([edges[:, 0], edges[:, 1], edges[:, 1]],
                       -1).astype(np.int32).reshape(-1)
        w.write_mesh(cid, v, tri, pos.min(0), pos.max(0), compress=compress)

    # kernel entries as TEXT assets (keep id layout)
    for cid, name in KERNEL_REGISTRY.items():
        w.write_text(cid, name.encode())

    # env BRDF LUT (f32 image, 3ch packed as rgbe in the reference; we
    # store f32 rows [a, b, c, 0])
    from ..ops.ibl import bake_envbrdf
    lut = bake_envbrdf(envbrdf_size, 64)
    lut4 = np.concatenate([lut, np.zeros(lut.shape[:2] + (1,), np.float32)], -1)
    w.write_image(CoreAsset.envbrdf_lut, envbrdf_size, envbrdf_size, 1, 1,
                  IMAGE_F32, lut4.astype(np.float32).tobytes(), compress=compress)

    # default skybox (procedural, RGBE-encoded cube faces as 6 layers)
    from ..ops.skybox_gen import generate_skybox
    sky = np.asarray(generate_skybox(
        skybox_size, skycolor=(0.65, 0.57, 0.475), groundcolor=(0.41, 0.37, 0.32),
        sundirection=np.array([-0.4, -0.7, -0.6]) / np.linalg.norm([-0.4, -0.7, -0.6]),
        sunintensity=(8.0, 7.56, 7.88)))
    rgbe = color_codec.pack_rgbe(sky)
    w.write_image(CoreAsset.default_skybox, skybox_size, skybox_size, 6, 1,
                  IMAGE_RGBE, rgbe.astype(np.uint32).tobytes(), compress=compress)

    # identity color LUT
    g = np.linspace(0, 1, lut_size, dtype=np.float32)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")
    lut3 = np.stack([r, gg, b, np.ones_like(r)], -1)
    w.write_image(CoreAsset.color_lut, lut_size, lut_size, lut_size, 1,
                  IMAGE_RGBA, color_codec.pack_rgba(lut3).tobytes(), compress=compress)

    # water / cloud / noise textures (reference: assetbuilder.cpp packs
    # wave_color via image_pack_watercolor + wave/cloud/noise images;
    # here all procedurally baked — deterministic, seed-fixed)
    from ..math.perlin import PerlinEngine
    from ..ops.ocean import water_color_lut

    wc = np.asarray(water_color_lut(64))
    if wc.shape[-1] == 3:
        wc = np.concatenate([wc, np.ones(wc.shape[:2] + (1,), np.float32)], -1)
    w.write_image(CoreAsset.wave_color, wc.shape[1], wc.shape[0], 1, 1,
                  IMAGE_RGBA, color_codec.pack_rgba(wc[None]).tobytes(),
                  compress=compress)

    def _tiled_height(seed, n=64, freq=4.0, octaves=3):
        p = PerlinEngine(seed)
        g = (np.arange(n) + 0.5) / n
        xx, yy = np.meshgrid(g, g, indexing="xy")
        h = np.zeros((n, n), np.float32)
        amp, f = 1.0, freq
        for _ in range(octaves):
            # torus trick keeps the texture tileable
            a, b = np.cos(2 * np.pi * xx) * f / 6.0, np.sin(2 * np.pi * xx) * f / 6.0
            c = np.cos(2 * np.pi * yy) * f / 6.0
            h += amp * np.asarray(p.noise3(a, b, c), np.float32)
            amp *= 0.5
            f *= 2.0
        return h

    def _normal_from_height(h, strength=2.0):
        gx = np.roll(h, -1, 1) - np.roll(h, 1, 1)
        gy = np.roll(h, -1, 0) - np.roll(h, 1, 0)
        n = np.stack([-gx * strength, -gy * strength, np.ones_like(h)], -1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        return n * 0.5 + 0.5

    for cid, seed, strength in [(CoreAsset.wave_normal, 11, 0.8),
                                (CoreAsset.cloud_normal, 23, 0.4),
                                (CoreAsset.noise_normal, 37, 0.6)]:
        nm = _normal_from_height(_tiled_height(seed), strength)
        img = np.concatenate([nm, np.ones(nm.shape[:2] + (1,), np.float32)], -1)
        w.write_image(cid, 64, 64, 1, 1, IMAGE_RGBA,
                      color_codec.pack_rgba(img[None]).tobytes(),
                      compress=compress)

    for cid, seed in [(CoreAsset.wave_foam, 13), (CoreAsset.cloud_density, 29)]:
        h = _tiled_height(seed, octaves=4)
        g = np.clip(np.abs(h) * 1.8, 0.0, 1.0)
        img = np.stack([g, g, g, g], -1).astype(np.float32)
        w.write_image(cid, 64, 64, 1, 1, IMAGE_RGBA,
                      color_codec.pack_rgba(img[None]).tobytes(),
                      compress=compress)

    # loader / test images (reference: loader_image, test_image)
    from ..render.context import render_fallback
    loader = render_fallback(128, 64, tick=0).astype(np.float32) / 255.0
    loader4 = np.concatenate(
        [loader, np.ones(loader.shape[:2] + (1,), np.float32)], -1)
    w.write_image(CoreAsset.loader_image, 128, 64, 1, 1, IMAGE_RGBA,
                  color_codec.pack_rgba(loader4[None]).tobytes(),
                  compress=compress)
    ti, tj = np.indices((64, 64))
    tc = (((ti // 8) + (tj // 8)) % 2).astype(np.float32)
    test_img = np.stack([tc, 1.0 - tc, tc * 0.5, np.ones_like(tc)], -1)
    w.write_image(CoreAsset.test_image, 64, 64, 1, 1, IMAGE_RGBA,
                  color_codec.pack_rgba(test_img[None]).tobytes(),
                  compress=compress)

    # default particle system (reference: default_particle — a minimal
    # white puff emitter; emitter payload is the engine-native blob)
    w.write_particlesystem(CoreAsset.default_particle, (0, 0, 0), (1, 1, 1),
                           100, 0, int(CoreAsset.white_diffuse), b"")

    # default material + debug font
    w.write_material(CoreAsset.default_material, color=(0.75, 0.75, 0.75, 1))
    from ..render.sprite import Font
    font = Font.builtin()
    atlas_rgba = color_codec.pack_rgba(font.atlas.astype(np.float32) / 255.0)
    w.write_image(900, font.atlas.shape[1], font.atlas.shape[0], 1, 1,
                  IMAGE_RGBA, atlas_rgba[None].tobytes())
    n = font.glyphcount
    w.write_font(CoreAsset.debug_font, 900, font.ascent, font.descent,
                 font.leading, font.x, font.y, font.width, font.height,
                 font.offsetx, font.offsety, font.advance)

    w.save(path)
    return catalog



def pack_ttf_font(writer, font_id, atlas_id, ttf_path, size=24, chars=None,
                  compress=False):
    """Bake a TrueType font and write it as FONT + IMAG chunks
    (reference: assetbuilder.cpp font path via Qt; here tools/ttf.py)."""
    from ..asset.pack import IMAGE_RGBA
    from ..math import color as color_codec
    from .ttf import bake_font

    kw = dict(chars=chars) if chars else {}
    font = bake_font(ttf_path, size=size, **kw)
    atlas_rgba = color_codec.pack_rgba(font.atlas.astype(np.float32) / 255.0)
    writer.write_image(atlas_id, font.atlas.shape[1], font.atlas.shape[0],
                       1, 1, IMAGE_RGBA, atlas_rgba[None].tobytes(),
                       compress=compress)
    writer.write_font(font_id, atlas_id, font.ascent, font.descent,
                      font.leading, font.x, font.y, font.width, font.height,
                      font.offsetx, font.offsety, font.advance)
    return font


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "core.pack"
    build_core_pack(out)
    print(f"built {out}")
