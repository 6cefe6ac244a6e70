"""The frame (counterpart of datum_tpu/render/frame.py `_frame`).

Every branch starts with the vertex stage: the dynamic-vertex slab
(an ocean's displaced grid) patched into a copy of the geometry pool
(patch_dynamic), host draw expansion (numpy) -> attribute gather -> the
foliage wind bends, dual-quaternion skinning and the terrain geomorph,
each under its flag -> rigid transform.

The megakernel branch (`use_shade_kernel` with `use_pallas`, a 'mip'
texture filter and ESM sun shadows), in order: the vertex stage ->
sun cascades (K3, ops/raster_depth_cuda.py) and their ESM, parabolic or
perspective spot maps (K3) and their ESM -> triangle setup and binning
into 32x128 tiles -> K1 fused visibility raster, or K6 with
raster_two_phase (ops/raster_cuda.py; with raster_early_z K1, K6 and K3
end their walks early) -> plane assembly at half resolution with the
skybox environment (and the box environment probes' quarter-res
fields, ops/envprobe.py: their specular blends into the env field,
their diffuse goes to K2 as the edr/edg/edb/edm override planes), one
batched upsample, the quarter-res sun factor, then the decals
(ops/decal.py), SSAO (ops/ssao.py, with its temporal
history), the spot factors, sky planes and the froxel fog planes
(ops/fog.py) -> the lit translucent layers (K1 or K6 with alpha_in_alb
and peel, plane assembly and K2 on a 1/translucent_lit_scale viewport,
upsampled) -> one merged weighted-blend OIT stream of the residual
translucents and the particle billboards (K4, ops/raster_blend_cuda.py)
-> the clustered lights' per-tile lists (ops/cluster.py,
use_light_clusters) -> K2 deferred-shade megakernel and its
translucent/fog/OIT epilogue (ops/shade_cuda.py) -> the analytic fog
planes (ops/fog.py::apply_fog_planes) -> luminance, SSR (binned at
quarter resolution, ops/ssr2.py, or the DDA march at half resolution,
ops/ssr.py), bloom, depth of field, composite with the colour grade,
u8.

Every other config takes the deferred branch (FrameConfig's defaults
among them): sun cascades (ESM or PCF) and perspective spot maps, K3
with `use_pallas`, else the scan raster -> the visibility raster: K1
(no material maps) or K7 (`raster_kernel="mxu"`, ops/raster_mxu_cuda.py)
with `gbuffer_from_planes`, or K5 (ops/raster_v1_cuda.py) or the scan
raster (ops/raster.py::raster, without `use_pallas`) with
`resolve_gbuffer` -> gbuffer decals, SSAO -> the XLA lighting
(ops/lighting_pass.py::shade_deferred, with the box probes' per-pixel
lookup) -> sky fill, fog apply, fog planes -> two separate
weighted-blend passes, translucents then particles (K4 with
`use_pallas`, else ops/blend.py::raster_blend) -> the same post.
Without `use_pallas` the rasters and the blend are plain PyTorch on the
card too: that is the reference's own algorithm for the flag, not a
fallback.

PyTorch runs eagerly, so there is no jit: each pass is a plain function
on tensors, and the frame is one call of `render_frame`.  On a CUDA
device every frame with `use_pallas` (the megakernel branch, and the
deferred branch's K5, K1 and K7 routes) is captured as CUDA graphs
after its first frame and replayed (render/framegraph.py).  K1, K2, K5
and K4 launch between the graphs, through their wrappers, where the
benchmark's roofline readers see their inputs.  The frame's code is the
same either way and reads no device value on the host: the deferred
branch's dense light loops take their trip counts from the host tree
(`host_light_counts`).  Without `use_pallas` the frame stays eager: the
scan raster reads device values on the host.

Band mode: the megakernel branch's stages from the raster to K2
(`shade_band`) also run on a band of whole tile rows of the frame, for
the tile-sharded frame (parallel/sharded.py).  `band` is then a dict:
y0 (the band's first row), full_h (the frame's padded height), tile0
(the frame tile of its first tile), up_to(x, h, w) and up_to_batch(x3,
h, w) (the upsamplers of reduced-resolution fields: all-gather, upsample
the whole frame's field, slice the band back out), prev_row(x) (the row
above a band-local field's first row, from the band above), and, when
given, ao (the band's SSAO factor) and fogvol (the froxel fog volume).
The post passes (`post_rgb`) take two more: gather(x, label) (all-gather
a band's reduced-resolution field into the frame's, along rows) and
rows(x) (the band's rows of a frame-sized field).
Planes stay band-sized; the NDC of every pixel comes from the frame's
rows.  The lit translucent layers then run at the frame's resolution
whatever translucent_lit_scale says, as the JAX package's band mode
does.  With band None every stage gives what it gives the whole frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import to_torch
from ..debug.debug import statistic_hit, traced, tracing
from ..ops import blend as blend_ops
from ..ops import brdf
from ..ops import fog as fog_ops
from ..ops import lighting_pass
from ..ops import raster as raster_ops
from ..ops import shadow as shadow_ops
from ..ops.blur import (downsample2, downsample_pool, gaussian_blur, resize_matmul,
                        resize_up_dense, resize_up_dense_batch)
from ..ops.bloom import bloom_quarter
from ..ops.cluster import bin_lights, tile_depth_bounds
from ..ops.common import (TILE_H, TILE_W, FrameConfig, constant, device_cached, round_up,
                          texel_index)
from ..ops.composite import composite, to_u8_image
from ..ops.decal import apply_decals, apply_decals_planes
from ..ops.envprobe import env_probe_fields
from ..ops.geometry import skin_vertices, terrain_morph, transform_vertices_rigid
from ..ops.ibl import rotate_sh9
from ..ops.lighting_pass import _inv_proj, reconstruct_positions, view_ray_grid
from ..ops.raster_blend_cuda import raster_blend
from ..ops.raster_cuda import raster_shade
from ..ops.raster_mxu_cuda import raster_shade_mxu
from ..ops.raster_v1_cuda import raster_v1
from ..ops.sampling import (sample_cubemap, sample_cubemap_lod_flat,
                            sample_cubemap_lod_pair, sample_cubemap_lod_quad)
from ..ops.shade import gbuffer_from_planes, resolve_gbuffer, sample_matmaps
from ..ops.shade_cuda import MAX_TR_LAYERS, SHADE_ROWS, shade_deferred
from ..ops.ssao import hbao, make_hbao_params
from ..ops.ssr import ssr as ssr_dda
from ..ops.sprite_pass import composite_sprites
from ..ops.ssr2 import ssr_binned
from . import framegraph
from .framegraph import span
from .renderlist import RenderList

# the channels of the sampled material maps that the plane assembly
# upsamples: albedo rgb, surface metalness, reflectivity and roughness,
# normal map xyz
MATMAP_PLANES = (0, 1, 2, 4, 5, 7, 8, 9, 10)
LUMA_REC709 = (0.2126, 0.7152, 0.0722)


@device_cached(maxsize=8)
def quad_triangles(max_quads, device):
    """RenderList.quad_triangles(max_quads) on device, built once."""
    return torch.from_numpy(RenderList.quad_triangles(max_quads)).to(device)


@traced("build.expand")
def expand_draws_host(pool, draw_mesh, draw_count, max_v, max_t):
    """Host-side (numpy) draw expansion into vertex/triangle streams at
    static capacity: the indices depend only on the draw list's mesh ids
    and the pool's offsets, so the host computes them."""
    draw_mesh = np.asarray(draw_mesh)
    D = draw_mesh.shape[0]
    n = int(draw_count)
    dv = np.zeros(D, np.int64)
    dt = np.zeros(D, np.int64)
    dv[:n] = pool.mesh_vtx_count[draw_mesh[:n]]
    dt[:n] = pool.mesh_tri_count[draw_mesh[:n]]
    cv = np.cumsum(dv)
    ct = np.cumsum(dt)
    total_v = int(min(cv[-1], max_v))
    total_t = int(min(ct[-1], max_t))

    vtx_draw = np.full(max_v, D - 1, np.int32)
    vd = np.repeat(np.arange(D, dtype=np.int32), dv)[:total_v]
    vtx_draw[:total_v] = vd
    av = np.arange(max_v, dtype=np.int64)
    local_v = av[:total_v] - (cv - dv)[vd]
    src_v = np.zeros(max_v, np.int32)
    src_v[:total_v] = pool.mesh_vtx_offset[draw_mesh[vd]] + local_v
    v_valid = av < total_v

    tri_draw = np.full(max_t, D - 1, np.int32)
    td = np.repeat(np.arange(D, dtype=np.int32), dt)[:total_t]
    tri_draw[:total_t] = td
    at = np.arange(max_t, dtype=np.int64)
    local_t = at[:total_t] - (ct - dt)[td]
    src_t = pool.mesh_tri_offset[draw_mesh[td]] + local_t
    t_valid = at < total_t

    tris = np.zeros((max_t, 3), np.int32)
    startv = (cv - dv)[td].astype(np.int64)
    tris[:total_t] = (pool.triangles[src_t] + startv[:, None]
                      - pool.mesh_vtx_offset[draw_mesh[td]][:, None])

    return dict(src_v=src_v, vtx_draw=vtx_draw, v_valid=v_valid,
                tris=tris, tri_draw=tri_draw, t_valid=t_valid)


def attach_host_expansion(pool, draws, max_v, max_t, max_translucent_t):
    """expand_draws_host + the per-triangle material, attached in place
    (called by RenderContext.expand_host), for the opaque draws and, when
    present, the translucent ones (draws["translucent"], expanded at
    max_translucent_t triangles as the JAX frame expands them on the
    device)."""
    for d, mt in ((draws, max_t), (draws.get("translucent"), max_translucent_t)):
        if d is not None:
            d.update(expand_draws_host(pool, d["mesh"], d["count"], max_v, mt))
            d["tri_mat"] = np.asarray(d["material"])[d["tri_draw"]]
    return draws


def patch_dynamic(cfg: FrameConfig, state, draws):
    """The dynamic-vertex slab: with max_dynamic_vertices md > 0, the
    state with a copy of its geometry whose attr12 rows start .. start +
    md - 1 take draws["dyn"]'s positions (columns 0:3), normals (5:8)
    and texcoords (3:5) on the slab's first `count` rows; the other
    rows keep the pool's.  start is the slab's offset clamped into [0, V
    - md], as the JAX package's dynamic_slice and dynamic_update_slice
    clamp it (a slab past the pool's end overwrites the rows before
    it).  The state itself is never written, so a frame with count 0
    reads the pool's own rows.  Without a slab, state itself."""
    md = cfg.max_dynamic_vertices
    if md <= 0:
        return state
    geom = state["geometry"]
    a12 = geom["attr12"]
    n_v, dev = a12.shape[0], a12.device
    if md > n_v:
        raise ValueError(f"max_dynamic_vertices {md} exceeds the pool's {n_v} rows")
    dyn = draws["dyn"]
    k = torch.arange(md, device=dev)
    start = torch.clamp(dyn["offset"].long(), 0, n_v - md)
    rows = start + k
    cur = a12[rows]
    new = torch.cat([dyn["positions"], dyn["texcoords"], dyn["normals"], cur[:, 8:12]],
                    -1)
    mask = (k < dyn["count"])[:, None]
    attr12 = a12.index_copy(0, rows, torch.where(mask, new, cur))
    return dict(state, geometry=dict(geom, attr12=attr12))


def _vertex_stage(cfg: FrameConfig, state, draws, sceneset):
    """Host-expanded streams + ONE attr12 row gather + the vertex modes of
    cfg (the foliage wind bends, skinning, the terrain geomorph) + rigid
    transform.  With a dynamic-vertex slab, state is patch_dynamic's.
    Returns (ex, uv, clip, wnormal, wtangent, worldp)."""
    if "src_v" not in draws:
        raise ValueError("draws need the host draw expansion "
                         "(RenderContext.expand_host) before render_frame")
    ex = {k: draws[k] for k in ("src_v", "vtx_draw", "v_valid", "tris",
                                "tri_draw", "t_valid")}
    uv, clip, wnormal, wtangent, worldp = _stream_vertices(state, draws, sceneset, cfg)
    return ex, uv, clip, wnormal, wtangent, worldp


def _foliage_bend(positions, d, vd):
    """The foliage wind bends in local space, in the JAX frame's inline
    form: each draw's wind rotated into its model frame, the detail
    flutter (phase (p @ ones) * sum(anchor)) and then the main bend,
    renormalised to the vertex's distance from the pivot (norm floor
    1e-20).  ops/geometry.py's wind_detail_bend and wind_bend are the
    standalone forms, which round differently."""
    world = d["world"]
    lw = torch.einsum("dji,dj->di", world[:, :, :3], d["wind"][:, :3])
    wv = lw[vd]                                          # (V, 3)
    tv = d["wind"][vd, 3]
    bs = d["bendscale"][vd]
    ds = d["detailbendscale"][vd]
    anch = world[vd, :, 3]

    ones = torch.ones(3, dtype=torch.float32, device=positions.device)
    phase = positions @ ones * anch.sum(-1)
    wvs = torch.stack([(tv + phase) * 1.975, (tv + phase) * 0.793], -1)
    waves = torch.remainder(wvs, 1.0) * 2.0 - 1.0
    waves = torch.abs(torch.remainder(waves + 0.5, 1.0) * 2.0 - 1.0)
    waves = waves * waves * (3.0 - 2.0 * waves)
    positions = positions + wv * (waves.sum(-1) * torch.sum(positions * ds, -1))[:, None]

    bf = torch.sum(positions * bs, -1) + 1.0
    bf = bf * bf
    bf = bf * bf - bf
    bent = positions + wv * bf[:, None]
    ln = torch.linalg.norm(positions, dim=-1, keepdim=True)
    bn = torch.clamp(torch.linalg.norm(bent, dim=-1, keepdim=True), min=1e-20)
    return bent * (ln / bn)


def _stream_vertices(state, d, sceneset, cfg=None):
    """ONE attr12 row gather + rigid transform of a host-expanded draw
    stream d (the opaque draws or draws["translucent"]).  With cfg (the
    opaque draws), first the vertex modes its flags ask for, in the JAX
    package's order: the foliage wind bends (enable_foliage),
    dual-quaternion skinning with d's palettes (enable_skinning), the
    terrain geomorph of d's morph_range draws (enable_terrain_morph).
    Returns (uv, clip, wnormal, wtangent, worldp)."""
    geom = state["geometry"]
    src = d["src_v"].long()
    rows12 = geom["attr12"][src]
    positions, normals, tangents = rows12[:, 0:3], rows12[:, 5:8], rows12[:, 8:12]
    if cfg is not None:
        vd = d["vtx_draw"].long()
        if cfg.enable_foliage:
            positions = _foliage_bend(positions, d, vd)
        if cfg.enable_skinning:
            positions, normals, tangents = skin_vertices(
                positions, normals, tangents, geom["bone_idx"][src],
                geom["bone_wt"][src], d["palettes"].reshape(-1, 8),
                d["palette_id"][vd], cfg.max_bones)
        if cfg.enable_terrain_morph:
            positions, normals = terrain_morph(
                positions, normals, geom["morph6"][src], d["vtx_draw"], d["world"],
                d["morph_range"], sceneset["invview"][:3, 3])
    viewproj = sceneset["proj"] @ sceneset["view"]
    clip, wnormal, wtangent, worldp = transform_vertices_rigid(
        positions, normals, tangents, d["vtx_draw"], d["world"], viewproj)
    return rows12[:, 3:5], clip, wnormal, wtangent, worldp


def _bin_stage(cfg: FrameConfig, ex, clip):
    """Triangle setup + near-first binning.  Front faces carry det < 0
    under the Y-flipped projection, so backface culling drops det > 0.
    Returns (setup, bins, counts, big_ids, bin_overflow)."""
    w, h = cfg.padded_width, cfg.padded_height
    tx, ty = cfg.tiles_x, cfg.tiles_y
    setup = raster_ops.triangle_setup(clip, ex["tris"], w, h, tx, ty,
                                      cull=-1 if cfg.backface_cull else 0,
                                      max_span=cfg.bin_max_span)
    bins, counts, big_ids, bin_overflow = raster_ops.bin_triangles(
        setup, cfg.max_triangles, tx, ty, cfg.bin_capacity, cfg.big_capacity,
        max_span=cfg.bin_max_span, return_overflow=True,
        depth_prio=setup["zbound"])
    return setup, bins, counts, big_ids, bin_overflow


def _raster_stage(cfg: FrameConfig, state, draws, ex, uv, clip, wnormal,
                  wtangent):
    """Binning and the K1 raster (K6 with raster_two_phase; with
    raster_early_z, its early exit).  Returns (planes dict,
    bin_overflow)."""
    with span("frame.raster.bins"):
        setup, bins, counts, big_ids, bin_overflow = _bin_stage(cfg, ex, clip)
    with span("frame.raster.k1"):
        planes = raster_shade(
            setup, bins, big_ids, counts, ex["tris"], uv, wnormal, draws["tri_mat"],
            state["materials"], cfg.tiles_x, cfg.tiles_y, cfg.padded_width,
            cfg.padded_height, tangent=wtangent, two_phase=cfg.raster_two_phase,
            early_z=cfg.raster_early_z)
    return planes, bin_overflow


def _count(counters, name, overflow):
    """Put each of overflow's tensors (the dropped entries of a pass's
    bins) into counters, the frame's counter dict or None, as name.<i>."""
    if counters is not None:
        counters.update((f"{name}.{i}", o) for i, o in enumerate(overflow))


def _sun_shadows(cfg: FrameConfig, ex, worldp, sceneset, counters=None):
    """Sun cascades: with shadow_mode 'esm' their ESM (esm, zmax, zscale),
    with 'pcf' the raw (S, R, R) maps; None without shadows.  K3 rasters
    them with use_pallas, the scan raster without.  counters: the
    frame's counter dict (each stack's dropped entries) or None."""
    if not cfg.enable_shadows:
        return None
    ml = sceneset["mainlight"]
    esm = cfg.shadow_mode == "esm"
    overflow = None if counters is None else []
    raw = shadow_ops.render_shadow_cascades(
        worldp, ex["tris"], ml["shadowview"], res=cfg.shadow_res,
        bin_capacity=cfg.shadow_bin_capacity, big_capacity=cfg.big_capacity,
        far_res=cfg.shadow_far_res if esm else None, early_z=cfg.raster_early_z,
        use_kernel=cfg.use_pallas, overflow=overflow)
    _count(counters, "shadows.sun", overflow)
    return shadow_ops.build_esm(raw, ml["shadowview"]) if esm else raw


def _spot_shadows(cfg: FrameConfig, ex, worldp, sceneset, counters=None):
    """The megakernel path's spot maps (K3), parabolic or perspective
    (spot_shadow_mode), and their ESM: (n, R, R) or None."""
    if cfg.max_spot_shadows <= 0:
        return None
    sl = sceneset["spotlights"]
    overflow = None if counters is None else []
    kw = dict(res=cfg.spot_shadow_res, bin_capacity=cfg.shadow_bin_capacity,
              big_capacity=cfg.big_capacity, early_z=cfg.raster_early_z,
              overflow=overflow)
    if cfg.spot_shadow_mode == "parabolic":
        maps = shadow_ops.render_spot_maps_parabolic(
            worldp, ex["tris"], sl["view"], sl["attenuation"][:, 3],
            cfg.max_spot_shadows, **kw)
    else:
        maps = shadow_ops.render_spot_maps(worldp, ex["tris"], sl["shadowview"],
                                           cfg.max_spot_shadows, **kw)
    _count(counters, "shadows.spot", overflow)
    return shadow_ops.build_spot_esm(maps)


def _shadow_stage(cfg: FrameConfig, ex, worldp, sceneset):
    """dict(sun=_sun_shadows(...), spot=_spot_shadows(...))."""
    return dict(sun=_sun_shadows(cfg, ex, worldp, sceneset),
                spot=_spot_shadows(cfg, ex, worldp, sceneset))


def _skyrot(sceneset):
    """World -> env rotation of the global environment lookups."""
    return sceneset["camera"]["skyrot_inv"]


def _band(band, h):
    """(y0, frame height, up_to, up_to_batch, prev_row) of a band (see
    the module docstring), or of the whole h-row frame when band is
    None."""
    if band is None:
        return 0, h, resize_up_dense, resize_up_dense_batch, None
    return band["y0"], band["full_h"], band["up_to"], band["up_to_batch"], band["prev_row"]


def _band_tiles(band, h, tiles_x, *rows):
    """(tile0, each of rows (per-tile arrays of the frame) cut to the
    tile rows of a band h rows high); (0, rows) without a band."""
    if band is None:
        return (0, *rows)
    t0, n = band["tile0"], (h // TILE_H) * tiles_x
    return (t0, *(r[t0:t0 + n] for r in rows))


def _env_fields(planes, mm12, ibl, sceneset, w, h, band=None):
    """Half-res environment fields of the skybox, channel-first: the
    specular env tap along the roughness-bent reflection (3, H/2, W/2),
    and the quarter-res env-BRDF taps upsampled to half res (3, H/2,
    W/2); then the box probes' quarter-res fields, or None without
    probes: (diffuse (H/4, W/4, 3), hit (H/4, W/4)).  Where a probe hits
    (its upsampled hit > 0.5) its specular replaces the skybox's; the
    probes tap world directions (the boxes are world-authored), the
    skybox its rotated ones."""
    p = 2
    y0, gh, up, _, _ = _band(band, h)
    proj, invview = sceneset["proj"], sceneset["invview"]
    mk = (planes["visf"] >= 0.0).to(torch.float32)
    # one stacked pool: mask, masked normal, masked roughness
    pooled5 = downsample_pool(torch.stack(
        [mk, planes["nx"] * mk, planes["ny"] * mk, planes["nz"] * mk,
         planes["rgh"] * mk], -1), p)
    mk_h = torch.clamp(pooled5[..., :1], min=1e-6)
    nrm_h = brdf.normalize(pooled5[..., 1:4] / mk_h)
    d_h = downsample_pool(planes["depth"], p, reduce="first")
    _, wp_h = reconstruct_positions(d_h, proj, invview, w // p, gh // p, y0=y0 // p)
    eye_h = brdf.normalize(invview[:3, 3] - wp_h)
    rough_h = pooled5[..., 4] / mk_h[..., 0] * mm12[7]
    r_h = 2.0 * (nrm_h * eye_h).sum(-1, keepdim=True) * nrm_h - eye_h
    sdir_h = brdf.specular_dominant_direction(nrm_h, r_h, rough_h)
    spec_h = sample_cubemap_lod_pair(
        ibl["flatp"], brdf.normalize(sdir_h) @ _skyrot(sceneset).T,
        rough_h * (len(ibl["mips"]) - 1))[..., :3]
    probe_dif = None
    envs = ibl.get("envprobes")
    if envs is not None:
        nrm_q = brdf.normalize(downsample_pool(nrm_h, 2))
        eye_q = brdf.normalize(downsample_pool(eye_h, 2))
        rough_q = downsample_pool(rough_h, 2)
        spec_o, dif_o, hitm = env_probe_fields(
            downsample_pool(wp_h, 2), brdf.normalize(downsample_pool(sdir_h, 2)),
            brdf.diffuse_dominant_direction(nrm_q, eye_q, rough_q), rough_q, envs)
        spec_h = torch.where(up(hitm, h // p, w // p)[..., None] > 0.5,
                             up(spec_o, h // p, w // p), spec_h)
        probe_dif = (dif_o, hitm)
    # env-BRDF at quarter res: the split-sum field is smooth in
    # (roughness, NdotV)
    lut = ibl["envbrdf"]
    s_ = lut.shape[0]
    ndv_h = torch.clamp((nrm_h * eye_h).sum(-1), 0.0, 1.0)
    bi = texel_index(downsample_pool(rough_h, 2) * s_, s_)
    bj = texel_index(downsample_pool(ndv_h, 2) * s_, s_)
    eb_q = lut.reshape(-1, lut.shape[-1])[(bi * s_ + bj).long()]
    eb_h = up(eb_q, h // p, w // p)
    return spec_h.permute(2, 0, 1), eb_h.permute(2, 0, 1), probe_dif


def _assemble_gplanes(cfg: FrameConfig, planes, state, sceneset, shadows, w, h,
                      band=None):
    """Material, environment and sun-shadow plane assembly for ONE layer
    of K1 output (the opaque layer, or a lit translucent layer on its
    w x h viewport): half-res material and environment taps, ONE batched
    2x upsample of 15 channel-first planes, the full-res gbuffer encode
    and TBN normal mapping, and the quarter-res sun factor upsampled.
    Returns (the K2 plane dict, the (h, w) coverage mask).  band: the
    planes are a band of the frame (module docstring)."""
    p = 2
    y0, gh, up, up_batch, prev_row = _band(band, h)
    uv_h = torch.stack([downsample_pool(planes["u"], p),
                        downsample_pool(planes["v"], p)], -1)
    base_h = torch.round(downsample_pool(planes["mbase"], p,
                                         reduce="first")).to(torch.int32)
    size_h = torch.round(downsample_pool(planes["msize"], p,
                                         reduce="first")).to(torch.int32)
    mm12 = sample_matmaps(state["matmaps"]["table"], base_h, size_h, uv_h, pool=p,
                          prev_uv_row=None if prev_row is None else prev_row(uv_h))

    ibl = state.get("ibl")
    probe_dif = None
    if ibl is not None:
        spec_h, eb_h, probe_dif = _env_fields(planes, mm12, ibl, sceneset, w, h, band)
    else:
        # no environment: zero specular env; the constant-ambient
        # fallback rides the SH DC coefficient with eb2 = 1
        h2, w2 = h // p, w // p
        f32 = dict(dtype=torch.float32, device=mm12.device)
        spec_h = torch.zeros((3, h2, w2), **f32)
        eb_h = constant((0.0, 0.0, 1.0), torch.float32, mm12.device)[:, None, None].expand(
            3, h2, w2)
    sel = constant(MATMAP_PLANES, torch.int64, mm12.device)
    half = torch.cat([mm12[sel], spec_h, eb_h], dim=0)   # (15, H/2, W/2)
    (alb_r, alb_g, alb_b, surf_m, surf_r, surf_rough,
     nm_x, nm_y, nm_z, es_r, es_g, es_b, eb0, eb1, eb2) = up_batch(half, h, w).unbind(0)

    # full-res material derivation (gbuffer encode, element-wise)
    metal = planes["met"] * surf_m
    refl = planes["rfl"] * surf_r
    rough = planes["rgh"] * surf_rough
    albc = (alb_r * planes["cr"], alb_g * planes["cg"], alb_b * planes["cb"])
    one_m = 1.0 - metal
    s0 = 0.16 * refl * refl
    gpl = dict(
        depth=planes["depth"], visf=planes["visf"], em=planes["em"], rgh=rough,
        dr=albc[0] * one_m, dg=albc[1] * one_m, db=albc[2] * one_m,
        sr=s0 + (albc[0] - s0) * metal,
        sg=s0 + (albc[1] - s0) * metal,
        sb=s0 + (albc[2] - s0) * metal,
        esr=es_r, esg=es_g, esb=es_b, eb0=eb0, eb1=eb1, eb2=eb2,
    )
    # TBN normal mapping
    nrm = brdf.normalize(torch.stack([planes["nx"], planes["ny"],
                                      planes["nz"]], -1))
    tan = torch.stack([planes["tanx"], planes["tany"], planes["tanz"]], -1)
    tgt = brdf.normalize(tan - nrm * (tan * nrm).sum(-1, keepdim=True))
    btg = torch.linalg.cross(nrm, tgt) * planes["tanw"][..., None]
    sn = brdf.normalize(tgt * nm_x[..., None] * 2.0
                        + btg * nm_y[..., None] * 2.0
                        + nrm * nm_z[..., None] * 2.0
                        - (tgt + btg + nrm))
    gpl["nx"], gpl["ny"], gpl["nz"] = sn[..., 0], sn[..., 1], sn[..., 2]

    # the box probes' diffuse override planes for K2 (edm: where > 0.5)
    if probe_dif is not None:
        dif_o, hitm = probe_dif
        gpl["edr"], gpl["edg"], gpl["edb"] = up(dif_o, h, w).unbind(-1)
        gpl["edm"] = up(hitm, h, w)

    # sun shadow factor: quarter-res ESM taps, upsampled
    if shadows["sun"] is not None:
        sfq = shadow_ops.sun_shadow_factor_quarter(
            planes["depth"], (planes["nx"], planes["ny"], planes["nz"]),
            shadows["sun"], sceneset, proj=sceneset["proj"],
            invview=sceneset["invview"], slice_blend=cfg.shadow_slice_blend, y0=y0,
            full_height=gh)
        gpl["sf"] = up(sfq, h, w)
    else:
        gpl["sf"] = torch.ones_like(planes["depth"])
    return gpl, planes["visf"] >= 0.0


def _sky_planes(ibl, sceneset, w, h, band=None):
    """The skybox behind the geometry: view rays tapped at quarter res
    (mip skyboxlod, at least 0) and upsampled 4x.  (3, H, W)."""
    y0, gh, _, up_batch, _ = _band(band, h)
    proj, invview = sceneset["proj"], sceneset["invview"]
    rx, ry = view_ray_grid(_inv_proj(proj), w, gh, y0=y0, local_h=h)
    rays = torch.stack([rx, ry, -torch.ones_like(rx)], -1) @ invview[:3, :3].T
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    lod = torch.clamp(sceneset["camera"]["skyboxlod"], min=0.0)
    rays_q = downsample_pool(rays, 4) @ _skyrot(sceneset).T
    sky_q = sample_cubemap_lod_pair(ibl["flatp"], rays_q,
                                    lod.expand(rays_q.shape[:-1]))[..., :3]
    return up_batch(sky_q.permute(2, 0, 1), h, w)


def _sky_sh_spots(cfg: FrameConfig, gpl, planes, state, sceneset, spot, band=None):
    """The rest of K2's inputs: the sky planes (into gpl), the sceneset
    with "_sh", and the spot factor planes.  Returns (ss2, spotsf or
    None)."""
    h, w = planes["depth"].shape
    y0, gh, up, _, _ = _band(band, h)
    ss2 = dict(sceneset)
    ibl = state.get("ibl")
    if ibl is not None:
        # SH-9 rotated by the skybox orientation, so that K2 evaluates it
        # with world normals
        ss2["_sh"] = rotate_sh9(ibl["sh"], _skyrot(sceneset))
        gpl["sky_r"], gpl["sky_g"], gpl["sky_b"] = \
            _sky_planes(ibl, sceneset, w, h, band).unbind(0)
    else:
        # DC-only SH reproducing the constant-ambient fallback:
        # basis0 * c0 / pi = 0.2  =>  c0 = 0.2 * pi / 0.886227
        sh0 = torch.zeros((9, 3), dtype=torch.float32,
                          device=planes["depth"].device)
        sh0[0, :] = 0.70898
        ss2["_sh"] = sh0

    # spot shadow factors: quarter-res ESM taps, upsampled
    spotsf = None
    if spot is not None:
        sl = sceneset["spotlights"]
        pv = dict(proj=sceneset["proj"], invview=sceneset["invview"], y0=y0,
                  full_height=gh)
        if cfg.spot_shadow_mode == "parabolic":
            fq = [shadow_ops.spot_factor_quarter_parabolic(
                planes["depth"], spot[i], sl["view"][i], sl["attenuation"][i, 3], **pv)
                for i in range(cfg.max_spot_shadows)]
        else:
            fq = [shadow_ops.spot_factor_quarter(planes["depth"], spot[i],
                                                 sl["shadowview"][i], **pv)
                  for i in range(cfg.max_spot_shadows)]
        spotsf = torch.stack([up(f, h, w) for f in fq])
    return ss2, spotsf


def _decals(cfg: FrameConfig, gpl, mask, depth, state, draws, sceneset, band=None):
    """The decals blended over the opaque layer's K2 planes, on the world
    positions of its depth (a new dict; gpl itself when there are
    none)."""
    if cfg.max_decals_active <= 0:
        return gpl
    h, w = depth.shape
    y0, gh, _, _, _ = _band(band, h)
    _, wpos = reconstruct_positions(depth, sceneset["proj"], sceneset["invview"],
                                    w, gh, y0=y0)
    return apply_decals_planes(
        gpl, wpos.unbind(-1), draws["decals"], mask,
        textures=state["textures"] if cfg.decal_textures else None)


def _ssao(cfg: FrameConfig, planes, sceneset, prev):
    """HBAO at ssao_scale of the frame on the raster's depth and normals
    (one stacked 4-channel subsample), with the temporal pass when prev
    (the previous frame's ao_prev) is given.  Returns (the full-res
    ambient factor for K2 or None, the (h, w, 2) AO state or None)."""
    if not (cfg.enable_ssao and cfg.ssao_scale > 0):
        return None, None
    w, h = cfg.padded_width, cfg.padded_height
    dec = max(int(round(1.0 / cfg.ssao_scale)), 1)
    sub4 = downsample_pool(torch.stack([planes["depth"], planes["nx"], planes["ny"],
                                        planes["nz"]], -1), dec, reduce="first")
    nn = brdf.normalize(sub4[..., 1:4]) * 0.5 + 0.5
    ao = hbao(sub4[..., 0], nn, sceneset["proj"], sceneset["view"],
              params=make_hbao_params(),
              prev_ao=None if prev is None else prev["ao"],
              prevview=None if prev is None else prev["view"],
              invview=sceneset["invview"])
    strength = sceneset["camera"]["ssaostrength"]
    return 1.0 + (resize_up_dense(ao[..., 0], h, w) - 1.0) * strength, ao


def fog_volume(cfg: FrameConfig, sceneset, shadows):
    """The froxel fog volume, shadowed by the sun ESM when there is one."""
    return fog_ops.build_fog_volume(sceneset, proj=sceneset["proj"],
                                    invview=sceneset["invview"], shadow=shadows["sun"],
                                    depth_range=cfg.fog_depth_range)


def _fog(cfg: FrameConfig, depth, sceneset, shadows, gpl, band=None):
    """The froxel fog volume (fog_volume; a band's is given) and its four
    full-res planes, into gpl's fog_r/g/b/t."""
    if not cfg.enable_fog:
        return
    y0, gh, _, _, _ = _band(band, depth.shape[0])
    fogvol = band["fogvol"] if band is not None else fog_volume(cfg, sceneset, shadows)
    gpl["fog_r"], gpl["fog_g"], gpl["fog_b"], gpl["fog_t"] = fog_ops.fog_planes(
        depth, fogvol, sceneset["proj"], depth_range=cfg.fog_depth_range,
        sample_scale=cfg.fog_sample_scale, y0=y0,
        full_height=gh)


def _fog_planes(cfg: FrameConfig, hdr, depth, draws, sceneset):
    """The analytic half-space fog planes (draws["fogplanes"]) over the
    lit hdr; hdr itself without max_fog_planes."""
    if cfg.max_fog_planes <= 0:
        return hdr
    return fog_ops.apply_fog_planes(hdr, depth, draws["fogplanes"],
                                    proj=sceneset["proj"], invview=sceneset["invview"],
                                    exposure=sceneset["camera"]["exposure"])


def _shade_inputs(cfg: FrameConfig, planes, state, draws, sceneset, shadows,
                  prev=None, band=None):
    """(gplanes, sceneset with "_sh", spotsf or None, ao or None, AO state
    or None) for K2 of the opaque layer: decals blended in, SSAO, the sky
    and the fog planes.  shadows: _shadow_stage's dict; prev: the
    previous frame's ao_prev or None; band: a band of the frame (module
    docstring), whose SSAO factor, when SSAO is on, is band["ao"]."""
    h, w = planes["depth"].shape
    with span("frame.planes.assembly"):
        gpl, mask = _assemble_gplanes(cfg, planes, state, sceneset, shadows, w, h, band)
    with span("frame.planes.decals"):
        gpl = _decals(cfg, gpl, mask, planes["depth"], state, draws, sceneset, band)
    if band is not None and "ao" in band:
        ao, ao_state = band["ao"], None
    else:
        with span("frame.planes.ssao"):
            ao, ao_state = _ssao(cfg, planes, sceneset, prev)
    with span("frame.planes.sky"):
        ss2, spotsf = _sky_sh_spots(cfg, gpl, planes, state, sceneset,
                                    shadows["spot"], band)
    with span("frame.planes.fog"):
        _fog(cfg, planes["depth"], sceneset, shadows, gpl, band)
    return gpl, ss2, spotsf, ao, ao_state


def lit_viewport(cfg: FrameConfig):
    """(w_t, h_t) of the lit translucent layers: the frame at
    1/translucent_lit_scale, padded to whole tiles; it spans the full NDC
    range."""
    s = cfg.translucent_lit_scale
    if s <= 1:
        return cfg.padded_width, cfg.padded_height
    return (round_up(cfg.padded_width // s, TILE_W),
            round_up(cfg.padded_height // s, TILE_H))


def translucent_stream(state, draws, sceneset):
    """The host-expanded translucent draws' vertex stream: dict(d (the
    draws["translucent"] tree), uv, clip, wn, wt)."""
    d = draws["translucent"]
    uv, clip, wn, wt, _ = _stream_vertices(state, d, sceneset)
    return dict(d=d, uv=uv, clip=clip, wn=wn, wt=wt)


def lit_setup(cfg: FrameConfig, ts, band=None):
    """Two-sided triangle setup of the translucent stream ts on the lit
    viewport (the frame's in band mode): (setup, tiles_x, tiles_y, w_t,
    h_t)."""
    w_t, h_t = (lit_viewport(cfg) if band is None
                else (cfg.padded_width, cfg.padded_height))
    tx, ty = w_t // TILE_W, h_t // TILE_H
    setup = raster_ops.triangle_setup(ts["clip"], ts["d"]["tris"], w_t, h_t,
                                      tx, ty, cull=0,
                                      tri_valid=ts["d"]["t_valid"])
    return setup, tx, ty, w_t, h_t


def _view_dist(proj, d):
    """View distance of a reverse-Z depth plane."""
    dn = d + proj[2, 2]
    return proj[2, 3] / torch.where(torch.abs(dn) < 1e-7,
                                    torch.full_like(dn, 1e-7), dn)


def _lit_layers(cfg: FrameConfig, state, ts, sceneset, ss2, shadows, depth, gpl,
                band=None, counters=None):
    """The lit translucent layers, nearest first: each a K1 raster of the
    translucent stream (material alpha in "alb"; from the second layer on
    peeled strictly behind the previous one), its plane assembly and K2
    with planes_out on the lit viewport, the absorb/column alpha, and a
    premultiplied upsample into gpl's tr (tr2..tr4) planes; layer 0 also
    gives the refraction offsets tr_ox, tr_oy.  Returns the last layer's
    depth at full resolution when there are 2 or more layers (the WBOIT
    residual peels against it), else None.  In band mode (band: module
    docstring) the layers run on the band at the frame's resolution: the
    JAX package's parity exception, its half-res planes' band-local
    upsamples would clamp at band seams.  counters: the frame's counter
    dict (the layer bins' dropped entries) or None."""
    h, w = depth.shape
    y0, gh, _, _, _ = _band(band, h)
    scaled = cfg.translucent_lit_scale > 1 and band is None
    proj = sceneset["proj"]
    tsetup, tx, ty, w_t, gh_t = lit_setup(cfg, ts, band)
    h_t = gh_t if band is None else h
    depth_t = resize_matmul(depth, h_t, w_t, nearest=True) if scaled else depth
    tbins, tcounts, tbig, *dropped = raster_ops.bin_triangles(
        tsetup, cfg.max_translucent_tris, tx, ty, cfg.forward_bin_capacity,
        cfg.forward_big_capacity, return_overflow=counters is not None)
    _count(counters, "translucent.lit", dropped)
    tile0, tbins, tcounts = _band_tiles(band, h, tx, tbins, tcounts)
    d = ts["d"]
    n_layers = min(max(1, int(cfg.translucent_lit_layers)), MAX_TR_LAYERS)
    peel = None
    for layer in range(n_layers):
        planes_t = raster_shade(
            tsetup, tbins, tbig, tcounts, d["tris"], ts["uv"], ts["wn"],
            d["tri_mat"], state["materials"], tx, ty, w_t, gh_t,
            tangent=ts["wt"], alpha_in_alb=True, peel_depth=peel,
            two_phase=cfg.raster_two_phase, early_z=cfg.raster_early_z, tile0=tile0)
        peel = planes_t["depth"]          # the next layer peels against it
        # only fragments nearer than the opaque surface
        planes_t = dict(planes_t, visf=torch.where(
            planes_t["depth"] > depth_t, planes_t["visf"],
            torch.full_like(depth_t, -1.0)))
        gpl_t, mask_t = _assemble_gplanes(cfg, planes_t, state, sceneset,
                                          shadows, w_t, h_t, band)
        tr = shade_deferred(gpl_t, ss2, proj=proj, invview=sceneset["invview"],
                            planes_out=True, y0=y0, full_height=gh_t)
        # depth-aware transmission: absorb > 0 materials blend by the
        # water column between the surface and the opaque floor
        a_mat = torch.clamp(planes_t["alb"], 0.0, 1.0)
        absorb = planes_t["absorb"]
        column = torch.clamp(_view_dist(proj, depth_t)
                             - _view_dist(proj, planes_t["depth"]), min=0.0)
        a_depth = 1.0 - (1.0 - a_mat) * torch.exp(-absorb * column)
        alpha_t = torch.where(absorb > 0, a_depth, a_mat) * mask_t.to(torch.float32)
        pfx = "tr" if layer == 0 else f"tr{layer + 1}"
        if scaled:
            # premultiplied upsample, then unpremultiply, so that the
            # bilinear border mixes in no unshaded black
            st4 = resize_matmul(torch.stack([tr[0] * alpha_t, tr[1] * alpha_t,
                                             tr[2] * alpha_t, alpha_t], -1), h, w)
            a_up = st4[..., 3]
            un = 1.0 / torch.clamp(a_up, min=1e-4)
            for c, ch in enumerate("rgb"):
                gpl[f"{pfx}_{ch}"] = st4[..., c] * un
            gpl[f"{pfx}_a"] = a_up
        else:
            gpl[f"{pfx}_r"], gpl[f"{pfx}_g"], gpl[f"{pfx}_b"] = tr
            gpl[f"{pfx}_a"] = alpha_t
        if layer == 0:
            # refraction offsets (pixels): view-space normal xy scaled by
            # the surface distance, on absorbing surfaces only
            v_ = sceneset["view"]
            nvx = v_[0, 0] * gpl_t["nx"] + v_[0, 1] * gpl_t["ny"] + v_[0, 2] * gpl_t["nz"]
            nvy = v_[1, 0] * gpl_t["nx"] + v_[1, 1] * gpl_t["ny"] + v_[1, 2] * gpl_t["nz"]
            refr_k = 90.0 / torch.clamp(_view_dist(proj, planes_t["depth"]), min=1.0)
            on_refr = (absorb > 0) & mask_t
            zero = torch.zeros_like(nvx)
            tr_ox = torch.where(on_refr, torch.clamp(nvx * refr_k, -9.0, 9.0), zero)
            # vertical shifts wrap inside K2's 16-row bands: keep to +-4 px
            tr_oy = torch.where(on_refr, torch.clamp(nvy * refr_k, -4.0, 4.0), zero)
            if scaled:
                oxy = resize_matmul(torch.stack([tr_ox, tr_oy], -1), h, w)
                gpl["tr_ox"], gpl["tr_oy"] = oxy[..., 0], oxy[..., 1]
            else:
                gpl["tr_ox"], gpl["tr_oy"] = tr_ox, tr_oy
    if n_layers < 2:
        return None
    return resize_matmul(peel, h, w, nearest=True) if scaled else peel


def oit_stream(cfg: FrameConfig, state, draws, sceneset, ts, lit_peel):
    """The merged weighted-blend OIT stream: the translucent triangles
    (all of them without lit layers; with 2 or more lit layers, the
    residual behind the last one, peel flag 1) and the particle
    billboards (soft flag 1).  Returns dict(setup, tris, uv, color,
    valid, soft_flag, peel_flag, nstreams) or None when there is no
    stream."""
    w, h = cfg.padded_width, cfg.padded_height
    parts = []           # (clip, uv, color, tris, valid, soft, peel)
    want_tr = cfg.max_translucent_draws > 0 and (
        not cfg.translucent_lit or lit_peel is not None)
    if want_tr:
        d = ts["d"]
        nt = d["tris"].shape[0]
        color = state["materials"]["color"][d["material"][d["vtx_draw"].long()].long()]
        flag = torch.zeros(nt, device=color.device)
        parts.append((ts["clip"], ts["uv"], color, d["tris"], d["t_valid"], flag,
                      flag + (1.0 if lit_peel is not None else 0.0)))
    if cfg.max_particle_quads > 0:
        fwd = draws["forward"]
        viewproj = sceneset["proj"] @ sceneset["view"]
        fclip = fwd["positions"] @ viewproj[:, :3].T + viewproj[:, 3]
        ftris = quad_triangles(cfg.max_particle_quads, fclip.device)
        nf = ftris.shape[0]
        valid = torch.arange(nf, device=fclip.device) < fwd["quad_count"] * 2
        flag = torch.zeros(nf, device=fclip.device)
        parts.append((fclip, fwd["uv"], fwd["color"], ftris, valid, flag + 1.0,
                      flag))
    if not parts:
        return None
    vbase, tris = 0, []
    for p in parts:
        tris.append(p[3] + vbase)
        vbase += p[0].shape[0]
    clip, uv, color, _, valid, soft, peel = (torch.cat(x) for x in zip(*parts))
    tris = torch.cat(tris)
    setup = raster_ops.triangle_setup(clip, tris, w, h, cfg.tiles_x,
                                      cfg.tiles_y, tri_valid=valid)
    return dict(setup=setup, tris=tris, uv=uv, color=color, valid=valid,
                soft_flag=soft, peel_flag=peel, nstreams=len(parts))


def oit_bins(cfg: FrameConfig, st, **kw):
    """The merged stream's bins, at the forward capacities times its
    number of streams."""
    return raster_ops.bin_triangles(
        st["setup"], st["tris"].shape[0], cfg.tiles_x, cfg.tiles_y,
        cfg.forward_bin_capacity * st["nstreams"],
        cfg.forward_big_capacity * st["nstreams"], **kw)


def _oit_planes(cfg: FrameConfig, state, draws, sceneset, ts, lit_peel, depth,
                gpl, band=None, counters=None):
    """K4 over the merged stream against the opaque depth, into gpl's
    oit_r/g/b (exposed), oit_w and oit_rev planes (a band's: its bin rows
    of the frame's bins).  counters: as _lit_layers'."""
    st = oit_stream(cfg, state, draws, sceneset, ts, lit_peel)
    if st is None:
        zero = torch.zeros_like(depth)
        acc5 = (zero, zero, zero, zero, zero + 1.0)
    else:
        bins, counts, big, *dropped = oit_bins(cfg, st,
                                               return_overflow=counters is not None)
        _count(counters, "translucent.wboit", dropped)
        tile0, bins, counts = _band_tiles(band, depth.shape[0], cfg.tiles_x, bins, counts)
        acc5 = raster_blend(st["setup"], bins, big, counts, st["tris"], st["uv"],
                            st["color"], depth, cfg.tiles_x, cfg.tiles_y,
                            cfg.padded_width, cfg.padded_height, soft="per_tri",
                            peel_depth=lit_peel, soft_flag=st["soft_flag"],
                            peel_flag=st["peel_flag"], tile0=tile0)
    # exposure on the colour sums only: the resolve is rgb / weight
    exposure = sceneset["camera"]["exposure"]
    gpl["oit_r"], gpl["oit_g"], gpl["oit_b"] = (a * exposure for a in acc5[:3])
    gpl["oit_w"], gpl["oit_rev"] = acc5[3], acc5[4]


def _translucent_stage(cfg: FrameConfig, state, draws, sceneset, ss2, shadows,
                       depth, gpl, band=None, counters=None):
    """The lit translucent layers and the merged WBOIT stream, as planes
    of gpl for K2's epilogue (nothing without translucents or
    particles).  counters: as _lit_layers'."""
    ts = lit_peel = None
    if cfg.max_translucent_draws > 0:
        with span("frame.translucent.vertices"):
            ts = translucent_stream(state, draws, sceneset)
        if cfg.translucent_lit:
            with span("frame.translucent.lit"):
                lit_peel = _lit_layers(cfg, state, ts, sceneset, ss2, shadows, depth,
                                       gpl, band, counters)
    if cfg.max_translucent_draws > 0 or cfg.max_particle_quads > 0:
        with span("frame.translucent.wboit"):
            _oit_planes(cfg, state, draws, sceneset, ts, lit_peel, depth, gpl, band,
                        counters)


def light_clusters(cfg: FrameConfig, depth, sceneset, band=None):
    """K2's clusters (use_light_clusters), or None: each tile's point
    lights culled against its frustum and its depth interval
    (tile_light_capacity a tile), and each 32-row tile row's lists
    repeated for its two 16-row shade bands: ((H/16, tiles_x, cap) ids,
    (H/16, tiles_x) counts).  A band bins only its own tiles of the
    frame's grid."""
    if not cfg.use_light_clusters:
        return None
    pl_ = sceneset["pointlights"]
    tx, ty, cap = cfg.tiles_x, cfg.tiles_y, cfg.tile_light_capacity
    ty_local = depth.shape[0] // TILE_H
    proj = sceneset["proj"]
    lists, counts = bin_lights(
        pl_["position"], pl_["attenuation"][:, 3], pl_["count"], sceneset["view"],
        proj, tx, ty, cfg.padded_width, cfg.padded_height, cap,
        tile_zrange=tile_depth_bounds(depth, proj),
        tile0=0 if band is None else band["tile0"],
        n_local=None if band is None else ty_local * tx)
    rows = TILE_H // SHADE_ROWS
    return (lists.reshape(ty_local, tx, -1).repeat_interleave(rows, 0),
            counts.reshape(ty_local, tx).repeat_interleave(rows, 0))


def _ssr_inputs_planes(gpl):
    """The SSR's gbuffer inputs from the megakernel's K2 planes (decals
    in): (encoded normal (H, W, 3), specular (H, W, 3), roughness,
    coverage (H, W) f32)."""
    nenc = torch.stack([gpl["nx"], gpl["ny"], gpl["nz"]], -1) * 0.5 + 0.5
    spec = torch.stack([gpl["sr"], gpl["sg"], gpl["sb"]], -1)
    return nenc, spec, gpl["rgh"], (gpl["visf"] >= 0.0).to(torch.float32)


def _ssr_inputs_gbuffer(gbuffer):
    """The SSR's inputs from the deferred path's gbuffer."""
    return (gbuffer["normal"][..., :3], gbuffer["specular"][..., :3],
            gbuffer["specular"][..., 3], gbuffer["mask"].to(torch.float32))


def _band_post(band, h):
    """(gather, rows, the frame's padded height) of the post passes on a
    band (module docstring), or identities and h on the whole h-row
    frame."""
    if band is None:
        return (lambda x, label: x), (lambda x: x), h
    return band["gather"], band["rows"], band["full_h"]


def _ssr(cfg: FrameConfig, state, sceneset, hdr, depth, ssr_in, band=None):
    """The SSR on the final hdr, fed by ssr_in (_ssr_inputs_planes or
    _ssr_inputs_gbuffer), with ssrstrength on rgb only (the composite
    adds rgb * a): (the frame's quarter-res (hq, wq, 4) or None, full-res
    (H, W, 4) or None).  ssr_mode 'binned' marches at quarter resolution
    (the caller upsamples it, with the bloom when DoF is off); 'dda'
    marches at half resolution (ops/ssr.py) on the top-left texel of each
    2x2 cell and is upsampled here.  (None, None) without SSR.  band: the
    march runs on the bands' gathered pooled fields; band["ssr_gbuffer"]
    gives the DDA march's normal and specular planes (and what else the
    JAX package's band gathers beside them)."""
    if not cfg.enable_ssr:
        return None, None
    gather, rows, gh = _band_post(band, depth.shape[0])
    g = lambda x: gather(x, "ssr")
    nenc, spec, rough, mask = ssr_in
    ibl = state.get("ibl")
    lut = None if ibl is None else ibl["envbrdf"]
    strength = sceneset["camera"]["ssrstrength"]
    if cfg.ssr_mode == "binned":
        q = 4
        ssr_q = ssr_binned(
            g(downsample_pool(hdr, q)), g(downsample_pool(depth, q, reduce="first")),
            g(downsample_pool(nenc, q, reduce="first")), g(downsample_pool(spec, q)),
            g(downsample_pool(rough, q, reduce="first")),
            g(downsample_pool(mask, q)) > 0.5, sceneset["proj"], sceneset["view"],
            envbrdf_lut=lut)
        return torch.cat([ssr_q[..., :3] * strength, ssr_q[..., 3:]], -1), None
    first = lambda x: downsample_pool(x, 2, reduce="first")
    gb = (dict(normal=nenc, specular=torch.cat([spec, rough[..., None]], -1))
          if band is None else band["ssr_gbuffer"])
    gb_h = {k: g(first(v)) for k, v in gb.items()}
    # the coverage mask is all true: the JAX package pools its bool mask
    # with reduce='first', whose max over a window padded with True
    # (bool(-inf)) is True everywhere; the march's depth test still
    # skips the background
    gb_h["mask"] = g(torch.ones(first(depth).shape, dtype=torch.bool, device=depth.device))
    ssr_h = ssr_dda(g(downsample_pool(hdr, 2)), g(first(depth)), gb_h, sceneset["proj"],
                    sceneset["view"], envbrdf_lut=lut)
    ssr_img = rows(resize_up_dense(ssr_h, gh, depth.shape[1]))
    return None, torch.cat([ssr_img[..., :3] * strength, ssr_img[..., 3:]], -1)


def dof_amount(depth, proj, camera):
    """Depth of field's per-pixel blur amount: the view distance's offset
    to camera["focaldistance"] over camera["focalwidth"], in [0, 1]."""
    dist = proj[2, 3] / (depth + proj[2, 2])
    return torch.clamp(torch.abs(dist - camera["focaldistance"])
                       / torch.clamp(camera["focalwidth"], min=1e-3), 0.0, 1.0)


def dof_fields(hdr, depth, proj, camera, band=None):
    """Depth of field: (the half-res gaussian blur of hdr upsampled to
    full res, dof_amount).  band: the blur runs on the bands' gathered
    half-res hdr."""
    g, rows, gh = _band_post(band, depth.shape[0])
    hq = g(downsample2(hdr), "dof")
    blurred = rows(resize_up_dense(gaussian_blur(hq, 3.0), gh, depth.shape[1]))
    return blurred, dof_amount(depth, proj, camera)


def _post(cfg: FrameConfig, state, draws, sceneset, hdr, depth, ssr_in):
    """Log-average luminance and the post passes (post_rgb): (u8 image
    (height, width, 3), luminance)."""
    with span("frame.post.luminance"):
        lum_w = constant(LUMA_REC709, torch.float32, hdr.device)
        lum = torch.exp(torch.mean(torch.log(
            1e-4 + hdr[:cfg.height, :cfg.width] @ lum_w)))
    rgb = post_rgb(cfg, state, draws, sceneset, hdr, depth, ssr_in)
    with span("frame.post.u8"):
        image = to_u8_image(rgb[:cfg.height, :cfg.width])
    return image, lum


def post_rgb(cfg: FrameConfig, state, draws, sceneset, hdr, depth, ssr_in, band=None):
    """SSR, bloom, depth of field, the graded composite and the sprite
    pass (with max_overlay_sprites: the draws' sprites and text blended
    into the padded image, ops/sprite_pass.py): the padded display rgb
    (h, w, 3) in [0, 1].  With DoF off the quarter-res bloom and SSR add
    into one term (`glow`) that is upsampled once; with DoF on the DoF mix
    falls between the SSR and the bloom adds, so each is upsampled on its
    own.  band: hdr and depth are a band's rows (module docstring); each
    pass that reads across rows runs on the gathered reduced-res field
    (the sprites on the gathered display rgb) and its band's rows are cut
    back out, so the band's rgb is the whole frame's rows bit for bit."""
    w = cfg.padded_width
    g, rows, h = _band_post(band, depth.shape[0])
    cam = sceneset["camera"]
    up = lambda x: rows(resize_up_dense(x, h, w))

    with span("frame.post.ssr"):
        ssr_q, ssr_img = _ssr(cfg, state, sceneset, hdr, depth, ssr_in, band)
    bloom_img = glow = dof_blur = dof_amount = None
    with span("frame.post.bloom"):
        if ssr_q is not None and cfg.enable_depth_of_field:
            ssr_img, ssr_q = up(ssr_q), None
        if cfg.enable_bloom:
            quarter = g(downsample2(downsample2(hdr)), "bloom")
            if cfg.enable_depth_of_field:
                bloom_img = rows(bloom_quarter(quarter, cam["bloomstrength"]))
            else:
                bloom_q = bloom_quarter(quarter, cam["bloomstrength"], upsample=False)
                if ssr_q is not None:
                    bloom_q = bloom_q + ssr_q[..., :3] * ssr_q[..., 3:4]
                    ssr_q = None
                glow = up(bloom_q)
        if ssr_q is not None:                 # SSR alone (bloom off, DoF off)
            glow = up(ssr_q[..., :3] * ssr_q[..., 3:4])
    if cfg.enable_depth_of_field:
        with span("frame.post.dof"):
            dof_blur, dof_amount = dof_fields(hdr, depth, sceneset["proj"], cam, band)

    with span("frame.post.composite"):
        grading = cfg.enable_color_grading
        rgb = composite(hdr, 1.0, bloom=bloom_img, bloom_strength=1.0, ssr=ssr_img,
                        dof_blur=dof_blur, dof_amount=dof_amount,
                        lut=state.get("colorlut") if grading else None,
                        lut_poly=state.get("colorlut_poly") if grading else None,
                        glow=glow)
    if cfg.max_overlay_sprites > 0 and "sprites" in draws:
        with span("frame.post.sprites"):
            rgb = rows(composite_sprites(g(rgb, "sprites_rgb").contiguous(),
                                         draws["sprites"], state["overlay_atlas"],
                                         region=min(cfg.overlay_region, w,
                                                    cfg.padded_height)))
    return rgb


def use_shade_kernel(cfg: FrameConfig, state):
    """Whether the frame takes the megakernel branch: use_shade_kernel
    with use_pallas, a 'mip' filter and the v2 raster, an environment
    with SH-9 and the quad-packed table (or none; box probes need their
    quad-packed tables), and ESM sun shadows."""
    ibl = state.get("ibl")
    fused_mip = (cfg.use_pallas and cfg.texture_filter.startswith("mip")
                 and cfg.raster_kernel != "mxu")
    envs = None if ibl is None else ibl.get("envprobes")
    return (cfg.use_shade_kernel and fused_mip
            and (ibl is None or ("sh" in ibl and "flatq" in ibl
                                 and (envs is None or "flatqs" in envs)))
            and (not cfg.enable_shadows or cfg.shadow_mode == "esm"))


def shade_band(cfg: FrameConfig, state, draws, sceneset, shadows, planes, prev=None,
               band=None, counters=None):
    """The megakernel branch from K1's planes to K2's hdr: plane assembly
    with the decals, SSAO, sky, spot factors and fog; the lit layers and
    the WBOIT stream; the light clusters; K2 and its epilogue; on the
    whole frame (band None), the analytic fog planes.  band: the planes
    are a band of the frame (module docstring).  counters: as
    _lit_layers'.  Returns (hdr (h, w, 3), the K2 planes, the AO state or
    None)."""
    with span("frame.planes"):
        gpl, ss2, spotsf, ao, ao_state = _shade_inputs(cfg, planes, state, draws,
                                                       sceneset, shadows, prev, band)
    with span("frame.translucent"):
        _translucent_stage(cfg, state, draws, sceneset, ss2, shadows,
                           planes["depth"], gpl, band, counters)
    with span("frame.shade"):
        y0, gh, _, _, _ = _band(band, planes["depth"].shape[0])
        with span("frame.shade.clusters"):
            clusters = light_clusters(cfg, planes["depth"], sceneset, band)
        with span("frame.shade.k2"):
            hdr = shade_deferred(gpl, ss2, proj=sceneset["proj"],
                                 invview=sceneset["invview"], ao=ao, spotsf=spotsf,
                                 clusters=clusters, y0=y0, full_height=gh)
        if band is None:
            with span("frame.shade.fogplanes"):
                hdr = _fog_planes(cfg, hdr, planes["depth"], draws, sceneset)
    return hdr, gpl, ao_state


def _megakernel_frame(cfg: FrameConfig, state, draws, sceneset, prev, vtx,
                      counters=None):
    """The megakernel branch: (hdr, depth, vis, bin_overflow, ao_state,
    SSR inputs).  counters: the frame's counter dict or None."""
    ex, uv, clip, wnormal, wtangent, worldp = vtx
    with span("frame.shadows"):
        with span("frame.shadows.sun"):
            sun = _sun_shadows(cfg, ex, worldp, sceneset, counters)
        with span("frame.shadows.spot"):
            spot = _spot_shadows(cfg, ex, worldp, sceneset, counters)
    with span("frame.raster"):
        planes, bin_overflow = _raster_stage(cfg, state, draws, ex, uv, clip,
                                             wnormal, wtangent)
    hdr, gpl, ao_state = shade_band(cfg, state, draws, sceneset, dict(sun=sun, spot=spot),
                                    planes, prev, counters=counters)
    vis = torch.round(planes["visf"]).to(torch.int32)
    return (hdr, planes["depth"], vis, bin_overflow, ao_state,
            _ssr_inputs_planes(gpl))


def _k1_planes(p):
    """K1's 2-D planes as raster_shade_pallas's (planes_2d=False) dict."""
    rnd = lambda x: torch.round(x).to(torch.int32)
    st = lambda *k: torch.stack([p[n] for n in k], -1)
    return dict(depth=p["depth"], vis=rnd(p["visf"]), uv=st("u", "v"),
                normal=st("nx", "ny", "nz"), color=st("cr", "cg", "cb"),
                emissive=p["em"], metalness=p["met"], roughness=p["rgh"],
                reflectivity=p["rfl"], albedo_id=rnd(p["alb"]),
                matmap_base=rnd(p["mbase"]), matmap_size=rnd(p["msize"]),
                tangent=st("tanx", "tany", "tanz", "tanw"), absorb=p["absorb"])


def _deferred_raster(cfg: FrameConfig, state, draws, ex, uv, clip, wnormal, wtangent):
    """The deferred branch's visibility raster and material resolve:
    (depth, vis, gbuffer, bin_overflow).  With use_pallas and no material
    maps (or a 'mip' filter), the fused raster: K7 for
    raster_kernel='mxu', else K1 (its tangent and matmap planes read
    only by the 'mip' filters), then gbuffer_from_planes; otherwise K5
    (use_pallas) or the scan raster, then resolve_gbuffer."""
    w, h = cfg.padded_width, cfg.padded_height
    tx, ty = cfg.tiles_x, cfg.tiles_y
    with span("frame.raster.bins"):
        setup, bins, counts, big_ids, bin_overflow = _bin_stage(cfg, ex, clip)
    mip = cfg.texture_filter.startswith("mip")
    if cfg.use_pallas and (not cfg.enable_material_maps
                           or (mip and cfg.raster_kernel != "mxu")):
        if cfg.raster_kernel == "mxu":
            with span("frame.raster.k7"):
                planes = raster_shade_mxu(setup, bins, big_ids, counts, ex["tris"], uv,
                                          wnormal, draws["tri_mat"], state["materials"],
                                          tx, ty, w, h)
        else:
            with span("frame.raster.k1"):
                planes = _k1_planes(raster_shade(
                    setup, bins, big_ids, counts, ex["tris"], uv, wnormal,
                    draws["tri_mat"], state["materials"], tx, ty, w, h, tangent=wtangent,
                    early_z=cfg.raster_early_z))
        with span("frame.raster.resolve"):
            gbuffer = gbuffer_from_planes(planes, state["textures"],
                                          texture_filter=cfg.texture_filter,
                                          matmaps=state.get("matmaps"))
        return planes["depth"], planes["vis"], gbuffer, bin_overflow
    if cfg.use_pallas:
        with span("frame.raster.k5"):
            depth, vis, l0, l1 = raster_v1(setup, bins, big_ids, counts, tx, ty, w, h)
            lam = torch.stack([l0, l1, 1.0 - l0 - l1], -1)
    else:
        with span("frame.raster.scan"):
            depth, vis = raster_ops.raster(setup, bins, big_ids, tx, ty, w, h)
        lam = None
    with span("frame.raster.resolve"):
        gbuffer = resolve_gbuffer(
            vis, setup, ex["tris"], ex["tri_draw"],
            dict(uv=uv, normal=wnormal, tangent=wtangent), dict(material=draws["material"]),
            state["materials"], state["textures"], w, h,
            material_maps=cfg.enable_material_maps, lam=lam,
            matmaps=state.get("matmaps") if mip else None)
    return depth, vis, gbuffer, bin_overflow


def _deferred_ssao(cfg: FrameConfig, depth, gbuffer, sceneset, prev):
    """HBAO on the gbuffer's encoded normals: (full-res ambient factor or
    None, AO state or None)."""
    if not (cfg.enable_ssao and cfg.ssao_scale > 0):
        return None, None
    w, h = cfg.padded_width, cfg.padded_height
    dec = max(int(round(1.0 / cfg.ssao_scale)), 1)
    ao = hbao(downsample_pool(depth, dec, reduce="first"),
              downsample_pool(gbuffer["normal"][..., :3], dec, reduce="first"),
              sceneset["proj"], sceneset["view"], params=make_hbao_params(),
              prev_ao=None if prev is None else prev["ao"],
              prevview=None if prev is None else prev["view"],
              invview=sceneset["invview"])
    strength = sceneset["camera"]["ssaostrength"]
    return 1.0 + (resize_up_dense(ao[..., 0], h, w) - 1.0) * strength, ao


def _sky_fill(ibl, sceneset, hdr, mask, w, h):
    """The skybox behind the geometry along the view rays (mip
    skyboxlod, at least 0): quarter-res quad taps upsampled when the
    environment has the quad table, else full-res flat or mip-0 taps."""
    proj, invview = sceneset["proj"], sceneset["invview"]
    rx, ry = view_ray_grid(_inv_proj(proj), w, h)
    rays = torch.stack([rx, ry, -torch.ones_like(rx)], -1) @ invview[:3, :3].T
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    rays = rays @ _skyrot(sceneset).T
    lod = torch.clamp(sceneset["camera"]["skyboxlod"], min=0.0)
    if "flatq" in ibl:
        rays_h = downsample_pool(rays, 4)
        sky = resize_up_dense(sample_cubemap_lod_quad(
            ibl["flatq"], rays_h, lod.expand(rays_h.shape[:-1]))[..., :3], h, w)
    elif "flat" in ibl:
        sky = sample_cubemap_lod_flat(ibl["flat"], rays, lod.expand(rays.shape[:-1]))[..., :3]
    else:
        sky = sample_cubemap(ibl["mips"][0], rays)[..., :3]
    return torch.where(mask[..., None], hdr, sky * sceneset["camera"]["exposure"])


def _wboit(cfg: FrameConfig, setup, bins, big, counts, tris, uv, color, depth, soft):
    """One weighted-blend pass: (accum (H, W, 4), revealage (H, W)), by
    K4 with use_pallas, else by the XLA raster_blend."""
    w, h, tx, ty = cfg.padded_width, cfg.padded_height, cfg.tiles_x, cfg.tiles_y
    if cfg.use_pallas:
        ar, ag, ab, aw, rev = raster_blend(setup, bins, big, counts, tris, uv, color,
                                           depth, tx, ty, w, h, soft=soft)
        return torch.stack([ar, ag, ab, aw], -1), rev
    return blend_ops.raster_blend(setup, bins, big, uv, color, tris, depth, tx, ty,
                                  w, h, soft=soft)


def _deferred_forward(cfg: FrameConfig, state, draws, sceneset, hdr, depth,
                      counters=None):
    """The two separate weighted-blend OIT passes over hdr: the
    translucent draws (hard alpha), then the particle billboards (soft
    alpha), each resolved on its own.  counters: as _lit_layers'."""
    w, h, tx, ty = cfg.padded_width, cfg.padded_height, cfg.tiles_x, cfg.tiles_y
    exposure = sceneset["camera"]["exposure"]
    counted = counters is not None
    if cfg.max_translucent_draws > 0:
        with span("frame.translucent.wboit"):
            ts = translucent_stream(state, draws, sceneset)
            d = ts["d"]
            color = state["materials"]["color"][d["material"][d["vtx_draw"].long()].long()]
            setup = raster_ops.triangle_setup(ts["clip"], d["tris"], w, h, tx, ty,
                                              tri_valid=d["t_valid"])
            bins, counts, big, *dropped = raster_ops.bin_triangles(
                setup, cfg.max_translucent_tris, tx, ty, cfg.forward_bin_capacity,
                cfg.forward_big_capacity, return_overflow=counted)
            _count(counters, "translucent.wboit", dropped)
            acc, rev = _wboit(cfg, setup, bins, big, counts, d["tris"], ts["uv"], color,
                              depth, soft=False)
            hdr = blend_ops.resolve_oit(hdr, acc, rev, exposure=exposure)
    if cfg.max_particle_quads > 0:
        with span("frame.translucent.particles"):
            fwd = draws["forward"]
            viewproj = sceneset["proj"] @ sceneset["view"]
            fclip = fwd["positions"] @ viewproj[:, :3].T + viewproj[:, 3]
            ftris = quad_triangles(cfg.max_particle_quads, fclip.device)
            valid = torch.arange(ftris.shape[0], device=fclip.device) < fwd["quad_count"] * 2
            setup = raster_ops.triangle_setup(fclip, ftris, w, h, tx, ty, tri_valid=valid)
            bins, counts, big, *dropped = raster_ops.bin_triangles(
                setup, ftris.shape[0], tx, ty, cfg.forward_bin_capacity,
                cfg.forward_big_capacity, return_overflow=counted)
            _count(counters, "translucent.particles", dropped)
            acc, rev = _wboit(cfg, setup, bins, big, counts, ftris, fwd["uv"],
                              fwd["color"], depth, soft=True)
            hdr = blend_ops.resolve_oit(hdr, acc, rev, exposure=exposure)
    return hdr


def _deferred_frame(cfg: FrameConfig, state, draws, sceneset, prev, vtx, counters=None,
                    lights=None):
    """Every branch of `_frame` off the megakernel: (hdr, depth, vis,
    bin_overflow, ao_state, SSR inputs).  counters: the frame's counter
    dict or None; lights: host_light_counts(sceneset), or None where the
    counts are on the device (read back here once: read_light_counts)."""
    ex, uv, clip, wnormal, wtangent, worldp = vtx
    w, h, tx, ty = cfg.padded_width, cfg.padded_height, cfg.tiles_x, cfg.tiles_y
    proj, invview = sceneset["proj"], sceneset["invview"]
    with span("frame.shadows"):
        with span("frame.shadows.sun"):
            sun = _sun_shadows(cfg, ex, worldp, sceneset, counters)
        spotmaps = None
        if cfg.max_spot_shadows > 0:
            # perspective maps whatever spot_shadow_mode says, with the
            # early exit on as the reference's default
            with span("frame.shadows.spot"):
                overflow = None if counters is None else []
                spotmaps = shadow_ops.render_spot_maps(
                    worldp, ex["tris"], sceneset["spotlights"]["shadowview"],
                    cfg.max_spot_shadows, res=cfg.spot_shadow_res,
                    bin_capacity=cfg.shadow_bin_capacity, big_capacity=cfg.big_capacity,
                    use_kernel=cfg.use_pallas, overflow=overflow)
                _count(counters, "shadows.spot", overflow)
    with span("frame.raster"):
        depth, vis, gbuffer, bin_overflow = _deferred_raster(cfg, state, draws, ex, uv,
                                                             clip, wnormal, wtangent)
    with span("frame.planes"):
        if cfg.max_decals_active > 0:
            with span("frame.planes.decals"):
                _, wpos = reconstruct_positions(depth, proj, invview, w, h)
                gbuffer = apply_decals(gbuffer, wpos, draws["decals"],
                                       textures=state.get("textures"))
        with span("frame.planes.ssao"):
            ssao, ao_state = _deferred_ssao(cfg, depth, gbuffer, sceneset, prev)
    with span("frame.shade"):
        cluster = None
        if cfg.use_light_clusters:
            with span("frame.shade.clusters"):
                pl_ = sceneset["pointlights"]
                lists, counts = bin_lights(pl_["position"], pl_["attenuation"][:, 3],
                                           pl_["count"], sceneset["view"], proj, tx, ty,
                                           w, h, cfg.tile_light_capacity)
                cluster = (lists, counts, tx, ty)
        ibl = state.get("ibl")
        with span("frame.shade.lighting"):
            hdr = lighting_pass.shade_deferred(
                gbuffer, depth, sceneset, proj=proj, invview=invview, shadowmaps=sun,
                ibl=ibl, cluster=cluster, ssao=ssao, spotmaps=spotmaps,
                shadow_factor_scale=cfg.shadow_factor_scale,
                shadow_slice_blend=cfg.shadow_slice_blend,
                light_counts=read_light_counts(sceneset) if lights is None else lights)
        if ibl is not None:
            with span("frame.shade.sky"):
                hdr = _sky_fill(ibl, sceneset, hdr, gbuffer["mask"], w, h)
        if cfg.enable_fog:
            with span("frame.shade.fog"):
                fogvol = fog_ops.build_fog_volume(
                    sceneset, proj=proj, invview=invview,
                    shadow=sun if cfg.enable_shadows and cfg.shadow_mode == "esm" else None,
                    depth_range=cfg.fog_depth_range)
                hdr = fog_ops.apply_fog(hdr, depth, fogvol, proj,
                                        depth_range=cfg.fog_depth_range,
                                        sample_scale=cfg.fog_sample_scale)
        with span("frame.shade.fogplanes"):
            hdr = _fog_planes(cfg, hdr, depth, draws, sceneset)
    with span("frame.translucent"):
        hdr = _deferred_forward(cfg, state, draws, sceneset, hdr, depth, counters)
    return hdr, depth, vis, bin_overflow, ao_state, _ssr_inputs_gbuffer(gbuffer)


def _frame(cfg: FrameConfig, state, draws, sceneset, prev, vtx, lights=None):
    """The frame after its input stage: a branch, then the post passes.
    lights: as _deferred_frame's."""
    counters = {} if tracing() else None
    if use_shade_kernel(cfg, state):
        hdr, depth, vis, bin_overflow, ao_state, ssr_in = _megakernel_frame(
            cfg, state, draws, sceneset, prev, vtx, counters)
    else:
        hdr, depth, vis, bin_overflow, ao_state, ssr_in = _deferred_frame(
            cfg, state, draws, sceneset, prev, vtx, counters, lights)
    with span("frame.post"):
        image, lum = _post(cfg, state, draws, sceneset, hdr, depth, ssr_in)
    out = dict(image=image, luminance=lum, depth=depth, vis=vis,
               bin_overflow=bin_overflow)
    if ao_state is not None:
        # the temporal AO history: the next frame's `prev`
        out["ao_prev"] = dict(ao=ao_state, view=sceneset["view"])
    if counters is not None:
        out["counters"] = dict(counters, **{"raster.bins": bin_overflow})
    return out


def render_frame(cfg: FrameConfig, state, draws, sceneset, *, device, prev=None):
    """Render one frame on `device`.

    state: RenderContext.device_state(device) (or any tree of the same
    layout, e.g. the JAX package's state through convert.to_torch);
    draws: RenderContext.frame_draws (the draw arrays with, for the
    config's flags and capacities, the skinning palettes, "forward",
    "translucent", "decals", "fogplanes" and the dynamic-vertex slab
    "dyn", after the host expansion); sceneset:
    render.types.make_sceneset (with the SH probes).  draws
    and sceneset may be numpy trees; they are moved onto `device` here.
    prev: the previous frame's out["ao_prev"] (SSAO's temporal
    reprojection), or None.

    Returns dict(image (height, width, 3) u8, luminance () f32, depth
    and vis (padded H, W), bin_overflow () i32 of the main bins, with
    SSAO ao_prev: dict(ao (h, w, 2), view), and while the program's
    tracing is on (debug.set_tracing) counters: {name: () i32} of the
    entries dropped by the main bins ("raster.bins"), each shadow stack
    ("shadows.sun.<i>", "shadows.spot.<i>"), the lit layer's bins
    ("translucent.lit.0") and the WBOIT streams' ("translucent.wboit.0";
    the deferred branch's particles "translucent.particles.0"), counted
    on the device with no host sync), all on `device`.  While tracing is
    on the call is a "frame" span of the debug ring, its stages (input,
    shadows, raster, planes, translucent, shade, post) and their parts
    spans inside it.  On a CUDA
    device the rasters (K1 or K6, K3, K4, K5, K7) and the shade (K2 and
    its epilogue) run the hand-written kernels (they raise if they cannot
    launch; nothing falls back).  Without use_pallas the deferred branch
    runs the scan raster and the XLA blend as plain PyTorch on the
    device, as the reference does for that flag.  On a CUDA device every
    frame with use_pallas, on either branch, replays CUDA graphs from a
    key's second frame on (render/framegraph.py: what decides it, what
    it holds), with K1, K2, K5 and K4 launched between the graphs so
    that their wrappers see every launch; the outputs are then fresh
    copies, which the next frame leaves as they are.  Without use_pallas
    the frame runs eagerly (the scan raster reads device values on the
    host).  The deferred branch's light loops take their counts from
    sceneset's host arrays (host_light_counts); a sceneset with its
    counts on the device has them read back once a frame and runs
    eagerly.

    Contract on the card: f32 matmuls run in full f32.  The caller sets
    torch.backends.cuda.matmul.allow_tf32 = False and
    torch.backends.cudnn.allow_tf32 = False; with TF32 matmuls enabled
    on a CUDA device this raises, since the plane upsamples are matmuls
    and the reference is exact f32."""
    device = torch.device(device)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("render_frame: set torch.backends.cuda.matmul."
                         "allow_tf32 = False (the frame is f32)")
    lights = () if use_shade_kernel(cfg, state) else host_light_counts(sceneset)
    # the megakernel branch needs use_pallas too
    if device.type == "cuda" and cfg.use_pallas:
        return framegraph.render(cfg, state, draws, sceneset, prev, device, _eager_frame,
                                 _uploaded_frame, lights)
    statistic_hit("frame.graph.eager")
    return _eager_frame(cfg, state, draws, sceneset, prev, device, lights)


def host_light_counts(sceneset):
    """(point, spot) live light counts of sceneset as Python ints, read
    from its host arrays (0 for a kind it lacks); None when a count is
    a tensor on a device, where reading it would wait for the card."""
    counts = []
    for kind in ("pointlights", "spotlights"):
        c = (sceneset.get(kind) or {}).get("count", 0)
        if isinstance(c, torch.Tensor) and c.device.type != "cpu":
            return None
        counts.append(int(c))
    return tuple(counts)


def read_light_counts(sceneset):
    """(point, spot) live light counts of sceneset as Python ints: the
    host arrays' (host_light_counts), or where a count is a tensor on a
    device, that tensor read back (a host sync)."""
    return host_light_counts(sceneset) or tuple(
        int((sceneset.get(kind) or {}).get("count", 0))
        for kind in ("pointlights", "spotlights"))


def _input_stage(cfg: FrameConfig, state, draws, sceneset):
    """The input stage after the upload: (the state with the patched
    pool, the vertex stage's streams)."""
    # every stream below (the opaque draws, the lit layers, WBOIT, the
    # deferred branch's translucents) reads the patched pool
    with span("frame.input.dynamic"):
        state = patch_dynamic(cfg, state, draws)
    with span("frame.input.vertex"):
        vtx = _vertex_stage(cfg, state, draws, sceneset)
    return state, vtx


def _eager_frame(cfg: FrameConfig, state, draws, sceneset, prev, device, lights=None):
    """The frame launched op by op: the trees moved onto device, then the
    frame.  lights: as _deferred_frame's."""
    with span("frame"):
        with span("frame.input"):
            with span("frame.input.upload"):
                state = to_torch(state, device)
                draws = to_torch(draws, device)
                sceneset = to_torch(sceneset, device)
                if prev is not None:
                    prev = to_torch(prev, device)
            state, vtx = _input_stage(cfg, state, draws, sceneset)
        return _frame(cfg, state, draws, sceneset, prev, vtx, lights)


def _uploaded_frame(cfg: FrameConfig, state, draws, sceneset, prev, lights=None):
    """The frame on trees already on the device, as the frame graph
    captures it (render/framegraph.py).  lights: as _deferred_frame's."""
    with span("frame.input"):
        state, vtx = _input_stage(cfg, state, draws, sceneset)
    return _frame(cfg, state, draws, sceneset, prev, vtx, lights)
