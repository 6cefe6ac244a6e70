"""The tile-sharded frame over torch.distributed ranks (counterpart of
datum_tpu/parallel/sharded.py, whose shard_map body runs once a device;
here the body runs once a rank, each rank a process with its Bands).

Work split, as the JAX package's:

- REPLICATED (scene-space, small beside the pixel work), on every rank:
  the vertex stage, the sun cascades and their ESM, the spot maps, the
  froxel fog volume, triangle setup and binning.  These are
  deterministic on every device (no kernel of theirs sums by atomics),
  so every rank holds the same bits.
- SHARDED by bands of whole tile rows, rank r the r-th band: the
  visibility raster (K1, or K6 with raster_two_phase, on the band's bin
  rows), plane assembly, the decals, the spot and sun factors, the lit
  layers, the WBOIT stream (K4), the light clusters, K2 and its epilogue,
  the composite (render/frame.py's stages in band mode).
- CROSS-BAND passes read reduced-resolution fields: each rank pools its
  band, all-gathers the pooled field, runs the pass on the whole frame's
  field and slices its band back out (SSAO, with its temporal history
  through `prev=`; then, in render/frame.py::post_rgb with the band's
  gather and rows closures, the binned or DDA SSR, bloom, DoF).  The band-local
  upsamples of reduced-resolution fields (sun and spot factors, the
  environment fields, the 15 half-res material planes) ride the same
  all-gather, upsample, slice closures (`up_to`, `up_to_batch`); the
  material taps' mip-LOD backward difference takes the row above the
  band from the neighbour band (`prev_row`); the sprite pass composites
  on the gathered display rgb.  So the image is the single-device
  frame's bit for bit.
- The luminance sums each band's log-luminance over all ranks.

The reduced path (`_render_sharded_reduced`) serves the configs off the
megakernel branch, as the JAX package's does: the scan raster,
`resolve_gbuffer` and the XLA lighting on each band, bloom with a halo
exchange; it renders that reduced feature set, not the single-device
deferred frame's.

PARITY EXCEPTION, as the JAX package's: at translucent_lit_scale > 1
the lit translucent layers shade at the band's full resolution (band
mode forces scale 1: the half-res planes' band-local upsamples would
clamp at band seams), so the sharded frame equals the single-device
frame bit for bit only at translucent_lit_scale == 1.  Like the JAX
package's sharded path, this one does not apply the analytic fog planes
(max_fog_planes).

jax.lax.ppermute is `ring_shift`: the ring wraps, and the frame's first
(and, for the halo, last) band masks what the wrap brings.
jax.lax.dynamic_slice's start clamps into the array (`_dslice`).

The byte ledger: `_ag` and `_pp` record, under the JAX package's
labels, the bytes a rank receives (an all-gather (n - 1) times the local
piece, a ring shift the piece); `ici_report()` gives the running totals
since its last reset (a frame's, when reset before each frame).  The
final gather of the
u8 image to every rank is not in it, as the JAX package's final image
is not.
"""

from __future__ import annotations

from collections import Counter

import torch

from ..convert import to_torch
from ..ops import brdf
from ..ops import lighting_pass
from ..ops import raster as raster_ops
from ..ops import shadow as shadow_ops
from ..ops.bloom import SIGMA, bloom_seed
from ..ops.blur import (downsample2, downsample_pool, gaussian_blur, resize_up_dense,
                        resize_up_dense_batch)
from ..ops.common import TILE_H, FrameConfig
from ..ops.composite import composite, to_u8_image
from ..ops.raster_cuda import raster_shade
from ..ops.shade import resolve_gbuffer
from ..ops.ssao import hbao, make_hbao_params
from ..render import frame as F
from .mesh import Bands, all_gather, all_reduce_sum, ring_shift

_LEDGER = Counter()


def _ag(bands: Bands, x, dim, label):
    """all_gather + ledger: a rank receives (n - 1) local pieces."""
    _LEDGER[label] += x.numel() * x.element_size() * (bands.world - 1)
    return all_gather(bands, x, dim)


def _pp(bands: Bands, x, step, label):
    """ring_shift + ledger: a rank receives one piece."""
    _LEDGER[label] += x.numel() * x.element_size()
    return ring_shift(bands, x, step)


def ici_report(reset=False):
    """The bytes a rank received by label, with "TOTAL", over the frames
    since the last reset."""
    agg = dict(_LEDGER, TOTAL=sum(_LEDGER.values()))
    if reset:
        _LEDGER.clear()
    return agg


def _dslice(x, start, size, dim):
    """jax.lax.dynamic_slice_in_dim: size entries from start along dim,
    the start clamped into [0, x.shape[dim] - size]."""
    start = min(max(int(start), 0), x.shape[dim] - size)
    return x.narrow(dim, start, size)


def render_frame_sharded(cfg: FrameConfig, bands: Bands, state, draws, sceneset,
                         prev=None):
    """Render one frame over the ranks of `bands`, each rank its band of
    cfg.tiles_y / world tile rows; every rank calls it with the same
    arguments.  state, draws, sceneset and prev as render_frame's.

    Returns, on every rank, dict(image (height, width, 3) u8 (the bands
    gathered), luminance, bin_overflow[, ao_prev]) on bands.device.  The
    megakernel branch's configs (render/frame.py::use_shade_kernel, the
    same gate) take the full path, the others the reduced one (module
    docstring).  Raises ValueError when tiles_y does not divide over the
    ranks."""
    n = bands.world
    if cfg.tiles_y % n:
        raise ValueError(f"tiles_y={cfg.tiles_y} must divide over {n} ranks")
    dev = bands.device
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("render_frame_sharded: set torch.backends.cuda.matmul."
                         "allow_tf32 = False (the frame is f32)")
    full = F.use_shade_kernel(cfg, state)
    # the reduced path's light loops run on host ints: read before the upload
    lights = None if full else F.read_light_counts(sceneset)
    state, draws, sceneset = (to_torch(t, dev) for t in (state, draws, sceneset))
    if prev is not None:
        prev = to_torch(prev, dev)
    if full:
        return _render_sharded_full(cfg, bands, state, draws, sceneset, prev)
    return _render_sharded_reduced(cfg, bands, state, draws, sceneset, lights)


def _band_luminance(bands: Bands, hdr, y0, cfg: FrameConfig):
    """Log-average luminance over the visible (uncropped) pixels, each
    band's sum of logs summed over the ranks."""
    dev = hdr.device
    rows_ok = (y0 + torch.arange(hdr.shape[0], device=dev) < cfg.height)[:, None]
    cols_ok = (torch.arange(hdr.shape[1], device=dev) < cfg.width)[None, :]
    ok = (rows_ok & cols_ok).to(torch.float32)
    lum_w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=torch.float32, device=dev)
    loglum = torch.sum(torch.log(1e-4 + hdr @ lum_w) * ok)
    return torch.exp(all_reduce_sum(bands, loglum) / (cfg.height * cfg.width))


def _band_geometry(cfg: FrameConfig, bands: Bands):
    """(tile0, the band's tiles, y0, band_h) of this rank."""
    tiles = (cfg.tiles_y // bands.world) * cfg.tiles_x
    tile0 = bands.rank * tiles
    return tile0, tiles, (tile0 // cfg.tiles_x) * TILE_H, (cfg.tiles_y // bands.world) * TILE_H


def _ssao_decimation(cfg: FrameConfig, band_h):
    """SSAO's decimation; it must divide the band height, or the per-band
    pooling would tear the gathered field at band edges."""
    dec = max(int(round(1.0 / cfg.ssao_scale)), 1)
    if band_h % dec:
        raise ValueError(f"ssao_scale {cfg.ssao_scale}: decimation {dec} must divide "
                         f"the band height {band_h}")
    return dec


def _render_sharded_full(cfg: FrameConfig, bands: Bands, state, draws, sceneset, prev):
    """The megakernel branch over the bands (module docstring)."""
    rank = bands.rank
    tx, ty = cfg.tiles_x, cfg.tiles_y
    w, h = cfg.padded_width, cfg.padded_height
    tile0, n_tiles, y0, band_h = _band_geometry(cfg, bands)
    with_ao = bool(cfg.enable_ssao and cfg.ssao_scale > 0)
    dec = _ssao_decimation(cfg, band_h) if with_ao else 1
    proj, view, invview = sceneset["proj"], sceneset["view"], sceneset["invview"]
    cam = sceneset["camera"]

    # ---- replicated: vertex stage, light-space passes, fog volume, binning
    state = F.patch_dynamic(cfg, state, draws)
    ex, uv, clip, wnormal, wtangent, worldp = F._vertex_stage(cfg, state, draws, sceneset)
    shadows = F._shadow_stage(cfg, ex, worldp, sceneset)
    fogvol = F.fog_volume(cfg, sceneset, shadows) if cfg.enable_fog else None
    setup, bins, counts, big_ids, overflow = F._bin_stage(cfg, ex, clip)

    # ---- this rank's band
    sl = slice(tile0, tile0 + n_tiles)
    planes = raster_shade(setup, bins[sl], big_ids, counts[sl], ex["tris"], uv, wnormal,
                          draws["tri_mat"], state["materials"], tx, ty, w, h,
                          tangent=wtangent, two_phase=cfg.raster_two_phase,
                          early_z=cfg.raster_early_z, tile0=tile0)
    depth = planes["depth"]

    def up_to(x, oh, ow):
        # all-gather the band-local field, upsample the frame's, slice
        # the band back out: a band-local upsample would clamp at band
        # edges and part from the single-device frame
        goh = int(round(h * (oh / band_h)))
        full = _ag(bands, x, 0, "up_to")
        return _dslice(resize_up_dense(full, goh, ow), (y0 * oh) // band_h, oh, 0)

    def up_to_batch(x3, oh, ow):            # (C, hh, ww) channel-first
        goh = int(round(h * (oh / band_h)))
        full = _ag(bands, x3, 1, "up_to_batch")
        return _dslice(resize_up_dense_batch(full, goh, ow), (y0 * oh) // band_h, oh, 1)

    def prev_row(x):
        # the row above the band's first row of a band-local field: the
        # band above's last row (the first band clamps to its own first
        # row, as the whole frame's edge does)
        from_above = _pp(bands, x[-1:], 1, "prev_row")
        return x[:1] if rank == 0 else from_above

    band = dict(y0=y0, full_h=h, tile0=tile0, up_to=up_to, up_to_batch=up_to_batch,
                prev_row=prev_row, fogvol=fogvol)
    ao_state = None
    if with_ao:
        # SSAO on the gathered reduced-res fields: its horizon taps cross
        # band edges as the single-device pass's do, and its temporal
        # history (prev, the same on every rank) threads the same way
        first = lambda x: downsample_pool(x, dec, reduce="first")
        dd = _ag(bands, first(depth), 0, "ssao")
        nn = _ag(bands, torch.stack([first(planes[k]) for k in ("nx", "ny", "nz")], -1),
                 0, "ssao")
        ao_state = hbao(dd, brdf.normalize(nn) * 0.5 + 0.5, proj, view,
                        params=make_hbao_params(),
                        prev_ao=None if prev is None else prev["ao"],
                        prevview=None if prev is None else prev["view"], invview=invview)
        ao_up = 1.0 + (resize_up_dense(ao_state[..., 0], h, w) - 1.0) * cam["ssaostrength"]
        band["ao"] = _dslice(ao_up, y0, band_h, 0)

    hdr, gpl, _ = F.shade_band(cfg, state, draws, sceneset, shadows, planes, band=band)
    lum = _band_luminance(bands, hdr, y0, cfg)

    # ---- the post passes, cross-band ones on gathered reduced-res fields
    band.update(gather=lambda x, label: _ag(bands, x, 0, label),
                rows=lambda x: _dslice(x, y0, band_h, 0))
    ssr_in = F._ssr_inputs_planes(gpl)
    if cfg.enable_ssr and cfg.ssr_mode != "binned":
        # the DDA march reads the normal and the specular planes; the JAX
        # package's band gathers its whole gbuffer for it, so the normal's
        # fourth channel and the diffuse planes ride along unread
        band["ssr_gbuffer"] = dict(
            normal=torch.cat([ssr_in[0], torch.zeros_like(depth)[..., None]], -1),
            specular=torch.stack([gpl["sr"], gpl["sg"], gpl["sb"], gpl["rgh"]], -1),
            diffuse=torch.stack([gpl["dr"], gpl["dg"], gpl["db"], gpl["em"]], -1))
    rgb = F.post_rgb(cfg, state, draws, sceneset, hdr, depth, ssr_in, band=band)
    image = all_gather(bands, to_u8_image(rgb), 0)
    out = dict(image=image[:cfg.height, :cfg.width], luminance=lum,
               bin_overflow=overflow)
    if ao_state is not None:
        # computed from gathered fields: the same on every rank
        out["ao_prev"] = dict(ao=ao_state, view=view)
    return out


def _render_sharded_reduced(cfg: FrameConfig, bands: Bands, state, draws, sceneset,
                            lights):
    """The reduced path over the bands (module docstring): the pool's own
    geometry (no dynamic slab, no vertex modes), sun cascades by the scan
    raster, the scan raster and resolve_gbuffer per band, the XLA
    lighting with an all-gather closure for its reduced-res fields, bloom
    with a halo exchange, the graded composite.  lights: the (point,
    spot) light counts as Python ints (render/frame.py::
    read_light_counts)."""
    n, rank = bands.world, bands.rank
    w, h = cfg.padded_width, cfg.padded_height
    tx, ty = cfg.tiles_x, cfg.tiles_y
    tile0, n_tiles, y0, _ = _band_geometry(cfg, bands)
    if "src_v" not in draws:
        raise ValueError("draws need the host draw expansion "
                         "(RenderContext.expand_host) before render_frame_sharded")
    proj, invview = sceneset["proj"], sceneset["invview"]

    # ---- replicated geometry stage
    ex = {k: draws[k] for k in ("tris", "tri_draw")}
    uv, clip, wnormal, wtangent, worldp = F._stream_vertices(state, draws, sceneset)
    shadowmaps = None
    if cfg.enable_shadows:
        ml = sceneset["mainlight"]
        raw = shadow_ops.render_shadow_cascades(
            worldp, ex["tris"], ml["shadowview"], res=cfg.shadow_res,
            bin_capacity=cfg.shadow_bin_capacity, big_capacity=cfg.big_capacity,
            use_kernel=False)
        shadowmaps = (shadow_ops.build_esm(raw, ml["shadowview"])
                      if cfg.shadow_mode == "esm" else raw)
    setup = raster_ops.triangle_setup(clip, ex["tris"], w, h, tx, ty,
                                      cull=-1 if cfg.backface_cull else 0)
    bins, counts, big_ids, overflow = raster_ops.bin_triangles(
        setup, cfg.max_triangles, tx, ty, cfg.bin_capacity, cfg.big_capacity,
        return_overflow=True)

    # ---- this rank's band
    depth, vis = raster_ops.raster(setup, bins[tile0:tile0 + n_tiles], big_ids, tx, ty,
                                   w, h, tile0=tile0)
    gbuffer = resolve_gbuffer(
        vis, setup, ex["tris"], ex["tri_draw"],
        dict(uv=uv, normal=wnormal, tangent=wtangent), dict(material=draws["material"]),
        state["materials"], state["textures"], w, h, y0=y0,
        material_maps=cfg.enable_material_maps)

    def up_to(x, oh, ow):
        # the reduced-res factor and env fields: all-gather, upsample the
        # frame's, slice the band back out
        full = _ag(bands, x, 0, "reduced_up")
        return _dslice(resize_up_dense(full, n * oh, ow), rank * oh, oh, 0)

    hdr = lighting_pass.shade_deferred(
        gbuffer, depth, sceneset, proj=proj, invview=invview, light_counts=lights,
        shadowmaps=shadowmaps if cfg.enable_shadows else None,
        full_size=(h, w), y0=y0, up_to=up_to, use_kernel=cfg.use_pallas)
    lum = _band_luminance(bands, hdr, y0, cfg)

    bloom_img = None
    if cfg.enable_bloom:
        # the blur reaches across band edges: halo rows from the
        # neighbours (zero beyond the frame's first and last band), blur,
        # upsample with the halo attached, slice the band
        seeded = bloom_seed(downsample2(downsample2(hdr)))
        halo = min(16, seeded.shape[0])
        from_above = _pp(bands, seeded[-halo:], 1, "halo")
        from_below = _pp(bands, seeded[:halo], -1, "halo")
        first = float(rank == 0)
        last = float(rank == n - 1)
        ext = torch.cat([from_above * (1 - first), seeded, from_below * (1 - last)], 0)
        blurred = gaussian_blur(ext, SIGMA * 0.5)
        up = resize_up_dense(blurred, 4 * blurred.shape[0], hdr.shape[1])
        bloom_img = up[4 * halo:4 * halo + hdr.shape[0]] * sceneset["camera"]["bloomstrength"]

    grading = cfg.enable_color_grading
    rgb = composite(hdr, 1.0, bloom=bloom_img, bloom_strength=1.0,
                    lut=state.get("colorlut") if grading else None,
                    lut_poly=state.get("colorlut_poly") if grading else None)
    image = all_gather(bands, to_u8_image(rgb), 0)
    return dict(image=image[:cfg.height, :cfg.width], luminance=lum,
                bin_overflow=overflow)
