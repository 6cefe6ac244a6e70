"""Deferred material resolve: visibility buffer or raster planes ->
gbuffer (counterpart of datum_tpu/ops/shade.py).

`resolve_gbuffer` gathers each pixel's winning triangle's vertex
attributes, interpolates them with the barycentrics (its own, or K5's
`lam`), samples the legacy 256^2 texture pool (or the v2 material-map
table for the 'mip' filters) and encodes the gbuffer: diffuse+emissive,
specular+roughness, normal*0.5+0.5 and the coverage mask.
`gbuffer_from_planes` does the same from the fused rasters' (K1, K7)
interpolated planes, where only the texture tap is left.
`sample_matmaps` is the one-gather material-map tap, channel-first.

The integer bit math of sample_matmaps — `>>` for the mip size, `&` for
the REPEAT wrap and the exact `(4*(S^2 - s^2))//3` mip offset — runs on
int32 tensors, as in the JAX package."""

from __future__ import annotations

import torch

from . import brdf
from .blur import downsample_pool, resize_up_dense
from .raster import resolve_barycentrics
from .sampling import sample_bilinear


def _bdiff(a, axis, prev0=None):
    """Edge-clamped backward difference |a - a_prev| along axis; prev0,
    when given, is the slice before the first (a band's neighbour row)."""
    first = a.narrow(axis, 0, 1) if prev0 is None else prev0
    prev = torch.cat([first, a.narrow(axis, 0, a.shape[axis] - 1)], dim=axis)
    return torch.abs(a - prev)


def sample_matmaps(table, base, size, uv, pool=1, prev_uv_row=None):
    """One-gather trilinear-ready material sample from the combined mip
    table.

    table: (R, 48) u8 quad rows (render/texturepool.py layout); base,
    size: per-pixel (H, W) int32; uv: (H, W, 2).  The mip level comes
    from screen-space uv derivatives; `pool` notes the resolution divisor
    so derivatives stay calibrated at reduced resolution.

    prev_uv_row: optional (1, W, 2) row before row 0 (the tile-sharded
    frame passes the band above's last row, so that the band's first row
    takes the mip level the whole frame gives it).

    Returns (12, H, W) f32 in [0, 1]: albedo rgba, surface rgba, normal
    rgba, channel-first."""
    u, v = uv[..., 0], uv[..., 1]
    sf = size.to(torch.float32)
    pu = pv = None
    if prev_uv_row is not None:
        pu, pv = prev_uv_row[..., 0], prev_uv_row[..., 1]
    du = _bdiff(u, 1) + _bdiff(u, 0, pu)
    dv = _bdiff(v, 1) + _bdiff(v, 0, pv)
    span = torch.maximum(du, dv) * sf * (1.0 / max(pool, 1))
    lod = torch.log2(torch.clamp(span, min=1.0))
    max_lod = torch.log2(torch.clamp(sf, min=1.0))          # exact for pow2
    level = torch.minimum(torch.clamp(torch.round(lod), min=0.0),
                          max_lod).to(torch.int32)
    s_l = size >> level
    slf = s_l.to(torch.float32)
    # mip row offset: 4*(S^2 - (S>>l)^2)/3, exact for pow2 sizes
    mip_base = base + torch.div(4 * (size * size - s_l * s_l), 3,
                                rounding_mode="floor")

    x = u * slf - 0.5
    y = v * slf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).reshape(-1, 1)
    fy = (y - y0).reshape(-1, 1)
    # REPEAT wrap via bitwise AND: s_l is pow2 and two's-complement AND
    # wraps negatives correctly
    xi = x0.to(torch.int32) & (s_l - 1)
    yi = y0.to(torch.int32) & (s_l - 1)
    idx = mip_base + yi * s_l + xi
    hh, ww = idx.shape
    rows = table[idx.reshape(-1).long()].to(torch.float32) * (1.0 / 255.0)
    t00, t01 = rows[:, 0:12], rows[:, 12:24]
    t10, t11 = rows[:, 24:36], rows[:, 36:48]
    top = t00 + (t01 - t00) * fx
    bot = t10 + (t11 - t10) * fx
    out = top + (bot - top) * fy
    return out.T.reshape(12, hh, ww)


def _matmap_taps(table, base, size, uv, pool=1):
    """sample_matmaps as (albedo, surface, normal map) each (..., 4)."""
    out = sample_matmaps(table, base, size, uv, pool=pool).permute(1, 2, 0)
    return out[..., 0:4], out[..., 4:8], out[..., 8:12]


def _tbn_normal(nrm, tan3, tan_w, nmap_rgb):
    """The shaded normal from the interpolated TBN frame and a normal-map
    texel: one recipe for every gbuffer encode."""
    tgt = brdf.normalize(tan3 - nrm * (tan3 * nrm).sum(-1, keepdim=True))
    btg = torch.linalg.cross(nrm, tgt) * tan_w[..., None]
    tn = nmap_rgb * 2.0 - 1.0
    return brdf.normalize(tgt * tn[..., 0:1] + btg * tn[..., 1:2] + nrm * tn[..., 2:3])


def _encode_gbuffer(albedo_rgb, emissive, metalness, reflectivity, roughness,
                    shaded_n, mask):
    """The diffuse/specular/normal gbuffer planes, zero on the
    background."""
    m = brdf.make_material(albedo_rgb, emissive, metalness, reflectivity, roughness)
    roughness = torch.as_tensor(roughness).expand(emissive.shape)
    diffuse = torch.cat([m["diffuse"], emissive[..., None]], -1)
    specular = torch.cat([m["specular"], roughness[..., None]], -1)
    normal_out = torch.cat([shaded_n * 0.5 + 0.5,
                            torch.zeros_like(emissive)[..., None]], -1)
    bg = (~mask)[..., None]
    zero = torch.zeros_like(diffuse)
    return dict(diffuse=torch.where(bg, zero, diffuse),
                specular=torch.where(bg, zero, specular),
                normal=torch.where(bg, zero, normal_out), mask=mask)


def resolve_gbuffer(vis, setup, tris, tri_instance, attrs, instances, materials,
                    textures, width, height, material_maps=True, lam=None,
                    matmaps=None, y0=0):
    """vis (H, W) int32 triangle ids (-1 background); attrs dict(uv (V, 2),
    normal (V, 3), tangent (V, 4)); instances dict(material (I,));
    materials dict(color (M, 4), metalness/roughness/reflectivity/
    emissive (M,), albedomap/surfacemap/normalmap (M,)); textures (N, S,
    S, 4) u8, the legacy pool, tapped bilinearly.  lam: (H, W, 3)
    barycentrics (K5's), else resolve_barycentrics computes them.
    matmaps: dict(table, base, size) takes the albedo, surface and normal
    maps from the v2 material-map table instead (the 'mip' filters).  y0:
    vis's first row in the frame (a band of the tile-sharded frame).
    Returns dict(diffuse, specular, normal (H, W, 4), mask (H, W))."""
    if lam is None:
        lam, mask = resolve_barycentrics(vis, setup, width, height, y0=y0)
    else:
        mask = vis >= 0
    t = torch.clamp(vis, min=0).long()
    vid = tris.long()[t]                                        # (H, W, 3)
    a9 = torch.cat([attrs["uv"], attrs["normal"], attrs["tangent"]], -1)
    interp9 = (a9[vid] * lam[..., None]).sum(-2)
    uv = interp9[..., 0:2]
    tan, tan_w = interp9[..., 5:8], interp9[..., 8]
    mat = instances["material"].long()[tri_instance.long()[t]]     # (H, W)
    nrm = brdf.normalize(interp9[..., 2:5])
    if matmaps is not None:
        albedo_tex, surface_tex, normal_tex = _matmap_taps(
            matmaps["table"], matmaps["base"][mat], matmaps["size"][mat], uv)
    else:
        albedo_tex = sample_bilinear(textures, materials["albedomap"][mat], uv)
    if material_maps:
        if matmaps is None:
            surface_tex = sample_bilinear(textures, materials["surfacemap"][mat], uv)
            normal_tex = sample_bilinear(textures, materials["normalmap"][mat], uv)
        shaded_n = _tbn_normal(nrm, tan, tan_w, normal_tex[..., :3])
        surf_m, surf_r, surf_rough = (surface_tex[..., 0], surface_tex[..., 1],
                                      surface_tex[..., 3])
    else:
        shaded_n = nrm
        surf_m = surf_r = surf_rough = 1.0
    color = materials["color"][mat]
    return _encode_gbuffer(albedo_tex[..., :3] * color[..., :3],
                           materials["emissive"][mat],
                           materials["metalness"][mat] * surf_m,
                           materials["reflectivity"][mat] * surf_r,
                           materials["roughness"][mat] * surf_rough, shaded_n, mask)


def gbuffer_from_planes(planes, textures, texture_filter="nearest", matmaps=None):
    """The gbuffer from a fused raster's interpolated planes (dict(vis,
    uv (H, W, 2), normal, color (H, W, 3), emissive, metalness,
    roughness, reflectivity, albedo_id), plus tangent (H, W, 4),
    matmap_base and matmap_size for the 'mip' filters): only the texture
    tap is left.  texture_filter: 'none' (white), 'nearest',
    'nearest_half' / 'nearest_quarter' (nearest taps at 1/2 or 1/4
    resolution, upsampled), 'bilinear' (the legacy pool), or 'mip' /
    'mip_half' (the v2 table, at full or half resolution)."""
    mask = planes["vis"] >= 0
    nrm = brdf.normalize(planes["normal"])
    uv = planes["uv"]

    if texture_filter in ("mip", "mip_half"):
        h, w = uv.shape[:2]
        if texture_filter == "mip_half":
            p = 2
            packed = sample_matmaps(
                matmaps["table"], downsample_pool(planes["matmap_base"], p, reduce="first"),
                downsample_pool(planes["matmap_size"], p, reduce="first"),
                downsample_pool(uv, p), pool=p).permute(1, 2, 0)
            packed = resize_up_dense(packed, h, w)
            alb, srf, nmap = packed[..., 0:4], packed[..., 4:8], packed[..., 8:12]
        else:
            alb, srf, nmap = _matmap_taps(matmaps["table"], planes["matmap_base"],
                                          planes["matmap_size"], uv)
        tan = planes["tangent"]
        shaded_n = _tbn_normal(nrm, tan[..., :3], tan[..., 3], nmap[..., :3])
        return _encode_gbuffer(alb[..., :3] * planes["color"], planes["emissive"],
                               planes["metalness"] * srf[..., 0],
                               planes["reflectivity"] * srf[..., 1],
                               planes["roughness"] * srf[..., 3], shaded_n, mask)

    s = textures.shape[1]

    def nearest_tap(uv_, ids_):
        tx = torch.remainder((uv_[..., 0] * s).to(torch.int32), s)
        ty = torch.remainder((uv_[..., 1] * s).to(torch.int32), s)
        flat = textures.reshape(-1, textures.shape[-1])
        return flat[(ids_ * (s * s) + ty * s + tx).long()].to(torch.float32) / 255.0

    if texture_filter == "none":
        albedo = torch.ones(planes["color"].shape[:2] + (4,), dtype=torch.float32,
                            device=uv.device)
    elif texture_filter in ("nearest_half", "nearest_quarter"):
        p = 2 if texture_filter == "nearest_half" else 4
        h, w = uv.shape[:2]
        a_h = nearest_tap(downsample_pool(uv, p),
                          downsample_pool(planes["albedo_id"], p, reduce="first"))
        albedo = resize_up_dense(a_h, h, w)
    elif texture_filter == "nearest":
        albedo = nearest_tap(uv, planes["albedo_id"])
    else:
        albedo = sample_bilinear(textures, planes["albedo_id"], uv)
    return _encode_gbuffer(albedo[..., :3] * planes["color"], planes["emissive"],
                           planes["metalness"], planes["reflectivity"],
                           planes["roughness"], nrm, mask)
