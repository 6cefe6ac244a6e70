"""Volumetric froxel fog (counterpart of datum_tpu/ops/fog.py: the
volume build and the megakernel's fog planes).

A 160x90x64 froxel grid of height-fog density lit by the sun (shadowed
through the coarsest ESM cascade, tapped on a half-resolution froxel
grid) and an ambient term is accumulated front to back along z (cumsum);
the screen taps read the volume at reduced resolution through one
quad-packed table (two row gathers and a z lerp per pixel) and are
upsampled to four full-resolution planes, which K2's epilogue applies as
col * fog_t + fog_rgb; the deferred (XLA) path applies the same taps to
its hdr image (`apply_fog`).  The analytic half-space fog planes
(`apply_fog_planes`, FrameConfig.max_fog_planes) blend over the lit
frame on both branches.
"""

from __future__ import annotations

import torch

from .blur import downsample_pool, resize_up_dense
from .common import FOG_D, FOG_DEPTH_EXPONENT, FOG_DEPTH_RANGE, FOG_H, FOG_W
from .sampling import quad_pack
from .shadow import shadow_factor_esm_fast


def froxel_depths(n=FOG_D, depth_range=FOG_DEPTH_RANGE, exponent=FOG_DEPTH_EXPONENT,
                  device=None):
    k = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    return torch.pow(k, exponent) * depth_range


def _cell_ndc(n, dev):
    return (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n * 2 - 1


def _world(iv, vx, vy, vz):
    """World x, y, z of view-space points (rigid inverse view iv)."""
    return tuple(iv[r, 0] * vx + iv[r, 1] * vy + iv[r, 2] * vz + iv[r, 3]
                 for r in range(3))


def _grid_world(proj, iv, fw, fh, ds):
    """World positions (3 tensors of (d, fh, fw)) of the froxel centres at
    view distances ds (d,)."""
    dev = ds.device
    inv00, inv11 = 1.0 / proj[0, 0], 1.0 / proj[1, 1]
    dist = ds[:, None, None]
    shape = (ds.shape[0], fh, fw)
    vx = (inv00 * _cell_ndc(fw, dev)[None, None, :] * dist).expand(shape)
    vy = (inv11 * _cell_ndc(fh, dev)[None, :, None] * dist).expand(shape)
    vz = (-dist).expand(shape)
    return _world(iv, vx, vy, vz)


def build_fog_volume(sceneset, *, proj, invview, shadow=None, fog_w=FOG_W,
                     fog_h=FOG_H, fog_d=FOG_D, depth_range=FOG_DEPTH_RANGE,
                     ambient=0.1):
    """(fog_d, fog_h, fog_w, 4): [in-scatter rgb, transmittance].

    Density follows the directional falloff fogdensity.a *
    exp(-max(dot(fogattenuation, world), 0)) (make_sceneset always packs
    fogattenuation).  shadow: build_esm's (esm, zmax, zscale) or None;
    only its coarsest cascade is tapped, with that cascade's matrix, on
    the half-resolution grid, repeated 2x on each axis."""
    cam, ml = sceneset["camera"], sceneset["mainlight"]
    fogdensity, fogatt = cam["fogdensity"], cam["fogattenuation"]
    dev = proj.device
    ds = froxel_depths(fog_d, depth_range, device=dev)
    wx, wy, wz = _grid_world(proj, invview, fog_w, fog_h, ds)
    d_ = fogatt[0] * wx + fogatt[1] * wy + fogatt[2] * wz
    sigma = fogdensity[3] * torch.exp(-torch.clamp(d_, min=0.0))
    sigma_rgb = fogdensity[:3] * sigma[..., None]

    light = ml["intensity"] + ambient
    if shadow is not None:
        esm, zmx, zsc = shadow[:3]
        cd, ch, cw = fog_d // 2, fog_h // 2, fog_w // 2
        ds_c = froxel_depths(cd, depth_range, device=dev)
        wp_c = torch.stack(_grid_world(proj, invview, cw, ch, ds_c), -1)
        dist_c = ds_c[:, None, None].expand(cd, ch, cw)
        sf_c = shadow_factor_esm_fast(
            wp_c.reshape(-1, 3), esm[-1:], zmx[-1:], zsc[-1:], ml["splits"][-1:],
            ml["shadowview"][-1:], dist_c.reshape(-1)).reshape(cd, ch, cw)
        sf = sf_c.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)
        light = ml["intensity"] * sf[..., None] + ambient

    # front-to-back accumulation along z
    dz = torch.diff(torch.cat([torch.zeros(1, device=dev), ds]))
    tau = torch.cumsum(sigma * dz[:, None, None], dim=0)
    transmit = torch.exp(-tau)
    scatter_step = sigma_rgb * light * (transmit * dz[:, None, None])[..., None]
    inscatter = torch.cumsum(scatter_step, dim=0)
    return torch.cat([inscatter, transmit[..., None]], -1)


def fog_sample(depth, fogvol, proj, *, depth_range=FOG_DEPTH_RANGE,
               exponent=FOG_DEPTH_EXPONENT, sample_scale=4, band_y0=0,
               full_height=None):
    """Reduced-resolution fog tap: ((hq, wq, 4) [in-scatter rgb,
    transmittance], q).  Two 16-float row gathers per pixel from one
    quad-packed table (xy bilinear in a row), the z pair lerped.  A band
    of rows: band_y0 its first row, full_height the frame's (full-res
    rows)."""
    h, w = depth.shape
    fog_d, fog_h, fog_w, _ = fogvol.shape
    dev = depth.device
    q = sample_scale
    while q > 1 and (h % q or w % q):
        q //= 2
    qtab = quad_pack(fogvol).reshape(-1, 16)            # (D*H*W, 16)

    dq = downsample_pool(depth, q, reduce="first")
    hq, wq = dq.shape
    dist = proj[2, 3] / torch.clamp(dq + proj[2, 2], min=1e-7)
    slice_f = (torch.pow(torch.clamp(dist / depth_range, 0.0, 1.0), 1.0 / exponent)
               * fog_d - 0.5)
    k0 = torch.clamp(torch.floor(slice_f), 0, fog_d - 1).to(torch.int64)
    fz = torch.clamp(slice_f - k0, 0.0, 1.0)[..., None]

    xf = (torch.arange(wq, dtype=torch.float32, device=dev) + 0.5) / wq * fog_w - 0.5
    fhq = full_height // q if full_height is not None else hq
    yf = ((torch.arange(hq, dtype=torch.float32, device=dev) + band_y0 // q + 0.5) / fhq
          * fog_h - 0.5)
    x0 = torch.clamp(torch.floor(xf), 0, fog_w - 1).to(torch.int64)[None, :]
    y0 = torch.clamp(torch.floor(yf), 0, fog_h - 1).to(torch.int64)[:, None]
    # a floor clamped at the low edge takes texel 0 (fraction 0)
    fx = torch.where(torch.floor(xf) < 0, torch.zeros_like(xf),
                     torch.clamp(xf - torch.floor(xf), 0.0, 1.0))[None, :, None]
    fy = torch.where(torch.floor(yf) < 0, torch.zeros_like(yf),
                     torch.clamp(yf - torch.floor(yf), 0.0, 1.0))[:, None, None]
    cell = y0 * fog_w + x0

    def xy_bilerp(rows):
        t00, t01, t10, t11 = rows[..., 0:4], rows[..., 4:8], rows[..., 8:12], rows[..., 12:16]
        top = t00 + (t01 - t00) * fx
        bot = t10 + (t11 - t10) * fx
        return top + (bot - top) * fy

    flat0 = k0 * (fog_h * fog_w) + cell
    flat1 = torch.clamp(k0 + 1, max=fog_d - 1) * (fog_h * fog_w) + cell
    fog_q = xy_bilerp(qtab[flat0])
    return fog_q + (xy_bilerp(qtab[flat1]) - fog_q) * fz, q


def fog_planes(depth, fogvol, proj, *, depth_range=FOG_DEPTH_RANGE,
               exponent=FOG_DEPTH_EXPONENT, sample_scale=4, y0=0, full_height=None):
    """The fog apply factors as 4 full-resolution (H, W) planes
    [in-scatter r, g, b, transmittance] for K2's epilogue.  y0 and
    full_height (full-res rows) place a band of rows in the frame."""
    h, w = depth.shape
    fog_q, q = fog_sample(depth, fogvol, proj, depth_range=depth_range,
                          exponent=exponent, sample_scale=sample_scale,
                          band_y0=y0, full_height=full_height)
    return [resize_up_dense(fog_q[..., c], h, w) if q > 1 else fog_q[..., c]
            for c in range(4)]


def apply_fog(hdr, depth, fogvol, proj, *, depth_range=FOG_DEPTH_RANGE,
              exponent=FOG_DEPTH_EXPONENT, sample_scale=4):
    """The fog volume over the hdr image (H, W, 3): color * transmittance
    + in-scatter, from the reduced-resolution taps upsampled."""
    h, w = depth.shape
    fog_q, q = fog_sample(depth, fogvol, proj, depth_range=depth_range,
                          exponent=exponent, sample_scale=sample_scale)
    fog = resize_up_dense(fog_q, h, w) if q > 1 else fog_q
    return hdr * fog[..., 3:4] + fog[..., :3]


def apply_fog_planes(hdr, depth, planes, *, proj, invview, exposure=1.0):
    """Analytic half-space fog planes blended over the lit frame hdr (H,
    W, 3): per pixel, the length of the view ray inside each fog
    half-space gives factor = exp2(-(density * dist)^2), and the plane's
    colour blends in with weight alpha * (1 - factor).  planes:
    dict(plane (K, 4), color (K, 4), density, startdistance, falloff (K,),
    count ()); the slots past count add nothing."""
    from .lighting_pass import reconstruct_positions

    h, w = depth.shape
    # the background (depth 0) lies at infinity: clamp, so the sky gets
    # the full-distance fog with finite arithmetic
    _, worldpos = reconstruct_positions(torch.clamp(depth, min=1e-7), proj,
                                        invview, w, h)
    campos = invview[:3, 3]
    v = campos - worldpos
    vlen = torch.clamp(torch.linalg.norm(v, dim=-1), max=1e7)
    for i in range(planes["plane"].shape[0]):
        pl = planes["plane"][i]
        fdotc = (pl[:3] * campos).sum() + pl[3]
        fdotp = worldpos @ pl[:3] + pl[3]
        fdotv = v @ pl[:3]
        k = (fdotc <= 0).to(torch.float32)
        c1 = torch.clamp(k * fdotp, max=0.0) + k * fdotc
        c2 = torch.where(fdotp <= 0, (1 - k) * fdotp, k * fdotc)
        t = torch.clamp(-0.5 * planes["falloff"][i]
                        * (c1 - c2 * fdotp / torch.clamp(torch.abs(fdotv), min=1e-6)),
                        max=1.0)
        dist = torch.clamp(t * vlen - planes["startdistance"][i], 0.0, 1e6)
        factor = torch.clamp(torch.exp2(-(planes["density"][i] * dist) ** 2), 0.0, 1.0)
        on = (i < planes["count"]).to(torch.float32)
        wgt = (planes["color"][i, 3] * (1.0 - factor) * on)[..., None]
        hdr = hdr * (1 - wgt) + exposure * planes["color"][i, :3] * wgt
    return hdr
