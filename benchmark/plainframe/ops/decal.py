"""Deferred decals (counterpart of datum_tpu/ops/decal.py): over the
shade planes (`apply_decals_planes`, the megakernel path) and over the
gbuffer (`apply_decals`, the deferred XLA path).

Each decal is an oriented box carrying an albedo, material and
optional texture overrides; it blends, densely and in draw order, into
the K2 input planes (encoded diffuse dr/dg/db, specular sr/sg/sb, rgh,
em and, with textures, the shaded normal) before the deferred shade.
A static loop over the active-decal capacity keeps shapes fixed.
"""

from __future__ import annotations

import torch

from . import brdf
from .blur import downsample_pool, resize_up_dense


def apply_decals(gbuffer, worldpos, decals, textures=None):
    """Blend the decals into the gbuffer's diffuse, specular and normal
    (H, W, 4) planes, densely and in draw order.  worldpos (H, W, 3);
    decals: RenderList.decal_arrays as tensors; textures: optional (N,
    S, S, 4) u8 pool of the decals' albedo and normal maps (nearest taps
    at full resolution; -1 = flat).  Returns a new gbuffer dict."""
    diffuse, specular, normal = gbuffer["diffuse"], gbuffer["specular"], gbuffer["normal"]
    maskf = gbuffer["mask"].to(torch.float32)
    has_tex = textures is not None and "albedomap" in decals
    for i in range(decals["position"].shape[0]):
        rot = decals["inv_rot"][i]
        hd = decals["halfdim"][i]
        local = (worldpos - decals["position"][i]) @ rot.T
        inside = torch.all(torch.abs(local) <= hd, dim=-1)
        active = (i < decals["count"]).to(torch.float32)
        a = decals["color"][i, 3] * inside.to(torch.float32) * active * maskf
        zfade = torch.clamp(1.5 - 1.5 * torch.abs(local[..., 2])
                            / torch.clamp(hd[2], min=1e-6), 0.0, 1.0)
        base_rgb = decals["color"][i, :3].expand(diffuse[..., :3].shape)
        if has_tex:
            uvd = local[..., :2] / torch.clamp(hd[:2], min=1e-6) * 0.5 + 0.5
            s = textures.shape[1]
            px = torch.clamp((uvd * s).to(torch.int32), 0, s - 1).long()
            aid = decals["albedomap"][i]
            tex = (textures[torch.clamp(aid, min=0).long(), px[..., 1], px[..., 0]]
                   .to(torch.float32) / 255.0)
            use = (aid >= 0).to(torch.float32)
            base_rgb = base_rgb * (1 - use) + base_rgb * tex[..., :3] * use
            a = a * (1 - use + tex[..., 3] * use)
            nid = decals["normalmap"][i]
            ntex = (textures[torch.clamp(nid, min=0).long(), px[..., 1], px[..., 0]]
                    .to(torch.float32) / 127.5 - 1.0)
            # the decal's tangent frame: the rows of its world->decal rotation
            nworld = ntex[..., 0:1] * rot[0] + ntex[..., 1:2] * rot[1] + ntex[..., 2:3] * rot[2]
            usen = (((nid >= 0) & inside).to(torch.float32) * active)[..., None] \
                * decals["color"][i, 3] * zfade[..., None] * (1 - use + tex[..., 3:4] * use)
            # blend the decoded normal, renormalise, re-encode
            blended = (normal[..., :3] * 2.0 - 1.0) * (1 - usen) + nworld * usen
            blended = blended / torch.clamp(torch.linalg.norm(blended, dim=-1, keepdim=True),
                                            min=1e-6)
            normal = torch.cat([blended * 0.5 + 0.5, normal[..., 3:]], -1)
        a = (a * zfade)[..., None]
        m = brdf.make_material(base_rgb, decals["emissive"][i], decals["metalness"][i],
                               decals["reflectivity"][i], decals["roughness"][i])
        diffuse = torch.cat([diffuse[..., :3] * (1 - a) + m["diffuse"] * a,
                             diffuse[..., 3:] * (1 - a) + decals["emissive"][i] * a], -1)
        specular = torch.cat([specular[..., :3] * (1 - a) + m["specular"] * a,
                              specular[..., 3:] * (1 - a) + decals["roughness"][i] * a], -1)
    return dict(gbuffer, diffuse=diffuse, specular=specular, normal=normal)


def apply_decals_planes(gpl, worldp, decals, mask, textures=None,
                        tap_scale=4):
    """Decal blend over the 2-D shade planes.

    gpl: dict of (H, W) planes (dr, dg, db, sr, sg, sb, rgh, em, nx, ny,
    nz); worldp: (wx, wy, wz) full-res world-position planes; decals:
    RenderList.decal_arrays as tensors; mask: (H, W) bool coverage.
    textures: optional (N, S, S, 4) uint8 pool; its taps run at
    1/tap_scale resolution and are upsampled densely.  Returns a new
    dict."""
    wx, wy, wz = worldp
    h, w = wx.shape
    out = dict(gpl)
    maskf = mask.to(torch.float32)

    if textures is not None:
        p = tap_scale
        wx_q = downsample_pool(wx, p, reduce="first")
        wy_q = downsample_pool(wy, p, reduce="first")
        wz_q = downsample_pool(wz, p, reduce="first")

    for i in range(decals["position"].shape[0]):
        rot = decals["inv_rot"][i]
        pos = decals["position"][i]
        hd = decals["halfdim"][i]
        dx, dy, dz = wx - pos[0], wy - pos[1], wz - pos[2]
        lx = rot[0, 0] * dx + rot[0, 1] * dy + rot[0, 2] * dz
        ly = rot[1, 0] * dx + rot[1, 1] * dy + rot[1, 2] * dz
        lz = rot[2, 0] * dx + rot[2, 1] * dy + rot[2, 2] * dz
        inside = ((torch.abs(lx) <= hd[0]) & (torch.abs(ly) <= hd[1])
                  & (torch.abs(lz) <= hd[2]))
        active = (i < decals["count"]).to(torch.float32)
        a = decals["color"][i, 3] * inside * active * maskf
        zfade = torch.clamp(1.5 - 1.5 * torch.abs(lz)
                            / torch.clamp(hd[2], min=1e-6), 0.0, 1.0)

        ones = torch.ones_like(wx)
        base = tuple(decals["color"][i, c] * ones for c in range(3))
        if textures is not None:
            # reduced-res texture taps (albedo rgba + normal), dense
            # upsample; flat decals (map id -1) keep the base colour
            dxq, dyq, dzq = wx_q - pos[0], wy_q - pos[1], wz_q - pos[2]
            lx_q = rot[0, 0] * dxq + rot[0, 1] * dyq + rot[0, 2] * dzq
            ly_q = rot[1, 0] * dxq + rot[1, 1] * dyq + rot[1, 2] * dzq
            u_q = torch.clamp(lx_q / torch.clamp(hd[0], min=1e-6) * 0.5 + 0.5,
                              0.0, 1.0)
            v_q = torch.clamp(ly_q / torch.clamp(hd[1], min=1e-6) * 0.5 + 0.5,
                              0.0, 1.0)
            s = textures.shape[1]
            px = torch.clamp((u_q * s).to(torch.int64), 0, s - 1)
            py = torch.clamp((v_q * s).to(torch.int64), 0, s - 1)
            aid = decals["albedomap"][i]
            tex_q = (textures[torch.clamp(aid, min=0).long(), py, px]
                     .to(torch.float32) / 255.0)
            use = (aid >= 0).to(torch.float32)
            tr, tg, tb, ta = (resize_up_dense(tex_q[..., c], h, w)
                              for c in range(4))
            base = tuple(b * (1 - use) + b * t * use
                         for b, t in zip(base, (tr, tg, tb)))
            a = a * (1 - use + ta * use)

            nid = decals["normalmap"][i]
            ntex_q = (textures[torch.clamp(nid, min=0).long(), py, px]
                      .to(torch.float32) / 127.5 - 1.0)
            nw = [resize_up_dense(ntex_q[..., 0] * rot[0, c]
                                  + ntex_q[..., 1] * rot[1, c]
                                  + ntex_q[..., 2] * rot[2, c], h, w)
                  for c in range(3)]
            # the same alpha and coverage gating as the colour blend
            # (maskf keeps background pixels' normal planes untouched)
            usen = ((nid >= 0).to(torch.float32) * inside * active
                    * decals["color"][i, 3] * zfade * maskf
                    * (1 - use + ta * use))
            bx = out["nx"] * (1 - usen) + nw[0] * usen
            by = out["ny"] * (1 - usen) + nw[1] * usen
            bz = out["nz"] * (1 - usen) + nw[2] * usen
            inv = 1.0 / torch.sqrt(torch.clamp(bx * bx + by * by + bz * bz,
                                               min=1e-12))
            out["nx"], out["ny"], out["nz"] = bx * inv, by * inv, bz * inv

        a = a * zfade

        # gbuffer-encode the decal material as the opaque planes are
        metal = decals["metalness"][i]
        refl = decals["reflectivity"][i]
        s0 = 0.16 * refl * refl
        one_m = 1.0 - metal
        for c, ch in enumerate("rgb"):
            dif_d = base[c] * one_m
            spc_d = s0 + (base[c] - s0) * metal
            out[f"d{ch}"] = out[f"d{ch}"] * (1 - a) + dif_d * a
            out[f"s{ch}"] = out[f"s{ch}"] * (1 - a) + spc_d * a
        out["em"] = out["em"] * (1 - a) + decals["emissive"][i] * a
        out["rgh"] = out["rgh"] * (1 - a) + decals["roughness"][i] * a
    return out
