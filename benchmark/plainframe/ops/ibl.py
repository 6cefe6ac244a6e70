"""Image-based lighting bakes: env-BRDF LUT, GGX prefilter, SH-9
projection and rotation (counterpart of datum_tpu/ops/ibl.py).

The sample sequences and the env-BRDF bake are numpy, as in the JAX
package; the cubemap bakes run in torch on whatever device the cube
lies on (the render context bakes on the host, once, when a skybox is
set)."""

from __future__ import annotations

import numpy as np
import torch

from .sampling import cubemap_texel_dir, sample_cubemap

PI = np.pi


def radical_inverse(i):
    bits = np.asarray(i, np.uint32)
    bits = (bits << np.uint32(16)) | (bits >> np.uint32(16))
    bits = ((bits & np.uint32(0x55555555)) << np.uint32(1)) | ((bits & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    bits = ((bits & np.uint32(0x33333333)) << np.uint32(2)) | ((bits & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    bits = ((bits & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | ((bits & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    bits = ((bits & np.uint32(0x00FF00FF)) << np.uint32(8)) | ((bits & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return bits.astype(np.float64) * 2.3283064365386963e-10


def hammersley(n):
    i = np.arange(n)
    return np.stack([i / n, radical_inverse(i)], -1).astype(np.float32)


def _ggx_sample_dirs(u, alpha):
    """Half-vector directions around +Z for GGX importance samples."""
    phi = 2 * PI * u[:, 0]
    costheta = np.sqrt((1 - u[:, 1]) / (1 + (alpha * alpha - 1) * u[:, 1]))
    sintheta = np.sqrt(np.maximum(1 - costheta * costheta, 0))
    return np.stack([sintheta * np.cos(phi), sintheta * np.sin(phi), costheta], -1)


def _g_smith_ibl(ndx, alpha):
    k = alpha / 2.0
    return ndx / (ndx * (1 - k) + k)


def _diffuse_disney_f32(ndv, ndl, ldh, alpha):
    """Disney diffuse (ops/brdf's formula) evaluated in float32, as the
    JAX package's bake evaluates it through jnp."""
    f = np.float32
    ndv, ndl, ldh, alpha = (np.asarray(v, f) for v in (ndv, ndl, ldh, alpha))
    energy_bias = f(0.5) * alpha
    energy_factor = f(1.0) + alpha * f(1.0 / 1.51 - 1.0)
    f90 = energy_bias + f(2.0) * ldh * ldh * alpha

    def schlick(u):
        x = np.clip(f(1.0) - u, f(0.0), f(1.0))
        x2 = x * x
        return f(1.0) + (f90 - f(1.0)) * (x2 * x2 * x)

    return schlick(ndl) * schlick(ndv) * energy_factor


def bake_envbrdf(size=64, samples=256):
    """Split-sum LUT (size, size, 3): [scale, bias, disney-diffuse],
    indexed [roughness_row, NdotV_col].  Pure numpy, run once."""
    u = hammersley(samples)
    ndv = (np.arange(size) + 0.5) / size
    rough = (np.arange(size) + 0.5) / size
    out = np.zeros((size, size, 3), np.float32)
    for yi, r in enumerate(rough):
        alpha = r * r
        h = _ggx_sample_dirs(u, alpha)                       # (N, 3)
        for xi, nv in enumerate(ndv):
            v = np.array([np.sqrt(max(1 - nv * nv, 0)), 0, nv])
            l = 2 * (h @ v)[:, None] * h - v
            ndl = np.clip(l[:, 2], 0, 1)
            ndh = np.clip(h[:, 2], 0, 1)
            vdh = np.clip(h @ v, 0, 1)
            ok = ndl > 0
            g = _g_smith_ibl(ndl, alpha) * _g_smith_ibl(nv, alpha)
            gv = np.where(ok & (ndh > 0), g * vdh / np.maximum(ndh * nv, 1e-6), 0)
            fc = (1 - vdh) ** 5
            a = np.sum((1 - fc) * gv) / samples
            b = np.sum(fc * gv) / samples

            # cosine-sampled Disney diffuse integral
            u2 = np.mod(u + 0.5, 1.0)
            phi = 2 * PI * u2[:, 0]
            ct = np.sqrt(1 - u2[:, 1])
            st = np.sqrt(u2[:, 1])
            ld = np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)
            ndl2 = np.clip(ld[:, 2], 0, 1)
            hv = v + ld
            hv /= np.maximum(np.linalg.norm(hv, axis=1, keepdims=True), 1e-9)
            ldh = np.clip(np.sum(ld * hv, 1), 0, 1)
            dd = _diffuse_disney_f32(nv, ndl2, ldh, alpha)
            c = np.sum(np.where(ndl2 > 0, dd, 0)) / samples
            out[yi, xi] = (a, b, c)
    return out


def cube_dirs(size, device="cpu"):
    """All texel directions of a (6, S, S) cubemap: (6, S, S, 3)."""
    u = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    return torch.stack([cubemap_texel_dir(f, uu, vv) for f in range(6)], 0)


def ggx_taps(n, roughness, samples):
    """The GGX prefilter's taps (N = V = R) about the texel normals n
    (..., 3): per sample, the light direction l (..., 3) and its weight
    n.l clamped to [0, 1] (..., 1)."""
    h_local = _ggx_sample_dirs(hammersley(samples), roughness * roughness)  # (N, 3)

    # tangent frame per texel
    f32 = dict(dtype=torch.float32, device=n.device)
    up = torch.where(torch.abs(n[..., 2:3]) < 0.999,
                     torch.tensor([0.0, 0.0, 1.0], **f32),
                     torch.tensor([1.0, 0.0, 0.0], **f32))
    t = torch.linalg.cross(up, n)
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-9)
    b = torch.linalg.cross(n, t)
    for i in range(h_local.shape[0]):
        hx, hy, hz = (float(np.float32(h_local[i, k])) for k in range(3))
        h = t * hx + b * hy + n * hz
        vdh = (n * h).sum(-1, keepdim=True)
        l = 2 * vdh * h - n
        yield l, torch.clamp((n * l).sum(-1, keepdim=True), 0.0, 1.0)


def convolve_cubemap(cube, roughness, samples=64):
    """GGX specular prefilter of one mip (N = V = R).  cube: (6, S, S, 3);
    returns the same shape."""
    if roughness <= 1e-3:
        return cube
    acc = torch.zeros_like(cube)
    wsum = torch.zeros(cube.shape[:-1] + (1,), dtype=torch.float32, device=cube.device)
    for l, ndl in ggx_taps(cube_dirs(cube.shape[1], cube.device), roughness, samples):
        acc = acc + sample_cubemap(cube, l) * ndl
        wsum = wsum + ndl
    return acc / torch.clamp(wsum, min=1e-6)


def build_specular_mips(cube, n_mips=6, samples=64):
    """Roughness mip chain: mip i is the previous one 2x2-averaged, then
    prefiltered at roughness i/(n_mips-1); stops below 4 texels."""
    mips = [cube]
    cur = cube
    for i in range(1, n_mips):
        s = cur.shape[1] // 2
        if s < 4:
            break
        cur = cur.reshape(6, s, 2, s, 2, cur.shape[-1]).mean((2, 4))
        mips.append(convolve_cubemap(cur, i / (n_mips - 1), samples))
    return mips


def _sh2_basis(d, xp=torch):
    """Band-2 real SH basis (..., 3) -> (..., 5), the constants and order
    of sh_project.  xp: array namespace (np for the constant below)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return xp.stack([1.092548 * x * y, 1.092548 * y * z,
                     0.315392 * (3 * z * z - 1), 1.092548 * z * x,
                     0.546274 * (x * x - y * y)], -1)


# Sloan's SH-rotation sampling trick: band 2 rotates via projection at 5
# fixed directions whose band-2 basis matrix is invertible
_K = np.float32(1.0 / np.sqrt(2.0))
_SH2_DIRS = np.array([[1, 0, 0], [0, 0, 1], [_K, _K, 0],
                      [_K, 0, _K], [0, _K, _K]], np.float32)
_SH2_INV = np.linalg.inv(_sh2_basis(_SH2_DIRS, xp=np)).astype(np.float32)


def rotate_sh9(sh, r_inv):
    """Rotate SH-9 coefficients (9, C) so that SH(out, n) == SH(sh,
    r_inv @ n); r_inv is the world->env rotation."""
    f32 = dict(dtype=sh.dtype, device=sh.device)
    r = r_inv.T                                     # env -> world
    u2 = r @ torch.stack([sh[3], sh[1], sh[2]], 0)  # band 1 as (x, y, z)
    b1 = torch.stack([u2[1], u2[2], u2[0]], 0)      # back to (y, z, x)
    nd = torch.as_tensor(_SH2_DIRS, **f32) @ r      # rows: r_inv @ N_i
    b2 = torch.as_tensor(_SH2_INV, **f32) @ (_sh2_basis(nd) @ sh[4:9])
    return torch.cat([sh[0:1], b1, b2], dim=0)


def sh_project(cube):
    """Cubemap (6, S, S, C) -> SH-9 irradiance coefficients (9, C), with
    analytic per-texel solid-angle weights scaled by 4 pi / total."""
    size = cube.shape[1]
    d = cube_dirs(size, cube.device)
    u = (torch.arange(size, dtype=torch.float32, device=cube.device) + 0.5) \
        / size * 2.0 - 1.0
    vv, uu = torch.meshgrid(u, u, indexing="ij")

    def _w(x, y):
        return torch.atan2(x * y, torch.sqrt(x * x + y * y + 1))

    x0, x1 = uu - 1.0 / size, uu + 1.0 / size
    y0, y1 = vv - 1.0 / size, vv + 1.0 / size
    w = (_w(x0, y0) - _w(x0, y1) - _w(x1, y0) + _w(x1, y1)).expand(6, size, size)

    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    basis = torch.stack([
        0.282095 * torch.ones_like(x),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3 * z * z - 1),
        1.092548 * z * x,
        0.546274 * (x * x - y * y),
    ], dim=0)                                               # (9, 6, S, S)
    total = w.sum()
    sh = torch.einsum("kfij,fij,fijc->kc", basis, w, cube[..., :3])
    return sh * (4 * PI / total)
