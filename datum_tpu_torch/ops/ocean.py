"""FFT ocean (counterpart of datum_tpu/ops/ocean.py).

The Phillips spectrum and the wave frequencies are numpy, copied from
the JAX package, so both packages seed bit-equal spectra.  The spectrum
evolves and inverts on the tensor's device: `ocean_maps` runs one
torch.fft.ifft2 over the five stacked complex64 spectra (the JAX package
computes this FFT with jnp.fft outside any Pallas kernel, so a library
FFT is its counterpart), and `displace_grid` samples the periodic maps
over the render grid.
"""

from __future__ import annotations

import numpy as np
import torch

GRAVITY = 9.81


def phillips_spectrum(n=64, size=64.0, wind=(8.0, 4.0), amplitude=2e-5,
                      seed=0):
    """Seed h0(k).  Returns complex64 (n, n)."""
    rng = np.random.RandomState(seed)
    k1 = np.fft.fftfreq(n, d=size / (2 * np.pi * n))
    kx, ky = np.meshgrid(k1, k1, indexing="xy")
    k2 = kx * kx + ky * ky
    k2 = np.where(k2 == 0, 1e-12, k2)
    wind = np.asarray(wind, np.float64)
    wspeed = np.linalg.norm(wind)
    wdir = wind / max(wspeed, 1e-9)
    l = wspeed * wspeed / GRAVITY
    kdotw = (kx * wdir[0] + ky * wdir[1]) / np.sqrt(k2)
    ph = (amplitude * np.exp(-1.0 / (k2 * l * l)) / (k2 * k2)
          * kdotw ** 2)
    # suppress tiny waves + waves against the wind
    ph *= np.exp(-k2 * (size / n * 0.5) ** 2)
    ph = np.where(kdotw < 0, ph * 0.1, ph)
    ph[0, 0] = 0.0
    xi = rng.randn(n, n) + 1j * rng.randn(n, n)
    return (xi * np.sqrt(ph / 2.0)).astype(np.complex64)


def wave_frequencies(n=64, size=64.0):
    k1 = np.fft.fftfreq(n, d=size / (2 * np.pi * n))
    kx, ky = np.meshgrid(k1, k1, indexing="xy")
    k = np.sqrt(kx * kx + ky * ky)
    omega = np.sqrt(GRAVITY * k)
    return (kx.astype(np.float32), ky.astype(np.float32), k.astype(np.float32),
            omega.astype(np.float32))


def ocean_maps(h0, kx, ky, k, omega, t, choppiness=1.5):
    """Evolve and invert the spectrum at time t (tensors on one device;
    h0 complex64, kx/ky/k/omega f32, t an f32 scalar).

    Returns (displacement (n, n, 3) [dx, height, dz], normal (n, n, 3))."""
    n0, n1 = h0.shape
    phase = omega * t
    rot = torch.exp(1j * phase)
    ri = torch.remainder(-torch.arange(n0, device=h0.device), n0)
    ci = torch.remainder(-torch.arange(n1, device=h0.device), n1)
    h0_conj = torch.conj(h0[ri][:, ci])
    hk = h0 * rot + h0_conj * torch.conj(rot)

    ksafe = torch.where(k == 0, torch.full_like(k, 1e-12), k)
    # ONE batched inverse FFT over the five spectra (height, dx, dz, sx, sz)
    spectra = torch.stack([hk, 1j * kx / ksafe * hk, 1j * ky / ksafe * hk,
                           1j * kx * hk, 1j * ky * hk])
    height, dx, dz, sx, sz = torch.fft.ifft2(spectra).real * (n0 * n1)

    disp = torch.stack([-choppiness * dx, height, -choppiness * dz], -1)
    normal = torch.stack([-sx, torch.ones_like(sx), -sz], -1)
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    return disp.to(torch.float32), normal.to(torch.float32)


def displace_grid(base_xz, disp, normal, patch_size, swell=(0.0, 0.0, 0.0, 1.0)):
    """Sample the periodic maps at the grid positions (bilinear, wrapped
    with a floor-mod: the flow moves coordinates below 0).

    base_xz: (V, 3) flat grid vertices (y = 0); swell = (amp, dirx, dirz,
    wavelength), a Gerstner term.  Returns (positions (V, 3), normals
    (V, 3))."""
    n = disp.shape[0]
    u = base_xz[:, 0] / patch_size * n
    v = base_xz[:, 2] / patch_size * n

    def bil(m):
        x0 = torch.floor(u).to(torch.int64)
        y0 = torch.floor(v).to(torch.int64)
        fx = (u - x0)[:, None]
        fy = (v - y0)[:, None]
        x0 = torch.remainder(x0, n)
        y0 = torch.remainder(y0, n)
        x1 = torch.remainder(x0 + 1, n)
        y1 = torch.remainder(y0 + 1, n)
        a = m[y0, x0] * (1 - fx) + m[y0, x1] * fx
        b = m[y1, x0] * (1 - fx) + m[y1, x1] * fx
        return a * (1 - fy) + b * fy

    d = bil(disp)
    nrm = bil(normal)
    pos = base_xz + d

    amp, dx_, dz_, wl = swell
    if amp:
        freq = 2 * np.pi / wl
        ph = (base_xz[:, 0] * dx_ + base_xz[:, 2] * dz_) * freq
        pos = pos.clone()
        pos[:, 1] += amp * torch.sin(ph)
        # the analytic slope of amp * sin(freq * d.x)
        slope = amp * freq * torch.cos(ph)
        nrm = nrm.clone()
        nrm[:, 0] += -slope * dx_
        nrm[:, 2] += -slope * dz_
        nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
    return pos.to(torch.float32), nrm.to(torch.float32)


def water_color_lut(size=64, deep=(0.02, 0.08, 0.14), shallow=(0.10, 0.42, 0.40),
                    facing_tint=(0.25, 0.45, 0.55)):
    """Procedural water-colour LUT texture (numpy, (size, size, 4) f32
    rgba): axis u = depth scale (0 shallow -> 1 deep), axis v = fresnel
    facing (0 grazing -> 1 head-on); the top rows are pure-white foam."""
    u = np.linspace(0, 1, size, dtype=np.float32)[None, :, None]
    v = np.linspace(0, 1, size, dtype=np.float32)[:, None, None]
    deep = np.asarray(deep, np.float32)
    shallow = np.asarray(shallow, np.float32)
    tint = np.asarray(facing_tint, np.float32)
    rgb = shallow * (1 - u) + deep * u
    rgb = rgb * (1 - 0.5 * v) + tint * (0.5 * v)
    foam = np.clip((v - 0.9) / 0.1, 0, 1)
    rgb = rgb * (1 - foam) + foam
    a = np.ones((size, size, 1), np.float32)
    return np.concatenate([np.broadcast_to(rgb, (size, size, 3)), a], -1)


def ocean_lut_uv(pos, nrm, cam_pos, foamplane=(0.0, 1.0, 0.0, 0.0),
                 foamwaveheight=1.0, foamwavescale=0.0,
                 foamshoreheight=0.1, foamshorescale=0.0,
                 depthscale=0.05, waterdepth=20.0):
    """Per-vertex water-LUT coordinates with the wave and shore foam;
    the water depth is `waterdepth` minus the foam plane's height.
    Returns (V, 2) texcoords into water_color_lut."""
    f32 = dict(dtype=torch.float32, device=pos.device)
    cam = torch.as_tensor(cam_pos, **f32)
    eyevec = cam[None, :] - pos
    eyevec = eyevec / torch.clamp(torch.linalg.norm(eyevec, dim=-1, keepdim=True),
                                  min=1e-6)
    facing = torch.clamp(1.0 - torch.sum(eyevec * nrm, -1), 0.0, 1.0)

    fp = torch.as_tensor(foamplane, **f32)
    height = pos @ fp[:3] + fp[3]
    dist = torch.clamp(waterdepth - height, min=0.0)
    hw = height - foamwaveheight
    wavefoam = torch.clamp(hw * hw * hw * foamwavescale, 0.0, 1.0)
    # the reference's formula, with its foamshorescale = 0 case
    # (clamp(height, 0, 1))
    shorefoam = torch.clamp(height - (dist - foamshoreheight) * foamshorescale,
                            0.0, 1.0) * 0.27
    foam = torch.clamp(wavefoam + shorefoam, 0.0, 1.0)

    u = torch.clamp(depthscale * dist, 1e-3, 1.0)
    v = (1.0 - facing) * 0.88          # grazing -> lighter rows
    v = v + foam * (1.0 - v)           # foam whitens (v = 1 is white)
    return torch.stack([u, v], -1).to(torch.float32)
