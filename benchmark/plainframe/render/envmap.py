"""EnvMap resource: cubemap + roughness mip chain + SH-9 irradiance
(counterpart of datum_tpu/render/envmap.py).  The bakes (the GGX
prefilter chain of from_cubemap and convolve, the SH-9 projection of
project) run in torch on the caller's device, the card unless the caller
names another; the mips stay tensors on that device, and
RenderContext.set_skybox builds its tables where they lie."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ibl as ibl_ops

N_MIPS = 7   # mip roughness resolution; deep mip feeds diffuse lookups


class Irradiance:
    """9-coefficient SH irradiance: sh (9, 3) f32 on the host."""

    def __init__(self, sh):
        sh = sh.cpu().numpy() if isinstance(sh, torch.Tensor) else sh
        self.sh = np.asarray(sh, np.float32).reshape(9, 3)


def _f32(m, device=None):
    return torch.as_tensor(m, dtype=torch.float32, device=device)


class EnvMap:
    """mips: the (6, S, S, C) levels, as tensors (numpy levels become
    tensors on the host)."""

    def __init__(self, mips, sh=None):
        self.mips = [_f32(m) for m in mips]
        self.sh = sh

    @classmethod
    def from_cubemap(cls, cube, n_mips=N_MIPS, samples=64, device="cuda"):
        """Prefilter cube (6, S, S, C) into n_mips roughness levels on
        `device`."""
        return cls(ibl_ops.build_specular_mips(_f32(cube, device), n_mips, samples))

    @property
    def size(self):
        return int(self.mips[0].shape[1])

    @property
    def device(self):
        return self.mips[0].device

    def project(self, device="cuda") -> Irradiance:
        """SH-9 irradiance of the top level, projected on `device`."""
        return Irradiance(ibl_ops.sh_project(self.mips[0].to(device)))


def convolve(envmap: EnvMap, samples=64, device="cuda"):
    """Re-run the GGX prefilter chain from the top level, in place, on
    `device`, over as many levels as the map holds."""
    envmap.mips = ibl_ops.build_specular_mips(
        envmap.mips[0].to(device), len(envmap.mips) or N_MIPS, samples)
    return envmap


def project(envmap: EnvMap, device="cuda") -> Irradiance:
    return envmap.project(device)
