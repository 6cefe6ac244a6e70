"""EnvMap resource: cubemap + roughness mip chain (counterpart of
datum_tpu/render/envmap.py).  The mips are baked once on the host with
the port's torch ops and kept as numpy, like the rest of the context's
pools; RenderContext.device_state moves them onto a device."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ibl as ibl_ops

N_MIPS = 7   # mip roughness resolution; deep mip feeds diffuse lookups


class EnvMap:
    def __init__(self, mips):
        self.mips = [np.asarray(m, np.float32) for m in mips]

    @classmethod
    def from_cubemap(cls, cube, n_mips=N_MIPS, samples=64):
        cube = torch.as_tensor(np.asarray(cube, np.float32))
        return cls([m.numpy() for m in
                    ibl_ops.build_specular_mips(cube, n_mips, samples)])

    @property
    def size(self):
        return int(self.mips[0].shape[1])
