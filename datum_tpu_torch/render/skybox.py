"""SkyBox resource (counterpart of datum_tpu/render/skybox.py): the
procedural atmosphere (ops/skybox_gen.py, with its optional cloud
layer) followed by the GGX convolve chain over its mips."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops import skybox_gen
from .envmap import EnvMap, N_MIPS


@dataclasses.dataclass
class SkyBoxParams:
    skycolor: tuple = (0.65, 0.57, 0.475)
    groundcolor: tuple = (0.41, 0.37, 0.32)
    sundirection: tuple = (-0.4, -0.7, -0.6)
    sunintensity: tuple = (8.0, 7.56, 7.88)
    exposure: float = 1.0
    cloudheight: float = 100.0
    cloudcolor: tuple = (1.0, 1.0, 1.0, 0.0)
    clouds: object = None      # dict(density, normal) images, or None


class SkyBox(EnvMap):
    """Procedural sky environment."""

    def __init__(self, size=128, params: SkyBoxParams | None = None,
                 convolve_samples=32):
        self.gen_size = size
        self.convolve_samples = convolve_samples
        self.params = params or SkyBoxParams()
        sd = np.asarray(self.params.sundirection, np.float32)
        sd = sd / max(np.linalg.norm(sd), 1e-9)
        cube = skybox_gen.generate_skybox(
            size, skycolor=self.params.skycolor,
            groundcolor=self.params.groundcolor, sundirection=sd,
            sunintensity=self.params.sunintensity,
            exposure=self.params.exposure, clouds=self.params.clouds,
            cloudheight=self.params.cloudheight, cloudcolor=self.params.cloudcolor)
        super().__init__(EnvMap.from_cubemap(cube, N_MIPS, convolve_samples).mips)
