"""SkyBox resource (counterpart of datum_tpu/render/skybox.py): the
procedural atmosphere (ops/skybox_gen.py, with its optional cloud
layer) followed by the GGX convolve chain over its mips, both on the
caller's device (the card unless the caller names another), and
render_skybox, the re-bake after a parameter change."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops import skybox_gen
from .envmap import N_MIPS, EnvMap


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
    """Procedural sky environment, baked on `device`."""

    def __init__(self, size=128, params: SkyBoxParams | None = None,
                 convolve_samples=32, device="cuda"):
        self.gen_size = size
        self.convolve_samples = convolve_samples
        self.params = params or SkyBoxParams()
        cube = self._generate(self.params, device)
        super().__init__(EnvMap.from_cubemap(cube, N_MIPS, convolve_samples,
                                             device=device).mips)

    def _generate(self, params: SkyBoxParams, device="cuda"):
        """The (6, gen_size, gen_size, 3) atmosphere cube of params."""
        sd = np.asarray(params.sundirection, np.float32)
        sd = sd / max(np.linalg.norm(sd), 1e-9)
        return skybox_gen.generate_skybox(
            self.gen_size, skycolor=params.skycolor, groundcolor=params.groundcolor,
            sundirection=sd, sunintensity=params.sunintensity,
            exposure=params.exposure, clouds=params.clouds,
            cloudheight=params.cloudheight, cloudcolor=params.cloudcolor,
            device=device)


def render_skybox(skybox: SkyBox, params: SkyBoxParams | None = None, device="cuda"):
    """Regenerate the atmosphere (with params, when given) and re-run the
    convolve chain on `device`; the skybox's mips are replaced."""
    if params is not None:
        skybox.params = params
    cube = skybox._generate(skybox.params, device)
    skybox.mips = EnvMap.from_cubemap(cube, N_MIPS, skybox.convolve_samples,
                                      device=device).mips
    return skybox
