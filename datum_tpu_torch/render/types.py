"""Frame parameter types and the SceneSet tree (counterpart of
datum_tpu/render/types.py; host numpy, copied).

make_sceneset packs the camera, params, light lists and SH probes into
the fixed-capacity arrays the frame consumes.  Every array is numpy here;
convert.to_torch moves the tree onto a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..debug.debug import traced
from ..ops.common import MAX_POINT_LIGHTS, MAX_SPOT_LIGHTS


def _spot_view(light):
    """World -> light-space rigid view for one spot (forward = -z)."""
    from ..math import Transform

    pos = np.asarray(light["position"], np.float32)
    d = np.asarray(light["direction"], np.float32)
    d = d / max(np.linalg.norm(d), 1e-9)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(np.dot(d, up))) > 0.99:
        up = np.array([1.0, 0.0, 0.0], np.float32)
    return Transform.lookat(pos, pos + d, up).inverse().matrix().astype(
        np.float32)


def _spot_shadowview(light):
    """Perspective shadow matrix for one spot light."""
    from ..math import perspective_proj

    view = _spot_view(light)
    half = np.arccos(np.clip(light["cutoff"], -0.999, 0.999))
    fov = np.clip(2.2 * half, 0.2, 2.8)
    zfar = float(light["attenuation"][3]) or 50.0
    proj = perspective_proj(fov, 1.0, 0.05, zfar)
    return (proj @ view).astype(np.float32)


def _skyrot_inv(params):
    """Inverse rotation of params.skyboxorientation (quat w,x,y,z)."""
    from ..math import quat_to_matrix

    q = np.asarray(getattr(params, "skyboxorientation",
                           [1.0, 0.0, 0.0, 0.0]), np.float32)
    r = np.asarray(quat_to_matrix(q), np.float32)
    return r.T


def _mainlight(camera, params):
    from .shadow import prepare_shadowview

    splits, shadowview = prepare_shadowview(camera, params.sundirection)
    return dict(
        direction=np.asarray(params.sundirection, np.float32),
        intensity=np.asarray(params.sunintensity, np.float32),
        cutoff=np.float32(params.suncutoff),
        splits=splits,
        shadowview=shadowview,
    )


@dataclasses.dataclass
class RenderParams:
    width: int = 1280
    height: int = 720
    # the frame renders at this fraction of the viewport and is blitted
    # back to it (RenderContext.render)
    scale: float = 1.0

    sundirection: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0], np.float32))
    sunintensity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 1.0, 1.0], np.float32))
    suncutoff: float = 0.7

    skyboxorientation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0, 0, 0], np.float32))
    skyboxlod: float = -1.0

    ambientintensity: float = 1.0
    specularintensity: float = 1.0
    lightfalloff: float = 1.0
    ssaostrength: float = 1.0
    ssrstrength: float = 1.0
    bloomstrength: float = 1.0

    fogdensity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.float32))
    fogattenuation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.15, 0.0], np.float32))


@traced("build.sceneset")
def make_sceneset(camera, params: RenderParams, *, point_lights=(), spot_lights=(),
                  probes=(), environments=(), prevview=None, n_probe=8):
    """Pack camera + params + lights + SH probes into the fixed-shape
    SceneSet tree (the JAX package's layout and capacities).

    point_lights: iterable of dict(position, intensity, attenuation).
    spot_lights:  iterable of dict(position, intensity, attenuation,
                  direction, cutoff).
    probes:       iterable of dict(position, sh (9, 3), radius), the
                  first n_probe of them kept (RenderList.push_probe).
    environments: accepted for the JAX package's signature and unused
                  there too (box probes live in the context's state).
    prevview:     the previous frame's view matrix (default: this view).
    """
    n_point, n_spot = MAX_POINT_LIGHTS, MAX_SPOT_LIGHTS
    proj = camera.proj()
    view = camera.view()
    invview = camera.transform().matrix()

    pl_pos = np.zeros((n_point, 3), np.float32)
    pl_int = np.zeros((n_point, 3), np.float32)
    pl_att = np.ones((n_point, 4), np.float32)
    falloff = np.float32(getattr(params, "lightfalloff", 1.0))
    for i, l in enumerate(point_lights[:n_point]):
        pl_pos[i] = l["position"]
        pl_int[i] = l["intensity"]
        pl_att[i] = l["attenuation"]
        pl_att[i, 3] *= falloff

    sl_pos = np.zeros((n_spot, 3), np.float32)
    sl_int = np.zeros((n_spot, 3), np.float32)
    sl_att = np.ones((n_spot, 4), np.float32)
    sl_dir = np.zeros((n_spot, 3), np.float32)
    sl_dir[:, 1] = -1
    sl_cut = np.zeros((n_spot,), np.float32)
    sl_view = np.tile(np.eye(4, dtype=np.float32), (n_spot, 1, 1))
    sl_rigid = np.tile(np.eye(4, dtype=np.float32), (n_spot, 1, 1))
    for i, l in enumerate(spot_lights[:n_spot]):
        sl_pos[i] = l["position"]
        sl_int[i] = l["intensity"]
        sl_att[i] = l["attenuation"]
        sl_att[i, 3] *= falloff
        sl_dir[i] = l["direction"]
        sl_cut[i] = l["cutoff"]
        sl_view[i] = _spot_shadowview(l)
        sl_rigid[i] = _spot_view(l)

    return dict(
        proj=proj.astype(np.float32),
        view=view.astype(np.float32),
        invview=invview.astype(np.float32),
        prevview=(prevview if prevview is not None else view).astype(np.float32),
        camera=dict(
            position=np.asarray(camera.position, np.float32),
            exposure=np.float32(camera.exposure),
            focalwidth=np.float32(camera.focalwidth),
            focaldistance=np.float32(camera.focaldistance),
            skyboxlod=np.float32(params.skyboxlod),
            ambientintensity=np.float32(params.ambientintensity),
            specularintensity=np.float32(params.specularintensity),
            ssrstrength=np.float32(params.ssrstrength),
            ssaostrength=np.float32(params.ssaostrength),
            bloomstrength=np.float32(params.bloomstrength),
            fogdensity=np.asarray(params.fogdensity, np.float32),
            fogattenuation=np.asarray(params.fogattenuation, np.float32),
            skyrot_inv=_skyrot_inv(params),
        ),
        mainlight=_mainlight(camera, params),
        pointlights=dict(
            position=pl_pos, intensity=pl_int, attenuation=pl_att,
            count=np.int32(min(len(point_lights), n_point)),
        ),
        spotlights=dict(
            position=sl_pos, intensity=sl_int, attenuation=sl_att,
            direction=sl_dir, cutoff=sl_cut, shadowview=sl_view,
            view=sl_rigid,
            count=np.int32(min(len(spot_lights), n_spot)),
        ),
        probes=_probes(probes, n_probe),
    )


def _probes(probes, n_probe):
    """SH irradiance probe table: position.xyz + radius in w (default
    5), 9x3 SH coefficients; rows past the count keep radius 1 and zero
    SH."""
    pos = np.zeros((n_probe, 4), np.float32)
    pos[:, 3] = 1.0
    sh = np.zeros((n_probe, 9, 3), np.float32)
    for i, p in enumerate(probes[:n_probe]):
        pos[i, :3] = p["position"]
        pos[i, 3] = p.get("radius", 5.0)
        sh[i] = np.asarray(p["sh"], np.float32).reshape(9, 3)
    return dict(position=pos, sh=sh, count=np.int32(min(len(probes), n_probe)))
