"""Canonical test scenes (counterpart of datum_tpu/scenes.py:
datumtest_scene and stress_scene).

The flagship scene: a grid of spheres sweeping roughness x metalness,
a checkered ground plane, point lights and a spot (shadowed when the
config asks for spot maps), lit by a procedural skybox and graded
through the fitted colour LUT; with the config's forward capacities,
also a glass sphere, a shallow water pool, two floor decals and a
256-particle cloud.  The stress scene: a dense geomorphed terrain, a
sphere wall and 128 clustered point lights.  Built on the port's own
numpy host side, so they need no jax.
"""

from __future__ import annotations

import numpy as np

from .debug.debug import traced
from .math import Transform

from .ops.common import FrameConfig
from .render import primitives
from .render.camera import Camera
from .render.context import RenderContext
from .render.renderlist import RenderList
from .render.types import RenderParams


class _ParticleCloud:
    """Minimal live-particle state for the scene's OIT pass (the arrays
    RenderList.forward_arrays reads)."""

    def __init__(self, positions, size=0.22, color=(1.0, 0.8, 0.45, 0.35)):
        n = len(positions)
        self.position = np.ascontiguousarray(positions, np.float32)
        self.size = np.full((n, 2), size, np.float32)
        self.rotation = np.zeros(n, np.float32)
        self.color = np.tile(np.asarray(color, np.float32), (n, 1))
        self.alive = np.ones(n, bool)


def bench_colorlut(size=32):
    """The flagship scene's colour-grading LUT (size^3 x 3): a mild S-curve
    contrast with warm highlights; smooth, so set_colorlut grades through
    its fitted polynomial."""
    gax = np.linspace(0.0, 1.0, size, dtype=np.float32)
    lb, lg, lr = np.meshgrid(gax, gax, gax, indexing="ij")
    lum_ = 0.2126 * lr + 0.7152 * lg + 0.0722 * lb
    con = lambda x: x + 0.12 * x * (1.0 - x) * (2.0 * x - 1.0)
    hw_ = lum_ ** 2
    return np.stack([
        con(lr) + 0.035 * hw_ * (1 - con(lr)),
        con(lg) + 0.010 * hw_ * (1 - con(lg)),
        con(lb),
    ], -1)


def datumtest_scene(width=1920, height=1080, *, sphere_detail=24, grid=(7, 5),
                    n_point_lights=8, skybox=True, skybox_size=64, local_env=False,
                    vertex_modes=False, ocean_grid=96, device="cuda", **cfg_kw):
    """Build the flagship scene; returns (ctx, camera, params,
    make_renderlist).  Materials, textures, meshes and the random light
    placement are the JAX package's, in the same order, so both packages
    build equal state for the same arguments.  device: where ctx.render
    draws and where the skybox bakes (render_frame takes its own).  With the config's
    max_fog_planes, the renderlist carries tests/test_kitchen_sink.py's
    fog plane.  local_env (needs the skybox): a box environment probe
    around the sphere grid, its cubemap a 64^2 procedural sky under a
    second sun, prefiltered at 5 levels, and 4 SH probes of that cubemap
    at the grid's corners (the local-environment frame; the JAX
    package's scene has no such option).  vertex_modes (also port-only):
    the animated vertex stage's content beside the bench's (see
    VertexModes): a skinned actor, 8x8 foliage blades and an FFT ocean;
    the config then defaults to VERTEX_MODES_CONFIG, the ocean has
    ocean_grid x ocean_grid cells, and make_renderlist carries the
    scene's VertexModes as make_renderlist.vertex_modes."""
    if vertex_modes:
        for k, v in VERTEX_MODES_CONFIG.items():
            cfg_kw.setdefault(k, v)
    cfg = FrameConfig(width=width, height=height, **cfg_kw)
    ctx = RenderContext(cfg, device=device)

    if skybox:
        from .render.skybox import SkyBox
        ctx.set_skybox(SkyBox(size=skybox_size, convolve_samples=16, device=device))

    verts, idx = primitives.unit_sphere(sphere_detail, sphere_detail // 2)
    sphere = ctx.add_mesh(verts, idx)
    pverts, pidx = primitives.plane(16.0, 8.0)
    ground = ctx.add_mesh(pverts, pidx)

    # checkerboard albedo for the floor
    checker = np.zeros((64, 64, 4), np.uint8)
    ii, jj = np.indices((64, 64))
    c = ((ii // 8) + (jj // 8)) % 2
    checker[..., :3] = np.where(c[..., None] > 0, 200, 90)
    checker[..., 3] = 255
    checker_tex = ctx.add_texture(checker)
    floor_mat = ctx.add_material(color=(1, 1, 1, 1), metalness=0.0, roughness=0.8,
                                 albedomap=checker_tex)

    # forward content (a glass sphere, a shallow water pool, two floor
    # decals, a particle cloud): registered always, so that material ids
    # and pool offsets match the JAX package's scene, and drawn when the
    # config carries the capacity
    glass_mat = ctx.add_material(color=(0.35, 0.55, 2.0, 0.42),
                                 metalness=0.0, roughness=0.12,
                                 reflectivity=0.9)
    water_mat = ctx.add_material(color=(0.12, 0.3, 0.42, 0.10),
                                 metalness=0.0, roughness=0.06,
                                 reflectivity=0.9, absorb=0.55)
    wverts, widx = primitives.plane(3.2, 1.0)
    water_patch = ctx.add_mesh(wverts, widx)

    gx, gy = grid
    sphere_mats = []
    for j in range(gy):
        for i in range(gx):
            rough = max(i / (gx - 1), 0.04)
            metal = j / (gy - 1)
            sphere_mats.append(ctx.add_material(
                color=(0.8, 0.16, 0.12, 1), metalness=metal, roughness=rough,
                reflectivity=0.5))

    ctx.set_colorlut(bench_colorlut())

    camera = Camera()
    camera.set_projection(np.radians(60), width / height)
    camera.lookat(np.array([0.0, 4.0, 14.0]), np.array([0.0, 2.0, 0.0]),
                  np.array([0.0, 1.0, 0.0]))

    params = RenderParams(width=width, height=height)
    params.sundirection = np.array([-0.7, -0.8, -0.2], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    params.sunintensity = np.array([4.0, 3.9, 3.7], np.float32)
    params.ambientintensity = 0.5

    rng = np.random.RandomState(42)
    light_pos = rng.uniform([-8, 0.5, -6], [8, 4.0, 6], (n_point_lights, 3))
    light_col = rng.uniform(0.5, 8.0, (n_point_lights, 3))
    n_particles = 256
    part_base = rng.uniform([-6, 0.5, -3], [6, 5.0, 3],
                            (n_particles, 3)).astype(np.float32)
    part_phase = rng.uniform(0, 2 * np.pi, n_particles).astype(np.float32)

    sh_probes = _local_environment(ctx, grid) if local_env else []
    vm = VertexModes(ctx, ocean_grid) if vertex_modes else None

    @traced("build.renderlist")
    def make_renderlist(t=0.0):
        rl = RenderList()
        for pos in sh_probes:
            rl.push_probe(pos, sh_probes[pos], radius=5.0)
        if cfg.max_fog_planes > 0:
            rl.push_fogplane((0.6, 0.65, 0.7, 0.5), plane=(0.0, 1.0, 0.0, -0.5),
                             density=0.05)
        rl.push_mesh(ground, Transform.identity(), floor_mat)
        k = 0
        for j in range(gy):
            for i in range(gx):
                x = (i - (gx - 1) / 2) * 2.2
                y = 1.0 + j * 2.2
                rl.push_mesh(sphere, Transform.translation([x, y, 0.0]),
                             sphere_mats[k])
                k += 1
        for li in range(n_point_lights):
            p = light_pos[li].copy()
            p[0] += np.sin(t + li) * 1.5
            rl.push_pointlight(p, light_col[li], (1.0, 0.0, 1.0), range_=12.0)
        # the spot over the sphere wall
        rl.push_spotlight(np.float32([4.0, 8.0, 6.0]),
                          np.float32([-0.35, -0.75, -0.55]),
                          np.float32([20.0, 19.0, 17.0]), cutoff=0.6,
                          attenuation=(0.5, 0.0, 1.0), range_=30.0)
        if cfg.max_translucent_draws > 0:
            # glass sphere front-right; shallow water pool front-left
            # (absorb > 0: depth-aware transmission and refraction)
            rl.push_translucent(sphere, Transform.translation([4.2, 1.1, 5.0]),
                                glass_mat)
            rl.push_translucent(water_patch,
                                Transform.translation([-4.5, 0.35, 5.0]),
                                water_mat)
        if cfg.max_decals_active > 0:
            rl.push_decal(Transform.translation([-1.5, 0.0, 6.0]),
                          [1.4, 0.8, 1.4], color=(0.75, 0.1, 0.05, 0.85),
                          roughness=0.35)
            rl.push_decal(Transform.translation([1.8, 0.0, 7.0]),
                          [1.0, 0.8, 1.0], color=(0.05, 0.05, 0.06, 0.9),
                          roughness=0.9)
        if cfg.max_particle_quads > 0:
            pos = part_base + np.stack(
                [np.sin(t * 0.7 + part_phase) * 0.8,
                 np.cos(t * 0.4 + part_phase) * 0.4 + 0.2,
                 np.cos(t * 0.6 + part_phase) * 0.8], -1).astype(np.float32)
            rl.push_particles(_ParticleCloud(pos), emissive=0.4)
        if vm is not None:
            vm.push(rl)
        return rl

    make_renderlist.vertex_modes = vm
    return ctx, camera, params, make_renderlist


# the vertex-modes scene's config: the three vertex modes on, a slab that
# holds the ocean's 9,409 vertices, room for its 18,432 triangles beside
# the bench's 20,162 (1<<15 cannot hold them), and main bins deep enough
# for the ocean's far rows, which crowd ~600 triangles into a 32x128 tile
VERTEX_MODES_CONFIG = dict(enable_skinning=True, enable_foliage=True,
                           max_dynamic_vertices=1 << 14, max_vertices=1 << 16,
                           max_triangles=1 << 16, bin_capacity=1024)


def _chain_rig(pos, pivots):
    """Per-vertex rig of a column over the joints at heights pivots
    (local y): each vertex blends the two joints around its height
    linearly (weights 0 on the other two slots)."""
    y = pos[:, 1]
    rig = np.zeros(len(pos), dtype=[("bone", np.int32, 4), ("weight", np.float32, 4)])
    seg = np.clip(np.searchsorted(pivots, y) - 1, 0, len(pivots) - 2)
    f = np.clip((y - pivots[seg]) / (pivots[seg + 1] - pivots[seg]), 0.0, 1.0)
    rig["bone"][:, 0] = seg
    rig["bone"][:, 1] = seg + 1
    rig["weight"][:, 0] = 1.0 - f
    rig["weight"][:, 1] = f
    return rig


def _sway(joints, pivots, axis, amplitude, duration, n_keys=5):
    """An Animation of the joint chain: each joint's key k is its offset
    from its parent then a rotation of amplitude * sin(2 pi k / (n_keys -
    1)) about axis, over duration seconds."""
    from .render.animation import Animation

    times, transforms, table = [], [], []
    for j, (name, parent) in enumerate(joints):
        off = [0.0, pivots[j] - (pivots[parent] if parent != j else 0.0), 0.0]
        table.append(dict(name=name, parent=parent, index=len(times), count=n_keys))
        for k in range(n_keys):
            times.append(duration * k / (n_keys - 1))
            a = amplitude * np.sin(2 * np.pi * k / (n_keys - 1))
            transforms.append((Transform.translation(off)
                               * Transform.rotation(axis, a)).flat())
    return Animation(duration, table, times, transforms)


class VertexModes:
    """The animated content of datumtest_scene(vertex_modes=True), on
    ctx's pools:
    - actor: a sphere stretched into a column (0.9 x 3 x 0.9 at detail
      24), rigged to a 3-joint chain with linear two-bone weights and
      animated by an Animator blending two looping channels, a sway
      about z (weight 0.6, 2 s) and a bow about x (weight 0.4, 1.5 s);
      right of the sphere wall;
    - foliage: 8x8 blades (unit_quad, 0.24 x 1.2, pivot at the root) in
      front of the actor, with the wind (0.8, 0, 0.3) and its time
      wind_time;
    - ocean: an opaque FFT ocean at examples/ocean.py's grid (96: 9,409
      vertices, 18,432 triangles; ocean_grid) and OceanParams over a
      16-unit patch on the left half of the floor, under the water LUT
      material.
    update(dt) advances the Animator, the Ocean and the wind time."""

    JOINTS = (("root", 0), ("mid", 0), ("tip", 1))
    PIVOTS = np.float32([-3.0, -1.0, 1.0])       # joint heights, mesh-local
    WIND = (0.8, 0.0, 0.3)

    def __init__(self, ctx, ocean_grid=96):
        from .render.animation import Animator
        from .render.ocean import Ocean, OceanParams

        sv, si = primitives.unit_sphere(24, 12)
        pos = sv["position"] * np.float32([0.9, 3.0, 0.9])
        self.actor = ctx.add_mesh(dict(sv, position=pos), si,
                                  rig=_chain_rig(pos, self.PIVOTS))
        qv, qi = primitives.unit_quad()
        blade = qv["position"] * np.float32([0.12, 0.6, 1.0]) + np.float32([0, 0.6, 0])
        self.blade = ctx.add_mesh(dict(qv, position=blade), qi)
        self.actor_mat = ctx.add_material(color=(0.85, 0.3, 0.2, 1), roughness=0.5)
        self.leaf_mat = ctx.add_material(color=(0.2, 0.8, 0.3, 1), roughness=0.8)
        self.water_mat = ctx.add_water_material()
        self.ocean = Ocean(ctx, grid=ocean_grid, patch_size=16.0,
                           params=OceanParams(wind=(9.0, 3.0), choppiness=1.6,
                                              swellamplitude=0.4))
        # inverse bind: each bone's bind pose is its joint's translation
        self.animator = Animator([(n, Transform.translation([0.0, -self.PIVOTS[i], 0.0]).flat())
                                  for i, (n, _) in enumerate(self.JOINTS)])
        self.animator.play(_sway(self.JOINTS, self.PIVOTS, [0, 0, 1.0], 0.35, 2.0),
                           weight=0.6)
        self.animator.play(_sway(self.JOINTS, self.PIVOTS, [1.0, 0, 0], 0.3, 1.5),
                           weight=0.4, rate=1.3)
        rng = np.random.RandomState(5)
        self.blades = [Transform.translation([5.2 + 0.45 * i, 0.0, 1.0 + 0.45 * j])
                       * Transform.rotation([0, 1.0, 0], float(rng.uniform(-0.8, 0.8)))
                       for j in range(8) for i in range(8)]
        self.wind_time = 0.0
        self.update(0.0)

    def update(self, dt):
        self.animator.update(dt)
        self.ocean.update(dt)
        self.wind_time += dt

    def push(self, rl):
        from .render.ocean import render_ocean_surface

        rl.push_actor(self.actor, Transform.translation([10.5, 3.0, -6.0]), self.actor_mat,
                      self.animator.palette())
        rl.push_foliage(self.blade, self.blades, self.leaf_mat,
                        wind=(*self.WIND, self.wind_time), bendscale=(0, 0.35, 0),
                        detailbendscale=(0, 0.1, 0))
        render_ocean_surface(self.ocean, rl, Transform.translation([-16.0, 0.25, -6.0]),
                             self.water_mat)


def _local_environment(ctx, grid):
    """Add the box environment probe around the sphere grid to ctx;
    returns the 4 SH probes as {position: (9, 3) SH-9 of its cubemap}."""
    import torch

    from .ops.ibl import sh_project
    from .ops.skybox_gen import generate_skybox

    if ctx.skybox is None:
        raise ValueError("datumtest_scene: local_env needs the skybox")
    sun2 = np.float32([0.5, -0.6, 0.62])
    cube = generate_skybox(64, skycolor=(0.65, 0.57, 0.475),
                           groundcolor=(0.41, 0.37, 0.32),
                           sundirection=sun2 / np.linalg.norm(sun2),
                           sunintensity=(8.0, 7.56, 7.88))
    gx, gy = grid
    hx, top = (gx - 1) / 2 * 2.2 + 1.4, 1.0 + (gy - 1) * 2.2 + 1.4
    ctx.add_environment([0.0, top / 2 - 0.25, 0.0], [hx, top / 2 + 0.25, 2.5],
                        cube.numpy(), levels=5)
    sh = sh_project(torch.as_tensor(cube)[..., :3]).numpy()
    return {(x, y, 2.0): sh for x in (-0.5 * hx, 0.5 * hx) for y in (1.5, 0.7 * top)}


def stress_scene(width=1920, height=1080, *, terrain_n=192, sphere_detail=36,
                 grid=(8, 4), n_point_lights=128, skybox=True, skybox_size=32,
                 device="cuda", **cfg_kw):
    """The dense-mesh, many-light stress scene (the JAX package's
    stress_scene): a Perlin terrain of 2*terrain_n^2 triangles with LOD
    geomorph and a wall of grid spheres at sphere_detail, lit by
    n_point_lights clustered point lights (64 a tile) and the sun.
    Defaults of the config: 1<<18 vertices and triangles, clusters,
    terrain morph.  Returns (ctx, camera, params, make_renderlist) like
    datumtest_scene, with equal state for the same arguments."""
    cfg_kw.setdefault("max_vertices", 1 << 18)
    cfg_kw.setdefault("max_triangles", 1 << 18)
    cfg_kw.setdefault("use_light_clusters", True)
    cfg_kw.setdefault("tile_light_capacity", 64)
    cfg_kw.setdefault("enable_terrain_morph", True)
    cfg = FrameConfig(width=width, height=height, **cfg_kw)
    ctx = RenderContext(cfg, device=device)

    if skybox:
        from .render.skybox import SkyBox
        ctx.set_skybox(SkyBox(size=skybox_size, convolve_samples=16, device=device))

    tverts, tidx = primitives.terrain(
        size=28.0, n=terrain_n, height=2.2,
        morph_grid=(4 if cfg.enable_terrain_morph else 0))
    ground = ctx.add_mesh(tverts, tidx)
    rock = np.zeros((64, 64, 4), np.uint8)
    ri, rj = np.indices((64, 64))
    c = ((ri // 4) + (rj // 4)) % 2
    rock[..., :3] = np.where(c[..., None] > 0, 150, 110)
    rock[..., 3] = 255
    ground_mat = ctx.add_material(color=(1, 1, 1, 1), roughness=0.85,
                                  albedomap=ctx.add_texture(rock))

    verts, idx = primitives.unit_sphere(sphere_detail, sphere_detail // 2)
    sphere = ctx.add_mesh(verts, idx)
    gx, gy = grid
    mats = []
    for j in range(gy):
        for i in range(gx):
            mats.append(ctx.add_material(
                color=(0.75, 0.2 + 0.5 * (i % 3) / 2, 0.15, 1),
                metalness=j / max(gy - 1, 1),
                roughness=max(i / max(gx - 1, 1), 0.05),
                reflectivity=0.5))

    camera = Camera()
    camera.set_projection(np.radians(60), width / height)
    camera.lookat(np.array([0.0, 6.0, 20.0]), np.array([0.0, 2.5, 0.0]),
                  np.array([0.0, 1.0, 0.0]))
    params = RenderParams(width=width, height=height)
    params.sundirection = np.array([-0.6, -0.75, -0.3], np.float32)
    params.sundirection /= np.linalg.norm(params.sundirection)
    params.sunintensity = np.array([3.5, 3.4, 3.2], np.float32)
    params.ambientintensity = 0.45

    rng = np.random.RandomState(11)
    light_pos = rng.uniform([-14, 0.8, -10], [14, 6.0, 12],
                            (n_point_lights, 3)).astype(np.float32)
    light_col = rng.uniform(0.5, 6.0, (n_point_lights, 3)).astype(np.float32)

    @traced("build.renderlist")
    def make_renderlist(t=0.0):
        rl = RenderList()
        if cfg.enable_terrain_morph:
            rl.push_terrain(ground, Transform.identity(), ground_mat, morph=(18.0, 34.0))
        else:
            rl.push_mesh(ground, Transform.identity(), ground_mat)
        k = 0
        for j in range(gy):
            for i in range(gx):
                x = (i - (gx - 1) / 2) * 3.0
                y = 2.0 + j * 2.6
                rl.push_mesh(sphere, Transform.translation([x, y, 0.0]), mats[k])
                k += 1
        for li in range(n_point_lights):
            p = light_pos[li].copy()
            p[0] += np.sin(t * 0.9 + li * 0.61) * 1.2
            p[2] += np.cos(t * 0.7 + li * 0.37) * 1.2
            rl.push_pointlight(p, light_col[li], (1.0, 0.0, 1.0), range_=7.0)
        return rl

    return ctx, camera, params, make_renderlist
