"""RenderList: the per-frame draw-building facade (counterpart of
datum_tpu/render/renderlist.py, trimmed to what the port renders:
meshes, terrain with geomorph, foliage with its wind bends, skinned
actors with their palettes, shadow casters, oceans, translucent meshes,
point and spot lights, SH probes, decals, fog planes, particle
billboards, overlay sprites and text, and their fixed-capacity
arrays)."""

from __future__ import annotations

import numpy as np

from ..math import Transform, quat_to_matrix


class RenderList:
    def __init__(self):
        self.draws = []          # dict(mesh, transform(3,4), material)
        self.casters = []        # shadow-casting subset
        self.point_lights = []
        self.spot_lights = []
        self.translucents = []
        self.oceans = []         # dynamic ocean surfaces (the first feeds the slab)
        self.decals = []
        self.fogplanes = []
        self.probes = []
        self.particles = []      # forward OIT billboard systems
        self.sprites = []        # overlay sprites and text, in draw order

    def push_mesh(self, mesh, transform, material, caster=True):
        m = _to_affine(transform)
        self.draws.append(dict(mesh=mesh.mesh_id, transform=m, material=material))
        if caster:
            self.casters.append(dict(mesh=mesh.mesh_id, transform=m, material=material))

    push_geometry = push_mesh

    def push_foliage(self, mesh, transforms, material, wind=(0, 0, 0, 0),
                     bendscale=(0, 0.025, 0), detailbendscale=(0, 0.025, 0),
                     caster=True):
        """Instanced foliage with the wind bends: wind.xyz = direction *
        strength, wind.w = time.  Needs FrameConfig.enable_foliage."""
        if not isinstance(transforms, (list, tuple)):
            transforms = [transforms]
        for t in transforms:
            m = _to_affine(t)
            self.draws.append(dict(
                mesh=mesh.mesh_id, transform=m, material=material,
                wind=np.asarray(wind, np.float32),
                bendscale=np.asarray(bendscale, np.float32),
                detailbendscale=np.asarray(detailbendscale, np.float32)))
            if caster:
                self.casters.append(dict(mesh=mesh.mesh_id, transform=m,
                                         material=material))

    def push_terrain(self, mesh, transform, material, morph=(24.0, 48.0),
                     caster=True):
        """Terrain draw with LOD geomorph: the mesh carries baked morph
        targets (as the port's primitives.terrain(morph_grid=...) bakes
        them); morph = (morphbeg, morphend) camera distances.  Needs
        FrameConfig.enable_terrain_morph."""
        m = _to_affine(transform)
        self.draws.append(dict(mesh=mesh.mesh_id, transform=m, material=material,
                               morph=np.asarray(morph, np.float32)))
        if caster:
            self.casters.append(dict(mesh=mesh.mesh_id, transform=m,
                                     material=material))

    def push_actor(self, mesh, transform, material, palette, caster=True):
        """Skinned draw: palette is the Animator's (B, 8) dual-quat bone
        palette.  Needs FrameConfig.enable_skinning."""
        m = _to_affine(transform)
        self.draws.append(dict(mesh=mesh.mesh_id, transform=m, material=material,
                               palette=np.asarray(palette, np.float32)))
        if caster:
            self.casters.append(dict(mesh=mesh.mesh_id, transform=m,
                                     material=material))

    def push_caster(self, mesh, transform, material=0):
        self.casters.append(dict(mesh=mesh.mesh_id, transform=_to_affine(transform),
                                 material=material))

    def caster_arrays(self, max_draws):
        mesh = np.zeros(max_draws, np.int32)
        world = np.zeros((max_draws, 3, 4), np.float32)
        world[:, :, :3] = np.eye(3)
        n = min(len(self.casters), max_draws)
        for i, d in enumerate(self.casters[:n]):
            mesh[i] = d["mesh"]
            world[i] = d["transform"]
        return dict(mesh=mesh, world=world, count=np.int32(n))

    def push_translucent(self, mesh, transform, material):
        """Translucent mesh (material alpha < 1): the lit glass/water
        layers and the weighted-blend OIT residual."""
        self.translucents.append(dict(mesh=mesh.mesh_id,
                                      transform=_to_affine(transform),
                                      material=material))

    def translucent_arrays(self, max_draws, default_material):
        mesh = np.zeros(max_draws, np.int32)
        world = np.zeros((max_draws, 3, 4), np.float32)
        world[:, :, :3] = np.eye(3)
        material = np.full(max_draws, default_material, np.int32)
        n = min(len(self.translucents), max_draws)
        for i, d in enumerate(self.translucents[:n]):
            mesh[i] = d["mesh"]
            world[i] = d["transform"]
            material[i] = d["material"]
        return dict(mesh=mesh, world=world, material=material, count=np.int32(n))

    def push_pointlight(self, position, intensity, attenuation=(1.0, 0.0, 0.0, 0.0),
                        range_=None):
        att = np.asarray(attenuation, np.float32).copy()
        if att.shape == (3,):
            att = np.append(att, range_ if range_ is not None else _attenuation_range(att))
        elif range_ is not None:
            att[3] = range_
        elif att[3] == 0:
            att[3] = _attenuation_range(att[:3])
        self.point_lights.append(dict(position=np.asarray(position, np.float32),
                                      intensity=np.asarray(intensity, np.float32),
                                      attenuation=att))

    def push_spotlight(self, position, direction, intensity, cutoff=0.7,
                       attenuation=(1.0, 0.0, 0.0, 0.0), range_=None):
        att = np.asarray(attenuation, np.float32).copy()
        if att.shape == (3,):
            att = np.append(att, range_ if range_ is not None else _attenuation_range(att))
        d = np.asarray(direction, np.float32)
        d = d / max(np.linalg.norm(d), 1e-9)
        self.spot_lights.append(dict(position=np.asarray(position, np.float32),
                                     direction=d,
                                     intensity=np.asarray(intensity, np.float32),
                                     attenuation=att, cutoff=float(cutoff)))

    def push_probe(self, position, sh, radius=5.0):
        """SH irradiance probe: sh (9, 3) coefficients, blended in within
        radius of position."""
        self.probes.append(dict(position=np.asarray(position, np.float32),
                                sh=np.asarray(sh, np.float32), radius=radius))

    def push_decal(self, transform, halfdim, color=(1, 1, 1, 1), metalness=0.0,
                   roughness=1.0, reflectivity=0.5, emissive=0.0,
                   albedomap=-1, normalmap=-1):
        """Oriented-box decal; albedomap/normalmap are texture-pool ids
        (-1 flat)."""
        self.decals.append(dict(
            position=np.asarray(transform.translation_vec(), np.float32),
            inv_rot=quat_to_matrix(transform.rotation_quat()).T.astype(np.float32),
            halfdim=np.asarray(halfdim, np.float32),
            color=np.asarray(color, np.float32),
            metalness=metalness, roughness=roughness,
            reflectivity=reflectivity, emissive=emissive,
            albedomap=albedomap, normalmap=normalmap))

    def decal_arrays(self, max_decals):
        out = dict(
            position=np.zeros((max_decals, 3), np.float32),
            inv_rot=np.tile(np.eye(3, dtype=np.float32), (max_decals, 1, 1)),
            halfdim=np.ones((max_decals, 3), np.float32),
            color=np.zeros((max_decals, 4), np.float32),
            metalness=np.zeros(max_decals, np.float32),
            roughness=np.ones(max_decals, np.float32),
            reflectivity=np.full(max_decals, 0.5, np.float32),
            emissive=np.zeros(max_decals, np.float32),
            albedomap=np.full(max_decals, -1, np.int32),
            normalmap=np.full(max_decals, -1, np.int32),
            count=np.int32(min(len(self.decals), max_decals)),
        )
        for i, d in enumerate(self.decals[:max_decals]):
            for k in ("position", "inv_rot", "halfdim", "color", "metalness",
                      "roughness", "reflectivity", "emissive", "albedomap",
                      "normalmap"):
                out[k][i] = d[k]
        return out

    def push_fogplane(self, color, plane=(0.0, 1.0, 0.0, -4.0), density=0.01,
                      startdistance=10.0, falloff=0.5):
        """Analytic half-space fog: color (rgb, alpha), the plane (n, d)
        with the fog where n . p + d <= 0, its density, the distance the
        fog starts at and its falloff."""
        self.fogplanes.append(dict(
            color=np.asarray(color, np.float32),
            plane=np.asarray(plane, np.float32),
            density=density, startdistance=startdistance, falloff=falloff))

    def fogplane_arrays(self, max_planes):
        out = dict(
            plane=np.tile(np.array([0, 1, 0, -1e9], np.float32), (max_planes, 1)),
            color=np.zeros((max_planes, 4), np.float32),
            density=np.zeros(max_planes, np.float32),
            startdistance=np.zeros(max_planes, np.float32),
            falloff=np.full(max_planes, 0.5, np.float32),
            count=np.int32(min(len(self.fogplanes), max_planes)),
        )
        for i, p in enumerate(self.fogplanes[:max_planes]):
            for k in ("plane", "color", "density", "startdistance", "falloff"):
                out[k][i] = p[k]
        return out

    def push_particles(self, instance, emissive=0.0):
        """Queue a live particle system (position, size, rotation, color,
        alive arrays) for the forward OIT pass."""
        self.particles.append(dict(instance=instance, emissive=emissive))

    def forward_arrays(self, max_quads, camera):
        """Camera-facing billboard quads of all queued particles: dict(
        positions (4Q, 3), uv (4Q, 2), color (4Q, 4), quad_count), the
        vertex stream of the weighted-blend OIT raster.  Built in numpy
        for any particle count (the JAX package's native helper, which it
        takes above 4096 quads of one system, computes the same quads)."""
        positions = np.zeros((max_quads * 4, 3), np.float32)
        uv = np.zeros((max_quads * 4, 2), np.float32)
        color = np.zeros((max_quads * 4, 4), np.float32)
        right = camera.right()
        up = camera.up()
        q = 0
        for entry in self.particles:
            inst = entry["instance"]
            alive = np.nonzero(inst.alive)[0]
            n = min(len(alive), max_quads - q)
            if n <= 0:
                continue
            idx = alive[:n]
            col = inst.color[idx]
            base = q * 4
            p = inst.position[idx]
            sz = inst.size[idx]
            rot = inst.rotation[idx]
            c, s = np.cos(rot)[:, None], np.sin(rot)[:, None]
            r = right[None, :] * c + up[None, :] * s
            u = up[None, :] * c - right[None, :] * s
            rx = r * sz[:, 0:1]
            uy = u * sz[:, 1:2]
            corners = np.stack(
                [p - rx - uy, p + rx - uy, p + rx + uy, p - rx + uy],
                axis=1)                                  # (n, 4, 3)
            positions[base:base + 4 * n] = corners.reshape(-1, 3)
            uv[base:base + 4 * n] = np.tile([[0, 0], [1, 0], [1, 1], [0, 1]],
                                            (n, 1)).astype(np.float32)
            color[base:base + 4 * n] = np.repeat(col, 4, axis=0)
            q += n
        return dict(positions=positions, uv=uv, color=color,
                    quad_count=np.int32(q))

    @staticmethod
    def quad_triangles(max_quads):
        """Static index pattern: quad i -> verts [4i..4i+3], 2 triangles."""
        base = np.arange(max_quads, dtype=np.int32)[:, None] * 4
        t = np.concatenate([base + np.array([[0, 1, 2]], np.int32),
                            base + np.array([[0, 2, 3]], np.int32)], axis=1)
        return t.reshape(-1, 3)

    # --- overlays ---------------------------------------------------------
    def push_sprite(self, rect, image_id, layer=0.0, tint=(1, 1, 1, 1),
                    rotation=0.0):
        """Overlay sprite quad: image_id from RenderContext.add_sprite,
        rect = (x, y, w, h) display px; layer picks a layer of a layered
        sprite; rotation spins the rect about its center (radians).
        Needs FrameConfig.max_overlay_sprites."""
        self.sprites.append(dict(rect=np.asarray(rect, np.float32),
                                 image=image_id, layer=layer,
                                 tint=np.asarray(tint, np.float32),
                                 rotation=float(rotation)))

    def push_text(self, text, pos, tint=(1, 1, 1, 1), scale=1):
        """Overlay text from the context's overlay font
        (RenderContext.set_overlay_font): one glyph quad a character, pos
        the glyph top (bitmap fonts) or the baseline (baked fonts)."""
        self.sprites.append(dict(text=str(text),
                                 pos=np.asarray(pos, np.float32),
                                 tint=np.asarray(tint, np.float32),
                                 scale=int(scale)))

    def sprite_arrays(self, overlay, max_sprites, region=128):
        """Flatten pushed sprites/text into the instance arrays of
        ops/sprite_pass.composite_sprites (at most max_sprites; the rest
        are dropped).

        overlay: RenderContext.overlay_info() — atlas uv rects per
        sprite id, layer count, and the overlay font's glyph table.
        Rects larger than the blend region split into region-sized
        chunks in sprite-local space (rotation-safe), so arbitrary HUD
        panels work with the fixed-region kernel.
        """
        prims = []      # (origin2, ax2, ay2, uv0, uv1, tint)
        for s in self.sprites:
            if "text" in s:
                f = overlay.get("font")
                if f is None:
                    continue
                sc = s["scale"]
                cx, cy = float(s["pos"][0]), float(s["pos"][1])
                idx = [f["glyph_index"](ch) for ch in s["text"]]
                ox, oy = f["origin"]
                for k, gi in enumerate(idx):
                    gx, gy = float(f["x"][gi]), float(f["y"][gi])
                    gw, gh = float(f["width"][gi]), float(f["height"][gi])
                    if gw > 0 and gh > 0:
                        org = np.array([cx + f["offsetx"][gi] * sc,
                                        cy + f["offsety"][gi] * sc],
                                       np.float32)
                        prims.append((org,
                                      np.array([gw * sc, 0], np.float32),
                                      np.array([0, gh * sc], np.float32),
                                      np.array([ox + gx, oy + gy], np.float32),
                                      np.array([ox + gx + gw, oy + gy + gh],
                                               np.float32),
                                      s["tint"]))
                    nxt = idx[k + 1] if k + 1 < len(idx) else 0
                    adv = (f["advance"][gi, nxt] if f["advance"].ndim > 1
                           else f["advance"][gi])
                    cx += float(adv) * sc
            else:
                sid = s["image"]
                if sid >= len(overlay["uv0"]):
                    continue
                u0 = np.array(overlay["uv0"][sid], np.float32)
                u1 = np.array(overlay["uv1"][sid], np.float32)
                layers = overlay["layers"][sid]
                if layers > 1:
                    lh = (u1[1] - u0[1]) / layers
                    li = int(s["layer"]) % layers
                    u0 = u0 + np.array([0, li * lh], np.float32)
                    u1 = np.array([u1[0], u0[1] + lh], np.float32)
                x, y, w_, h_ = [float(v) for v in s["rect"]]
                rot = s.get("rotation", 0.0)
                c, sn = np.cos(rot), np.sin(rot)
                ax = np.array([w_ * c, w_ * sn], np.float32)
                ay = np.array([-h_ * sn, h_ * c], np.float32)
                ctr = np.array([x + w_ * 0.5, y + h_ * 0.5], np.float32)
                org = ctr - 0.5 * ax - 0.5 * ay
                prims.append((org, ax, ay, u0, u1, s["tint"]))

        # split prims whose screen bbox exceeds the blend region into
        # local-space chunks (chunk axes stay a pure rescale of the
        # parent's, so uv mapping is exact)
        out = []
        for org, ax, ay, u0, u1, tint in prims:
            bw = abs(ax[0]) + abs(ay[0])
            bh = abs(ax[1]) + abs(ay[1])
            ku = max(int(np.ceil(bw / max(region - 1, 1))), 1)
            kv = max(int(np.ceil(bh / max(region - 1, 1))), 1)
            if ku * kv == 1:
                out.append((org, ax, ay, u0, u1, tint))
                continue
            du, dv = 1.0 / ku, 1.0 / kv
            for a in range(ku):
                for b in range(kv):
                    o2 = org + ax * (a * du) + ay * (b * dv)
                    out.append((o2, ax * du, ay * dv,
                                u0 + (u1 - u0) * np.array([a * du, b * dv],
                                                          np.float32),
                                u0 + (u1 - u0) * np.array([(a + 1) * du,
                                                           (b + 1) * dv],
                                                          np.float32),
                                tint))

        S = max_sprites
        origin = np.zeros((S, 2), np.float32)
        axis_x = np.zeros((S, 2), np.float32)
        axis_y = np.zeros((S, 2), np.float32)
        uv0 = np.zeros((S, 2), np.float32)
        uv1 = np.zeros((S, 2), np.float32)
        tint = np.zeros((S, 4), np.float32)
        n = min(len(out), S)
        for i, (o, axv, ayv, u0, u1, t) in enumerate(out[:n]):
            origin[i], axis_x[i], axis_y[i] = o, axv, ayv
            uv0[i], uv1[i], tint[i] = u0, u1, t
        return dict(origin=origin, axis_x=axis_x, axis_y=axis_y,
                    uv0=uv0, uv1=uv1, tint=tint, count=np.int32(n))

    def draw_arrays(self, max_draws, default_material, max_palettes=0,
                    max_bones=128):
        """Fixed-capacity draw arrays: morph_range (morphbeg, morphend) is
        (0, 0), off, except on terrain draws; wind, bendscale and
        detailbendscale are 0 except on foliage draws.  With
        max_palettes, also palettes (max_palettes, max_bones, 8) and
        palette_id (max_draws,): palette 0 is the identity, each actor
        takes the next one, and actors past max_palettes take palette 0."""
        mesh = np.zeros(max_draws, np.int32)
        world = np.zeros((max_draws, 3, 4), np.float32)
        world[:, :, :3] = np.eye(3)
        material = np.full(max_draws, default_material, np.int32)
        n = min(len(self.draws), max_draws)
        wind = np.zeros((max_draws, 4), np.float32)
        bendscale = np.zeros((max_draws, 3), np.float32)
        detailbendscale = np.zeros((max_draws, 3), np.float32)
        morph_range = np.zeros((max_draws, 2), np.float32)   # end <= 0: off
        out = dict(mesh=mesh, world=world, material=material, count=np.int32(n),
                   wind=wind, bendscale=bendscale,
                   detailbendscale=detailbendscale, morph_range=morph_range)
        if max_palettes:
            palettes = np.zeros((max_palettes, max_bones, 8), np.float32)
            palettes[:, :, 0] = 1.0      # identity dual-quats
            palette_id = np.zeros(max_draws, np.int32)
            next_pal = 1
        for i, d in enumerate(self.draws[:n]):
            mesh[i] = d["mesh"]
            world[i] = d["transform"]
            material[i] = d["material"]
            if "wind" in d:
                wind[i] = d["wind"]
                bendscale[i] = d["bendscale"]
                detailbendscale[i] = d["detailbendscale"]
            if "morph" in d:
                morph_range[i] = d["morph"]
            if max_palettes and d.get("palette") is not None and next_pal < max_palettes:
                p = d["palette"]
                palettes[next_pal, :len(p)] = p[:max_bones]
                palette_id[i] = next_pal
                next_pal += 1
        if max_palettes:
            out["palettes"] = palettes
            out["palette_id"] = palette_id
        return out


def _to_affine(transform):
    if isinstance(transform, Transform):
        return transform.matrix()[:3, :].astype(np.float32)
    m = np.asarray(transform, np.float32)
    if m.shape == (4, 4):
        return m[:3, :]
    return m.reshape(3, 4)


def _attenuation_range(att):
    """Range where the attenuated intensity falls to ~1/255."""
    q, l, c = float(att[0]), float(att[1]), float(att[2])
    if q > 1e-9:
        return (-l + np.sqrt(l * l - 4 * q * (c - 255.0))) / (2 * q)
    if l > 1e-9:
        return (255.0 - c) / l
    return 1e4
