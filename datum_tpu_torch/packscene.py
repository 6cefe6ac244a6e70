"""Packs written from a seed, and the scene built from them (port-only;
the reference engine's packs are not needed).

- rigged_column(): scenes.VertexModes' skinned column as pack assets:
  its mesh, rig and bone table, and three looping clips (a sway about z,
  a bow about x and a twist about y) as ANIM payloads.
- lathe_obj(seed): OBJ text of a seeded lathe surface (v/vt/vn records,
  quads, some faces with negative indices).
- scene_assets(seed): the bench scene's opaque content (scenes.
  datumtest_scene: the sphere grid and the floor) as one MODL with its
  meshes, materials and instance transforms; the materials of
  `mapped` carry procedural albedo (BC3), normal (BC3) and surface (RGBA)
  maps of map_size^2 with full mip chains, and the floor an RGBE albedo.
  write_scene_pack writes them, the rigged column and its clips at the
  ids the character example reads (mesh 1, clips 2-4), and a catalog.
- pack_scene(...): the bench scene rebuilt from such a pack (Model.load
  into a Scene, the column as an animated actor) or, with assets=, from
  the same data in memory through ctx.add_*: the two give equal state
  and equal frames.
"""

from __future__ import annotations

import numpy as np

from .asset.pack import (BONE_DTYPE, IMAGE_RGBA, IMAGE_RGBA_BC3, IMAGE_RGBE, RIG_DTYPE,
                         VERTEX_DTYPE, PackWriter)
from .debug.debug import traced
from .math import Transform
from .math import color as color_codec
from .render import primitives
from .render.texturepool import _mip_chain as _mips     # box-filtered, pow2 to 1x1
from .scenes import VertexModes, _chain_rig, _ParticleCloud, _sway, bench_colorlut

# the model's texture kinds (the MODL texture table's `type`)
TEX_ALBEDO, TEX_SURFACE, TEX_NORMAL = 0, 1, 2
# pack ids: the character example reads mesh 1 and clips 2-4
ID_CATALOG, ID_COLUMN, ID_CLIPS, ID_MODEL, ID_MESHES = 0, 1, (2, 3, 4), 5, 6
CLIPS = (("sway", (0, 0, 1.0), 0.35, 2.0), ("bow", (1.0, 0, 0), 0.3, 1.5),
         ("twist", (0, 1.0, 0), 0.5, 1.0))


def vertex_array(verts):
    """primitives' dict of arrays -> a VERTEX_DTYPE array."""
    v = np.zeros(len(verts["position"]), VERTEX_DTYPE)
    for k in VERTEX_DTYPE.names:
        v[k] = verts[k]
    return v


def rigged_column():
    """The skinned column: dict(vertices, indices, rig, bones, mincorner,
    maxcorner, clips), clips a list of PackWriter.write_animation
    keyword dicts."""
    sv, si = primitives.unit_sphere(24, 12)
    pos = sv["position"] * np.float32([0.9, 3.0, 0.9])
    verts = vertex_array(dict(sv, position=pos))
    chain = _chain_rig(pos, VertexModes.PIVOTS)
    rig = np.zeros(len(pos), RIG_DTYPE)
    rig["bone"], rig["weight"] = chain["bone"], chain["weight"]
    bones = np.zeros(len(VertexModes.JOINTS), BONE_DTYPE)
    for i, (name, _) in enumerate(VertexModes.JOINTS):
        bones[i] = (name.encode(), Transform.translation(
            [0.0, -VertexModes.PIVOTS[i], 0.0]).flat())
    clips = []
    for _, axis, amplitude, duration in CLIPS:
        a = _sway(VertexModes.JOINTS, VertexModes.PIVOTS, list(axis), amplitude, duration)
        clips.append(dict(duration=a.duration, joints=a.joints, times=a.times,
                          transforms=a.transforms))
    return dict(vertices=verts, indices=np.asarray(si, np.uint32), rig=rig, bones=bones,
                mincorner=pos.min(0), maxcorner=pos.max(0), clips=clips)


def write_character(writer, column=None, compress=True):
    """The rigged column at ID_COLUMN and its clips at ID_CLIPS."""
    c = column or rigged_column()
    writer.write_mesh(ID_COLUMN, c["vertices"], c["indices"], c["mincorner"],
                      c["maxcorner"], rig=c["rig"], bones=c["bones"], compress=compress)
    for aid, clip in zip(ID_CLIPS, c["clips"]):
        writer.write_animation(aid, **clip)
    return c


def lathe_obj(seed=0, segments=64, rings=40):
    """OBJ text of a lathe surface: a vase-like profile r(y) with seeded
    ripples, (segments + 1) x (rings + 1) positions with texcoords and
    normals, one quad a cell (every third row written with negative
    indices)."""
    rng = np.random.RandomState(seed)
    amp = rng.uniform(0.02, 0.08, 3)
    freq = rng.uniform(2.0, 6.0, 3)
    ph = rng.uniform(0, 2 * np.pi, 3)
    y = np.linspace(0.0, 2.0, rings + 1)
    r = 0.5 + 0.35 * np.sin(np.pi * y / 2.0) + sum(
        a * np.sin(f * y + p) for a, f, p in zip(amp, freq, ph))
    dr = 0.35 * np.pi / 2.0 * np.cos(np.pi * y / 2.0) + sum(
        a * f * np.cos(f * y + p) for a, f, p in zip(amp, freq, ph))
    phi = np.linspace(0.0, 2 * np.pi, segments + 1)
    lines = [f"# lathe surface, seed {seed}"]
    for j in range(rings + 1):
        for i in range(segments + 1):
            c, s = np.cos(phi[i]), np.sin(phi[i])
            lines.append(f"v {r[j] * c:.6f} {y[j]:.6f} {r[j] * s:.6f}")
    for j in range(rings + 1):
        for i in range(segments + 1):
            lines.append(f"vt {i / segments:.6f} {j / rings:.6f}")
    for j in range(rings + 1):
        for i in range(segments + 1):
            n = np.array([np.cos(phi[i]), -dr[j], np.sin(phi[i])])
            n /= np.linalg.norm(n)
            lines.append(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}")
    count = (rings + 1) * (segments + 1)
    for j in range(rings):
        for i in range(segments):
            a = j * (segments + 1) + i + 1
            quad = (a, a + segments + 1, a + segments + 2, a + 1)   # CCW outside
            if j % 3 == 2:
                quad = tuple(q - count - 1 for q in quad)
            lines.append("f " + " ".join(f"{q}/{q}/{q}" for q in quad))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the bench scene as a pack
# ---------------------------------------------------------------------------

def _bc3_payload(img):
    """BC3 blocks of every mip level (levels under 4x4 edge-padded)."""
    from .tools.bc import encode_bc3

    out = []
    for m in _mips(img):
        if m.shape[0] < 4:
            m = np.pad(m, ((0, 4 - m.shape[0]), (0, 4 - m.shape[1]), (0, 0)), mode="edge")
        out.append(encode_bc3(m))
    return np.concatenate(out).tobytes()


def _rgba_u32(img):
    """(S, S, 4) u8 RGBA -> (S, S) u32 of the pack's B, G, R, A bytes."""
    c = img.astype(np.uint32)
    return c[..., 2] | (c[..., 1] << 8) | (c[..., 0] << 16) | (c[..., 3] << 24)


def _maps(rng, size):
    """Seeded procedural (albedo, normal, surface) u8 RGBA images."""
    g = (np.arange(size, dtype=np.float32) + 0.5) / size
    x, y = np.meshgrid(g, g, indexing="xy")
    f = rng.uniform(2.0, 9.0, 4).astype(np.float32)
    p = rng.uniform(0, 2 * np.pi, 4).astype(np.float32)
    hue = rng.uniform(0.2, 0.9, 3).astype(np.float32)
    wave = 0.5 + 0.5 * np.sin(2 * np.pi * f[0] * x + p[0]) * np.cos(2 * np.pi * f[1] * y + p[1])
    noise = rng.randint(0, 8, (size, size)).astype(np.float32) / 255.0
    alb = np.clip(hue * (0.35 + 0.65 * wave)[..., None] + noise[..., None], 0, 1)
    h = (np.sin(2 * np.pi * f[2] * x + p[2]) + np.sin(2 * np.pi * f[3] * y + p[3])) * 0.5
    gx = np.roll(h, -1, 1) - np.roll(h, 1, 1)
    gy = np.roll(h, -1, 0) - np.roll(h, 1, 0)
    n = np.stack([-gx * 8.0, -gy * 8.0, np.ones_like(h)], -1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True) * 0.5 + 0.5
    surf = np.stack([0.3 + 0.6 * wave, 0.5 * (1 - wave), 0.8 + 0.2 * x, np.ones_like(x)], -1)
    to_u8 = lambda a: np.clip(a * 255 + 0.5, 0, 255).astype(np.uint8)
    one = np.ones((size, size, 1), np.float32)
    return (to_u8(np.concatenate([alb, one], -1)), to_u8(np.concatenate([n, one], -1)),
            to_u8(surf))


def scene_assets(seed=0, sphere_detail=24, grid=(7, 5), map_size=1024, mapped=(0, 12, 24, 34)):
    """The MODL content of the bench scene: dict(meshes [(vertices,
    indices)], textures [dict(type, format, size, payload, image)],
    materials [PackWriter material dicts], instances [dict(mesh,
    material, transform, childcount)]), with `image` each texture as
    Model.load decodes it (u8 RGBA of the top mip)."""
    from .tools.bc import decode_bc3

    rng = np.random.RandomState(seed)
    sv, si = primitives.unit_sphere(sphere_detail, sphere_detail // 2)
    pv, pi = primitives.plane(16.0, 8.0)
    meshes = [(vertex_array(sv), np.asarray(si, np.uint32)),
              (vertex_array(pv), np.asarray(pi, np.uint32))]
    levels = int(map_size).bit_length()
    nb = (map_size // 4) ** 2 * 16
    textures = []

    def add(kind, fmt, payload, image):
        textures.append(dict(type=kind, format=fmt, size=map_size, levels=levels,
                             payload=payload, image=image))
        return len(textures)                      # 1-based reference

    # the floor's albedo: an HDR checker (RGBE; clipped to u8 on load)
    ii, jj = np.indices((map_size, map_size))
    chk = (((ii * 8 // map_size) + (jj * 8 // map_size)) % 2).astype(np.float32)
    hdr = (0.35 + 0.9 * chk)[..., None] * np.float32([1.0, 0.97, 0.9])
    base = np.clip(hdr * 160, 0, 255).astype(np.uint8)     # box-filtered in u8
    codes = [color_codec.pack_rgbe(m.astype(np.float32) / 160) for m in _mips(base)]
    img = np.clip(color_codec.unpack_rgbe(codes[0]) * 255, 0, 255).astype(np.uint8)
    floor_alb = add(TEX_ALBEDO, IMAGE_RGBE,
                    b"".join(c.astype(np.uint32).tobytes() for c in codes),
                    np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1))
    maps = {}
    for k in mapped:
        alb, nrm, surf = _maps(rng, map_size)
        a_pay, n_pay = _bc3_payload(alb), _bc3_payload(nrm)
        maps[k] = dict(
            albedomap=add(TEX_ALBEDO, IMAGE_RGBA_BC3, a_pay,
                          decode_bc3(np.frombuffer(a_pay, np.uint8)[:nb], map_size, map_size)),
            normalmap=add(TEX_NORMAL, IMAGE_RGBA_BC3, n_pay,
                          decode_bc3(np.frombuffer(n_pay, np.uint8)[:nb], map_size, map_size)),
            surfacemap=add(TEX_SURFACE, IMAGE_RGBA, b"".join(
                _rgba_u32(m).tobytes() for m in _mips(surf)), surf))

    def material(color, metalness, roughness, **kw):
        m = dict(color=np.float32(color), metalness=metalness, roughness=roughness,
                 reflectivity=0.5, emissive=0.0, albedomap=0, surfacemap=0, normalmap=0)
        m.update(kw)
        return m

    materials = [material((1, 1, 1, 1), 0.0, 0.8, albedomap=floor_alb)]
    instances = [dict(mesh=1, material=0, transform=Transform.identity().flat(),
                      childcount=0)]
    gx, gy = grid
    for j in range(gy):
        for i in range(gx):
            k = j * gx + i
            materials.append(material((0.8, 0.16, 0.12, 1), j / (gy - 1),
                                      max(i / (gx - 1), 0.04), **maps.get(k, {})))
            instances.append(dict(mesh=0, material=k + 1, childcount=0,
                                  transform=Transform.translation(
                                      [(i - (gx - 1) / 2) * 2.2, 1.0 + j * 2.2, 0.0]).flat()))
    return dict(meshes=meshes, textures=textures, materials=materials, instances=instances)


def write_scene_pack(path, assets, column=None, compress=True):
    """Write the catalog, the rigged column and its clips, the MODL, its
    meshes (ID_MESHES, ...) and its textures (after them) to path.
    Returns the pack's bytes."""
    w = PackWriter()
    n_mesh = len(assets["meshes"])
    tex_ids = [ID_MESHES + n_mesh + t for t in range(len(assets["textures"]))]
    names = {ID_COLUMN: "actor/column", ID_MODEL: "model/bench"}
    names.update({aid: f"actor/{c[0]}" for aid, c in zip(ID_CLIPS, CLIPS)})
    names.update({ID_MESHES + i: f"model/mesh{i}" for i in range(n_mesh)})
    names.update({aid: f"model/texture{i}" for i, aid in enumerate(tex_ids)})
    w.write_catalog(ID_CATALOG, 0x6E656353, 1, dict(sorted(names.items())))
    write_character(w, column, compress)
    w.write_model(ID_MODEL, [dict(type=t["type"], texture=aid)
                             for t, aid in zip(assets["textures"], tex_ids)],
                  assets["materials"], [ID_MESHES + i for i in range(n_mesh)],
                  assets["instances"])
    for i, (v, idx) in enumerate(assets["meshes"]):
        w.write_mesh(ID_MESHES + i, v, idx, v["position"].min(0), v["position"].max(0),
                     compress=compress)
    for t, aid in zip(assets["textures"], tex_ids):
        w.write_image(aid, t["size"], t["size"], 1, t["levels"], t["format"], t["payload"],
                      compress=compress)
    data = w.finish()
    with open(path, "wb") as f:
        f.write(data)
    return data


def pack_scene(width, height, pack=None, assets=None, column=None, skybox=None,
               device="cuda", **cfg_kw):
    """The bench scene with its opaque content from a pack (pack: a
    PackReader of write_scene_pack's layout; Model.load, the column from
    its mesh, bones and clips) or, with assets= and column=, from the same
    data in memory (ctx.add_* in Model.load's order; Animation objects).
    The column is an ActorComponent whose Animator plays the sway (0.6)
    and the bow (0.4, rate 1.3); the grading LUT, the camera, the lights,
    the spot and the forward content (glass sphere, water, decals,
    particles) are datumtest_scene's.  skybox: a SkyBox to attach
    (shared by the scenes compared).  Returns (ctx, camera, params,
    make_renderlist, scene, model); make_renderlist(t, dt) culls through
    the ECS and advances the actor's Animator by dt."""
    from .ops.common import FrameConfig
    from .render.animation import Animation, Animator
    from .render.camera import Camera
    from .render.context import RenderContext
    from .render.renderlist import RenderList
    from .render.types import RenderParams
    from .scene import (ActorComponent, MeshComponent, Model, Scene, TransformComponent,
                        update_actors, update_meshes)

    cfg_kw.setdefault("enable_skinning", True)
    cfg = FrameConfig(width=width, height=height, **cfg_kw)
    ctx = RenderContext(cfg, device=device)
    if skybox is not None:
        ctx.set_skybox(skybox)
    ctx.set_colorlut(bench_colorlut())
    scene = Scene()
    if pack is not None:
        model = Model.load(scene, ctx, pack, ID_MODEL)
        col = pack.mesh(ID_COLUMN)
        anims = [Animation.from_asset(pack.animation(a)) for a in ID_CLIPS]
        bones = col["bones"]
    else:
        tex = [ctx.add_texture(t["image"]) for t in assets["textures"]]
        mats = []
        for m in assets["materials"]:
            kw = {k: tex[m[k] - 1] for k in ("albedomap", "surfacemap", "normalmap") if m[k]}
            mats.append(ctx.add_material(
                color=tuple(m["color"]), metalness=m["metalness"], roughness=m["roughness"],
                reflectivity=m["reflectivity"], emissive=m["emissive"], **kw))
        handles = [ctx.add_mesh(v, i, mincorner=v["position"].min(0),
                                maxcorner=v["position"].max(0)) for v, i in assets["meshes"]]
        root = scene.create_entity()
        root_tc = scene.add_component(root, TransformComponent, Transform.identity())
        for inst in assets["instances"]:
            e = scene.create_entity()
            scene.add_component(e, TransformComponent, Transform.from_flat(inst["transform"]),
                                parent=root_tc)
            scene.add_component(e, MeshComponent, mesh=handles[inst["mesh"]],
                                material=mats[inst["material"]])
        model = Model(root, [], handles, mats, dict(enumerate(tex)))
        col = column
        anims = [Animation(**c) for c in column["clips"]]
        bones = [(n.decode(), t) for n, t in zip(column["bones"]["name"],
                                                 column["bones"]["transform"])]
    actor_mesh = ctx.add_mesh(col["vertices"], col["indices"], mincorner=col["mincorner"],
                              maxcorner=col["maxcorner"], rig=col["rig"])
    actor_mat = ctx.add_material(color=(0.85, 0.3, 0.2, 1), roughness=0.5)
    animator = Animator(bones)
    animator.play(anims[0], weight=0.6)
    animator.play(anims[1], weight=0.4, rate=1.3)
    actor = scene.create_entity()
    scene.add_component(actor, TransformComponent, Transform.translation([10.5, 3.0, -6.0]))
    scene.add_component(actor, ActorComponent, mesh=actor_mesh, material=actor_mat,
                        animator=animator)

    sphere = model.meshes[0]
    glass_mat = ctx.add_material(color=(0.35, 0.55, 2.0, 0.42), metalness=0.0,
                                 roughness=0.12, reflectivity=0.9)
    water_mat = ctx.add_material(color=(0.12, 0.3, 0.42, 0.10), metalness=0.0,
                                 roughness=0.06, reflectivity=0.9, absorb=0.55)
    wverts, widx = primitives.plane(3.2, 1.0)
    water_patch = ctx.add_mesh(wverts, widx)

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
    light_pos = rng.uniform([-8, 0.5, -6], [8, 4.0, 6], (8, 3))
    light_col = rng.uniform(0.5, 8.0, (8, 3))
    part_base = rng.uniform([-6, 0.5, -3], [6, 5.0, 3], (256, 3)).astype(np.float32)
    part_phase = rng.uniform(0, 2 * np.pi, 256).astype(np.float32)

    @traced("build.renderlist")
    def make_renderlist(t=0.0, dt=0.0):
        rl = RenderList()
        update_meshes(scene, camera, rl)
        update_actors(scene, camera, dt, rl)
        for li in range(len(light_pos)):
            p = light_pos[li].copy()
            p[0] += np.sin(t + li) * 1.5
            rl.push_pointlight(p, light_col[li], (1.0, 0.0, 1.0), range_=12.0)
        rl.push_spotlight(np.float32([4.0, 8.0, 6.0]), np.float32([-0.35, -0.75, -0.55]),
                          np.float32([20.0, 19.0, 17.0]), cutoff=0.6,
                          attenuation=(0.5, 0.0, 1.0), range_=30.0)
        if cfg.max_translucent_draws > 0:
            rl.push_translucent(sphere, Transform.translation([4.2, 1.1, 5.0]), glass_mat)
            rl.push_translucent(water_patch, Transform.translation([-4.5, 0.35, 5.0]),
                                water_mat)
        if cfg.max_decals_active > 0:
            rl.push_decal(Transform.translation([-1.5, 0.0, 6.0]), [1.4, 0.8, 1.4],
                          color=(0.75, 0.1, 0.05, 0.85), roughness=0.35)
            rl.push_decal(Transform.translation([1.8, 0.0, 7.0]), [1.0, 0.8, 1.0],
                          color=(0.05, 0.05, 0.06, 0.9), roughness=0.9)
        if cfg.max_particle_quads > 0:
            pos = part_base + np.stack(
                [np.sin(t * 0.7 + part_phase) * 0.8,
                 np.cos(t * 0.4 + part_phase) * 0.4 + 0.2,
                 np.cos(t * 0.6 + part_phase) * 0.8], -1).astype(np.float32)
            rl.push_particles(_ParticleCloud(pos), emissive=0.4)
        return rl

    make_renderlist.animator = animator
    return ctx, camera, params, make_renderlist, scene, model
