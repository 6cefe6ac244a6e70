"""Model: a compound entity from a pack's MODL asset (counterpart of
datum_tpu/scene/model.py).

Loading a model adds its textures, materials and meshes to the render
context and spawns one child mesh entity per instance record, each
parented flat to the model's root entity (as the reference does; the
wire format's childcount is not read).  Textures are decoded by format:
RGBE is clipped to u8 with alpha 255, BC3 goes through tools/bc.py, and
RGBA is swizzled from the pack's B, G, R, A bytes.  A material's map
references are 1-based into the model's texture table; 0 means none.
"""

from __future__ import annotations

import numpy as np

from ..math import Transform
from .components import MeshComponent, NameComponent, TransformComponent


class Model:
    def __init__(self, entity, entities, meshes, materials, textures):
        self.entity = entity
        self.entities = entities       # child mesh entities
        self.meshes = meshes
        self.materials = materials
        self.textures = textures

    @classmethod
    def load(cls, scene, ctx, pack, model_asset_id, transform=None):
        """Instantiate a MODL asset into the scene.

        scene: scene.Scene; ctx: render.RenderContext; pack: PackReader
        holding the model and its referenced mesh/texture assets (ids in
        the model payload are pack-local asset ids).
        """
        decoded = pack.model(model_asset_id)

        from ..asset.pack import IMAGE_RGBA_BC3, IMAGE_RGBE
        from ..math import color as color_codec
        from ..tools.bc import decode_bc3

        # textures
        tex_map = {}
        for i, t in enumerate(decoded["textures"]):
            if t["texture"] == 0:
                tex_map[i] = None
                continue
            img = pack.image(t["texture"])
            w, h = img["width"], img["height"]
            if img["format"] == IMAGE_RGBA_BC3:
                # layer 0 of the top mip: the first ceil(w/4)*ceil(h/4)
                # 16-byte blocks of the flat block array (the JAX Model.load
                # takes mips[0][0], one byte, and fails here)
                nblocks = ((w + 3) // 4) * ((h + 3) // 4)
                rgba = decode_bc3(img["mips"][0][:nblocks * 16], w, h)
            elif img["format"] == IMAGE_RGBE:
                base = img["mips"][0][0]     # layer 0, top mip
                rgba = np.clip(color_codec.unpack_rgbe(base) * 255, 0, 255).astype(np.uint8)
                rgba = np.concatenate([rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)], -1)
            else:
                base = img["mips"][0][0]
                rgba = base.view(np.uint8).reshape(base.shape + (4,))
                # the pack stores B, G, R, A bytes
                rgba = rgba[..., [2, 1, 0, 3]]
            tex_map[i] = ctx.add_texture(rgba)

        # materials
        mat_ids = []
        for m in decoded["materials"]:
            kw = dict(color=tuple(m["color"]), metalness=m["metalness"],
                      roughness=m["roughness"], reflectivity=m["reflectivity"],
                      emissive=m["emissive"])
            if m["albedomap"] and tex_map.get(m["albedomap"] - 1) is not None:
                kw["albedomap"] = tex_map[m["albedomap"] - 1]
            if m["surfacemap"] and tex_map.get(m["surfacemap"] - 1) is not None:
                kw["surfacemap"] = tex_map[m["surfacemap"] - 1]
            if m["normalmap"] and tex_map.get(m["normalmap"] - 1) is not None:
                kw["normalmap"] = tex_map[m["normalmap"] - 1]
            mat_ids.append(ctx.add_material(**kw))

        # meshes
        mesh_handles = []
        for mid in decoded["meshes"]:
            md = pack.mesh(mid)
            mesh_handles.append(ctx.add_mesh(md["vertices"], md["indices"],
                                             mincorner=md["mincorner"],
                                             maxcorner=md["maxcorner"]))

        # entities
        root = scene.create_entity()
        root_tc = scene.add_component(root, TransformComponent,
                                      transform or Transform.identity())
        scene.add_component(root, NameComponent, f"model:{model_asset_id}")
        children = []
        # flat parenting: every instance under the model root (the wire
        # format's childcount is not read)
        for inst in decoded["instances"]:
            e = scene.create_entity()
            local = Transform.from_flat(inst["transform"])
            scene.add_component(e, TransformComponent, local, parent=root_tc)
            scene.add_component(e, MeshComponent,
                                mesh=mesh_handles[inst["mesh"]],
                                material=mat_ids[inst["material"]])
            children.append(e)
        return cls(root, children, mesh_handles, mat_ids, tex_map)
