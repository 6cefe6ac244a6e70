"""Per-frame scene systems (counterpart of datum_tpu/scene/systems.py).
update_meshes, update_actors and update_particlesystems frustum-cull
against the camera (and update_meshes optionally against the software
occlusion buffer) before doing work, and push what is visible into the
render list; gather_lights pushes the light components."""

from __future__ import annotations

import numpy as np

from ..math.bound import bound_expand
from .components import (
    ActorComponent, MeshComponent, ParticleSystemComponent, PointLightComponent,
    SpotLightComponent, TransformComponent,
)

# MeshComponent.flags bit: this mesh is a software occluder — it is
# rasterized into the OcclusionBuffer by fill_occlusion and hides
# meshes fully behind it (reference: OcclusionBuffer::fill_elements
# consumers fill with large static geometry, occlusion.h:33)
MESH_FLAG_OCCLUDER = 1


def fill_occlusion(scene, camera, geometry, buffer):
    """Rasterize occluder-flagged meshes into the software occlusion
    buffer (host-side, conservative).  geometry is the RenderContext's
    GeometryPool (host mirror)."""
    buffer.clear()
    viewproj = np.asarray(camera.viewproj(), np.float32)
    for comp in scene.storage(MeshComponent).rows():
        if not (comp.flags & MESH_FLAG_OCCLUDER) or comp.mesh is None:
            continue
        tc = scene.get_component(comp.entity, TransformComponent)
        m = comp.mesh
        v0 = int(geometry.mesh_vtx_offset[m.mesh_id])
        nv = int(geometry.mesh_vtx_count[m.mesh_id])
        t0 = int(geometry.mesh_tri_offset[m.mesh_id])
        nt = int(geometry.mesh_tri_count[m.mesh_id])
        pos = geometry.positions[v0:v0 + nv]
        tris = geometry.triangles[t0:t0 + nt] - v0
        buffer.fill_elements(viewproj @ np.asarray(tc.world.matrix(),
                                                   np.float32), pos, tris)
    return buffer


def update_meshes(scene, camera, renderlist=None, occlusion=None):
    """Refresh world bounds, frustum-cull (+ optional software
    occlusion-cull), push visible meshes.

    occlusion: an OcclusionBuffer already filled via fill_occlusion;
    meshes whose screen rect lies fully behind the occluder depth are
    skipped (reference: renderer/occlusion.h:49 visible())."""
    storage = scene.storage(MeshComponent)
    frustum = camera.frustum()
    viewproj = (np.asarray(camera.viewproj(), np.float32)
                if occlusion is not None else None)
    visible = []
    for comp in storage.rows():
        if comp.mesh is None:       # placeholder component (same guard
            continue                # as fill_occlusion)
        tc = scene.get_component(comp.entity, TransformComponent)
        world = tc.world
        comp.world_bound = comp.mesh.bound().transformed(world)
        if not frustum.intersects_bound(comp.world_bound):
            continue
        if (occlusion is not None
                and not (comp.flags & MESH_FLAG_OCCLUDER)
                and not occlusion.visible(comp.world_bound.min,
                                          comp.world_bound.max, viewproj)):
            continue
        visible.append(comp)
        if renderlist is not None:
            renderlist.push_mesh(comp.mesh, world, comp.material)
    return visible


def update_actors(scene, camera, dt, renderlist=None):
    """Advance animators for visible actors, push skinned draws."""
    storage = scene.storage(ActorComponent)
    frustum = camera.frustum()
    visible = []
    for comp in storage.rows():
        if comp.mesh is None:
            continue
        tc = scene.get_component(comp.entity, TransformComponent)
        world = tc.world
        comp.world_bound = comp.mesh.bound().transformed(world)
        # conservative: animated bounds inflate by 25% of the radius
        bound = bound_expand(comp.world_bound, 0.25 * comp.world_bound.radius)
        if frustum.intersects_bound(bound):
            if comp.animator is not None:
                comp.animator.update(dt)
            visible.append(comp)
            if renderlist is not None and hasattr(renderlist, "push_actor"):
                if comp.animator is not None:
                    renderlist.push_actor(comp.mesh, world, comp.material,
                                          comp.animator.palette())
                else:           # no animator: draw as a static mesh
                    renderlist.push_mesh(comp.mesh, world, comp.material)
    return visible


def update_particlesystems(scene, camera, dt, renderlist=None):
    """Create each component's instance on first use, then step the
    systems whose bound (under the entity's world transform) meets the
    frustum and push their instances; returns the visible components."""
    storage = scene.storage(ParticleSystemComponent)
    frustum = camera.frustum()
    visible = []
    for comp in storage.rows():
        tc = scene.get_component(comp.entity, TransformComponent)
        if comp.instance is None and comp.system is not None:
            comp.instance = comp.system.create()
        if comp.instance is None:
            continue
        bound = comp.system.bound.transformed(tc.world)
        if frustum.intersects_bound(bound):
            comp.system.update(comp.instance, dt, tc.world, camera)
            visible.append(comp)
            if renderlist is not None and hasattr(renderlist, "push_particles"):
                renderlist.push_particles(comp.instance)
    return visible


def gather_lights(scene, renderlist):
    """Push light components into the renderlist."""
    for comp in scene.storage(PointLightComponent).rows():
        tc = scene.get_component(comp.entity, TransformComponent)
        renderlist.push_pointlight(tc.world.translation_vec(), comp.intensity,
                                   comp.attenuation)
    for comp in scene.storage(SpotLightComponent).rows():
        tc = scene.get_component(comp.entity, TransformComponent)
        direction = tc.world.transform_point(np.array([0, 0, -1.0], np.float32)) \
            - tc.world.translation_vec()
        renderlist.push_spotlight(tc.world.translation_vec(), direction,
                                  comp.intensity, comp.cutoff, comp.attenuation)
