"""Clustered light binning: per-tile light lists (counterpart of
datum_tpu/ops/cluster.py: tile_frustum_planes, tile_depth_bounds,
bin_lights, and the deferred path's tile-major light loop
clustered_point_lights).

A dense (tiles x lights) sphere-against-tile-frustum test, refined by
each tile's own depth interval, then a per-tile compaction into a
fixed-capacity list in ascending light id.  Plain PyTorch: the JAX
package has no Pallas kernel here.  K2 walks the lists of its 128-column
sub-tiles (ops/shade_cuda.py, `clusters=`).
"""

from __future__ import annotations

import torch

from . import brdf
from .common import TILE_H, TILE_W
from .raster import _untile, tile_image


def tile_frustum_planes(view, proj, tiles_x, tiles_y, width, height):
    """The 4 side planes of every tile's frustum in world space: (n_tiles,
    4, 4) [n | d], inside = n.p + d >= 0; tiles row-major."""
    dev = view.device
    tx = torch.arange(tiles_x, dtype=torch.float32, device=dev)
    ty = torch.arange(tiles_y, dtype=torch.float32, device=dev)
    x0 = (tx * TILE_W) / width * 2 - 1
    x1 = ((tx + 1) * TILE_W) / width * 2 - 1
    y0 = (ty * TILE_H) / height * 2 - 1
    y1 = ((ty + 1) * TILE_H) / height * 2 - 1
    inv00 = 1.0 / proj[0, 0]
    inv11 = 1.0 / proj[1, 1]

    def corners(xa, yb):
        # view-space rays through the tile corners, on the z = -1 plane
        return torch.stack([inv00 * xa, inv11 * yb, -torch.ones_like(xa)],
                           -1).reshape(-1, 3)

    X0, Y0 = torch.meshgrid(x0, y0, indexing="xy")      # (tiles_y, tiles_x)
    X1, Y1 = torch.meshgrid(x1, y1, indexing="xy")
    c00, c10 = corners(X0, Y0), corners(X1, Y0)
    c01, c11 = corners(X0, Y1), corners(X1, Y1)

    def plane(a, b):
        # side plane through the camera, inward normal = edge cross product
        n = torch.linalg.cross(a, b)
        return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)

    planes_v = torch.stack([plane(c01, c00), plane(c10, c11), plane(c00, c10),
                            plane(c11, c01)], dim=1)            # (T, 4, 3)
    R = view[:3, :3]
    n_w = planes_v @ R                                          # R^T n, per plane
    campos = -R.T @ view[:3, 3]
    d = -torch.einsum("tpk,k->tp", n_w, campos)
    return torch.cat([n_w, d[..., None]], -1)


def tile_depth_bounds(depth, proj):
    """Per-tile (zmin, zmax) view distance of the reverse-Z depth plane
    (H, W), each (n_tiles,); uncovered pixels count as 1e7 (far)."""
    denom = depth + proj[2, 2]
    dist = proj[2, 3] / torch.where(torch.abs(denom) < 1e-7,
                                    torch.full_like(denom, 1e-7), denom)
    dist = torch.clamp(dist, 0.0, 1e7)
    H, W = depth.shape
    t = dist.reshape(H // TILE_H, TILE_H, W // TILE_W, TILE_W)
    return t.amin(dim=(1, 3)).reshape(-1), t.amax(dim=(1, 3)).reshape(-1)


def bin_lights(light_pos, light_range, count, view, proj, tiles_x, tiles_y,
               width, height, capacity, tile_zrange=None, tile0=0, n_local=None):
    """Per-tile light lists: (lists (n_tiles, capacity) int32 light ids in
    ascending order, -1 padded; counts (n_tiles,) int32, at most
    capacity).  A light is in a tile's list when its sphere (light_range)
    reaches inside all 4 side planes and, with tile_zrange = (zmin, zmax)
    from tile_depth_bounds, overlaps the tile's depth interval; only the
    first `count` lights take part.  tile0 / n_local: only the tiles
    tile0 .. tile0 + n_local - 1 of the frame's grid (a band of the
    tile-sharded frame; tile_zrange is the band's then)."""
    planes = tile_frustum_planes(view, proj, tiles_x, tiles_y, width, height)
    if n_local is not None:
        planes = planes[tile0:tile0 + n_local]
    L = light_pos.shape[0]
    hp = torch.cat([light_pos, torch.ones((L, 1), dtype=light_pos.dtype,
                                          device=light_pos.device)], -1)
    dist = torch.einsum("tpc,lc->tpl", planes, hp)              # (T, 4, L)
    hit = torch.all(dist >= -light_range[None, None, :], dim=1)
    active = torch.arange(L, device=light_pos.device) < count
    hit = hit & active[None, :]
    if tile_zrange is not None:
        zmin, zmax = tile_zrange
        dl = -(light_pos @ view[2, :3] + view[2, 3])            # along -view z
        hit = (hit & (dl[None, :] + light_range[None, :] >= zmin[:, None])
               & (dl[None, :] - light_range[None, :] <= zmax[:, None]))
    # hits first, each group in ascending id (a stable sort of the misses)
    order = torch.argsort((~hit).to(torch.uint8), dim=1, stable=True)[:, :capacity]
    lists = torch.where(torch.gather(hit, 1, order), order, torch.full_like(order, -1))
    counts = torch.clamp(hit.sum(1), max=capacity)
    return lists.to(torch.int32), counts.to(torch.int32)


def clustered_point_lights(worldpos, normal, eyevec, material, pl, lists, tiles_x,
                           tiles_y):
    """The point lights of the deferred (XLA) lighting, tile-major: each
    tile walks its own list (bin_lights), one list slot a step over all
    tiles at once.  worldpos, normal, eyevec (H, W, 3) and material's
    specular (H, W, 3) and alpha (H, W); pl: the sceneset's point
    lights.  Returns (diffuse, specular) (H, W, 3)."""
    wp = tile_image(worldpos, tiles_x, tiles_y)
    nr = tile_image(normal, tiles_x, tiles_y)
    ey = tile_image(eyevec, tiles_x, tiles_y)
    mat_t = dict(specular=tile_image(material["specular"], tiles_x, tiles_y),
                 alpha=tile_image(material["alpha"], tiles_x, tiles_y))
    dif = torch.zeros_like(wp)
    spec = torch.zeros_like(wp)
    for k in range(lists.shape[1]):
        lid = lists[:, k]
        li = torch.clamp(lid, min=0).long()
        d, s = brdf.point_light(wp, nr, ey, mat_t, pl["position"][li][:, None, None, :],
                                pl["intensity"][li][:, None, None, :],
                                pl["attenuation"][li][:, None, None, :])
        w = (lid >= 0).to(torch.float32)[:, None, None, None]
        dif = dif + d * w
        spec = spec + s * w
    return _untile(dif, tiles_x, tiles_y), _untile(spec, tiles_x, tiles_y)
