"""Clustered lights against the JAX package (CPU): ops/cluster.py, K2's
clustered loop (plain version) and the early-z suffix bounds.

- tile_frustum_planes within atol 1e-6; tile_depth_bounds, and
  bin_lights' lists and counts, exactly (depth-bound culling, capacity
  truncation, count below the table's rows, an off-screen light);
- the early-z bounds above every fragment of their slots;
- K2's plain version with clusters against shade_deferred_pallas(
  clusters=..., interpret=True) at W = 256 (2 sub-tiles), 32 lights,
  capacity 8: the limits of tests/test_torch_shade.py (99.98% of values
  within atol 2e-5 / rtol 1e-4, the rest within rtol 5e-3);
- the clustered frame against the dense one (plain path): u8 mean |d| <
  0.5 and max <= 2 levels (the JAX package's own limit,
  tests/test_cluster.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datum_tpu.ops import cluster as jcluster
from datum_tpu.ops.shade_pallas import shade_deferred_pallas
from datum_tpu.render import Camera as JCamera

import test_torch_shade as shade_t
from test_torch_frame import one_torch_thread  # noqa: F401 (autouse)

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops import cluster
from datum_tpu_torch.ops import raster as raster_ops
from datum_tpu_torch.ops.common import TILE_H, TILE_W
from datum_tpu_torch.ops.raster_cuda import _ndc_scale, _plane, early_z_bounds
from datum_tpu_torch.ops.shade_cuda import shade_deferred
from datum_tpu_torch.render.frame import light_clusters, render_frame
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import stress_scene

TX, TY, WIDTH, HEIGHT = 4, 8, 512, 256


def _camera():
    cam = JCamera()
    cam.set_projection(np.radians(60), 2.0)
    cam.lookat(np.array([0.0, 3, 12]), np.array([0.0, 0, 0]), np.array([0.0, 1, 0]))
    return cam.view().astype(np.float32), cam.proj().astype(np.float32)


def _depth(seed):
    """A reverse-Z depth plane with a background block (depth 0)."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(0.004, 0.05, (HEIGHT, WIDTH)).astype(np.float32)
    d[:, :150] = 0.0
    return d


@pytest.mark.parametrize("size", [(4, 8, 512, 256), (15, 34, 1920, 1088)])
def test_tile_frustum_planes_match_jax(size):
    view, proj = _camera()
    a = jcluster.tile_frustum_planes(jnp.asarray(view), jnp.asarray(proj), *size)
    b = cluster.tile_frustum_planes(torch.from_numpy(view), torch.from_numpy(proj),
                                    *size)
    assert b.shape == (size[0] * size[1], 4, 4)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


def test_tile_depth_bounds_match_jax():
    _, proj = _camera()
    d = _depth(1)
    a = jcluster.tile_depth_bounds(jnp.asarray(d), jnp.asarray(proj))
    b = cluster.tile_depth_bounds(torch.from_numpy(d), torch.from_numpy(proj))
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())
    # background tiles read far away, covered ones their surface distance
    assert (b[0].numpy() > 1e5).any() and (b[0].numpy() < 100).any()


# (name, lights, count, capacity, depth bounds, extra lights)
_CASES = [
    ("depth-bounds", 64, 64, 16, True, None),
    ("no-depth-bounds", 64, 64, 16, False, None),
    ("capacity-truncates", 64, 64, 4, True, None),
    ("count-below-rows", 64, 20, 16, True, None),
    ("offscreen-light", 1, 1, 8, True, [[0.0, 0.0, 40.0]]),     # behind the camera
    ("onscreen-light", 1, 1, 8, False, [[0.0, 0.0, 0.0]]),      # at the view centre
]


@pytest.mark.parametrize("name,n,count,cap,zb,pos", _CASES, ids=[c[0] for c in _CASES])
def test_bin_lights_match_jax(name, n, count, cap, zb, pos):
    view, proj = _camera()
    rng = np.random.RandomState(len(name))
    if pos is None:
        lp = rng.uniform([-10, 0, -8], [10, 5, 8], (n, 3)).astype(np.float32)
        rr = rng.uniform(1.0, 4.0, n).astype(np.float32)
    else:
        lp, rr = np.float32(pos), np.float32([2.0])
    d = _depth(2)
    jz = jcluster.tile_depth_bounds(jnp.asarray(d), jnp.asarray(proj)) if zb else None
    pz = cluster.tile_depth_bounds(torch.from_numpy(d), torch.from_numpy(proj)) \
        if zb else None
    jl, jc = jcluster.bin_lights(jnp.asarray(lp), jnp.asarray(rr), jnp.int32(count),
                                 jnp.asarray(view), jnp.asarray(proj), TX, TY, WIDTH,
                                 HEIGHT, cap, tile_zrange=jz)
    pl, pc = cluster.bin_lights(torch.from_numpy(lp), torch.from_numpy(rr),
                                torch.tensor(count), torch.from_numpy(view),
                                torch.from_numpy(proj), TX, TY, WIDTH, HEIGHT, cap,
                                tile_zrange=pz)
    assert pl.dtype == pc.dtype == torch.int32
    assert np.array_equal(np.asarray(jl), pl.numpy())
    assert np.array_equal(np.asarray(jc), pc.numpy())
    lists, counts = pl.numpy(), pc.numpy()
    for row, c in zip(lists, counts):
        assert (row[c:] == -1).all() and (np.diff(row[:c]) > 0).all()
        assert (row[:c] < count).all()
    if name == "capacity-truncates":
        assert (counts == cap).any()
    if name == "offscreen-light":
        assert counts.sum() == 0
    if name == "onscreen-light":
        assert (lists == 0).any()
    if name in ("depth-bounds", "count-below-rows"):
        assert counts.sum() > 0


def fragment_depth_max(rows, bins, big_ids, tiles_x, width, height):
    """(n_tiles, B+K): per tile and walk slot, the largest depth d of the
    entry's fragments that could pass (inside its edges and y scissor,
    valid, 0 < d <= 1), computed as the kernels compute them; -inf where
    it has none."""
    n = bins.shape[0]
    ids = torch.cat([big_ids[None].expand(n, -1), bins], 1)
    tile = torch.arange(n)
    yn = (((tile // tiles_x) * TILE_H).float()[:, None, None]
          + torch.arange(TILE_H).float()[None, :, None] + 0.5) * _ndc_scale(height) - 1.0
    xn = (((tile % tiles_x) * TILE_W).float()[:, None, None]
          + torch.arange(TILE_W).float()[None, None, :] + 0.5) * _ndc_scale(width) - 1.0
    out = torch.full(ids.shape, -float("inf"))
    for k in range(ids.shape[1]):
        idk = ids[:, k]
        r = (rows[idk.clamp(min=0).long(), :16] * (idk >= 0)[:, None])[:, :, None, None]
        e = [_plane(r[:, 3 * j], r[:, 3 * j + 1], r[:, 3 * j + 2], xn, yn) for j in range(3)]
        d = _plane(r[:, 9], r[:, 10], r[:, 11], xn, yn)
        ok = ((e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0) & (e[0] + e[1] + e[2] > 0)
              & (r[:, 12] > 0) & (yn >= r[:, 14]) & (yn < r[:, 15]) & (d > 0) & (d <= 1))
        out[:, k] = torch.where(ok, d, torch.full_like(d, -float("inf"))).amax((1, 2))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_early_z_bounds_cover_every_fragment(seed):
    """early_z_bounds, on random screen triangles binned near-first: no
    fragment of a slot or of any later slot lies above the slot's bound
    (so the kernels' exit changes no value), the bounds never grow along
    the walk, and they are tight enough to end some walks."""
    rng = np.random.RandomState(seed)
    n_tris = 300
    clip = np.concatenate([rng.uniform(-1.2, 1.2, (3 * n_tris, 2)),
                           rng.uniform(0.01, 0.9, (3 * n_tris, 1)),
                           np.ones((3 * n_tris, 1))], 1).astype(np.float32)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    setup = raster_ops.triangle_setup(torch.from_numpy(clip), torch.from_numpy(tris),
                                      WIDTH, HEIGHT, TX, TY, max_span=8)
    bins, _, big = raster_ops.bin_triangles(setup, n_tris, TX, TY, 64, 16, max_span=8,
                                            depth_prio=setup["zbound"])
    rows = setup["row16"]
    szb = early_z_bounds(rows, bins, big, TX, WIDTH, HEIGHT)
    frag = fragment_depth_max(rows, bins, big, TX, WIDTH, HEIGHT)
    assert szb.shape == frag.shape and szb.dtype == torch.float32
    assert (frag <= szb).all()
    assert (szb.diff(dim=1) <= 0).all()
    assert (frag > 0).sum() > 100 and (szb[:, 1:] < 0.95).any()


def _cluster_scene(n_lights=32, cap=8, seed=5):
    """test_torch_shade's template with n_lights point lights and random
    per-cell lists (ascending ids, count <= cap) over its H/16 bands and
    W/128 sub-tiles."""
    H, W = shade_t.H, shade_t.W
    ss, g = shade_t._scene(), shade_t._gplanes()
    rng = np.random.RandomState(seed)
    pl = ss["pointlights"]
    pl["position"] = (rng.uniform(-3, 3, (n_lights, 3)) + [0, 2, 0]).astype(np.float32)
    pl["intensity"] = rng.uniform(1, 4, (n_lights, 3)).astype(np.float32)
    pl["attenuation"] = np.tile(np.float32([0.2, 0.1, 1.0, 8.0]), (n_lights, 1))
    pl["count"] = np.int32(n_lights)
    nb, ns = H // 16, W // 128
    lists = np.full((nb, ns, cap), -1, np.int32)
    counts = rng.randint(0, cap + 1, (nb, ns)).astype(np.int32)
    counts[0, 0] = cap
    for b in range(nb):
        for k in range(ns):
            lists[b, k, :counts[b, k]] = np.sort(rng.choice(n_lights, counts[b, k],
                                                            replace=False))
    return ss, g, lists, counts


def test_k2_clustered_plain_matches_pallas():
    ss, g, lists, counts = _cluster_scene()
    a = shade_deferred_pallas(shade_t._jax_tree(g), shade_t._jax_tree(ss),
                              proj=jnp.asarray(ss["proj"]),
                              invview=jnp.asarray(ss["invview"]),
                              clusters=(jnp.asarray(lists), jnp.asarray(counts)),
                              interpret=True)
    tss = shade_t._torch_tree(ss)
    b = shade_deferred(shade_t._torch_tree(g), tss, proj=tss["proj"],
                       invview=tss["invview"],
                       clusters=(torch.from_numpy(lists), torch.from_numpy(counts)))
    a, b = np.asarray(a), b.numpy()
    assert np.isfinite(b).all() and np.abs(b).max() > 0.1
    close = np.isclose(b, a, atol=2e-5, rtol=1e-4)
    assert close.mean() >= 0.9998, (~close).sum()
    np.testing.assert_allclose(b, a, atol=2e-5, rtol=5e-3)
    # the lists matter: an empty cell shades differently from a full one
    dense = shade_deferred(shade_t._torch_tree(g), tss, proj=tss["proj"],
                           invview=tss["invview"]).numpy()
    assert np.abs(dense - b).max() > 1e-3


def test_k2_clusters_must_cover_the_planes():
    ss, g, lists, counts = _cluster_scene()
    tss = shade_t._torch_tree(ss)
    with pytest.raises(ValueError, match="sub-tiles"):
        shade_deferred(shade_t._torch_tree(g), tss, proj=tss["proj"],
                       invview=tss["invview"],
                       clusters=(torch.from_numpy(lists[:2]), torch.from_numpy(counts[:2])))


# the stress scene's lights (range 7 over a 28 x 22 area), 32 of them,
# with lists long enough for every light
CLUSTER_FRAME = dict(width=256, height=128, terrain_n=24, sphere_detail=8, grid=(3, 2),
                     n_point_lights=32, skybox=False, max_vertices=2048,
                     max_triangles=2048, bin_capacity=512, big_capacity=16,
                     bin_max_span=8, use_pallas=True, texture_filter="mip_half",
                     enable_shadows=False, tile_light_capacity=32)


def test_clustered_frame_matches_dense_frame():
    """With lists long enough for every light, the clustered frame (the
    tile lists culled by frustum and depth) matches the dense frame: a
    culled light adds nothing."""
    ctx, cam, params, make_rl = stress_scene(device="cpu", **CLUSTER_FRAME)
    rl = make_rl(0.3)
    ss = make_sceneset(cam, params, point_lights=rl.point_lights,
                       spot_lights=rl.spot_lights)
    draws, state = ctx.frame_draws(rl, cam), ctx.host_state()
    out = render_frame(ctx.config, state, draws, ss, device="cpu")
    dense = render_frame(dataclasses.replace(ctx.config, use_light_clusters=False),
                         state, draws, ss, device="cpu")
    a, b = out["image"].float(), dense["image"].float()
    assert b.mean() > 10
    d = (a - b).abs()
    assert d.mean() < 0.5 and d.max() <= 2, (d.mean(), d.max())
    lists, counts = light_clusters(ctx.config, out["depth"], to_torch(ss, "cpu"))
    assert lists.shape == (128 // 16, 2, 32) and counts.shape == (8, 2)
    assert 0 < counts.max() < 32, "the lists cull no light, or every light"
