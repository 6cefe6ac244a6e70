"""K3's warp-rectangle reject and its split walk, through their plain
twins (CPU).

The K3 kernel (csrc/raster_depth.cu) lets each warp skip an entry that
`warp_rect_reject` finds cannot pass on the warp's 32 x 16 rectangle,
and splits a tile's walk over 8 blocks (4 on large stacks) whose
partial maps it combines by a max.  The kernel runs only on the card; these tests hold the reject's
plain twin, which has the kernel's arithmetic, against the plain raster
`raster_depth_reference`: wherever the twin rejects an entry for a
rectangle, the plain raster of that entry alone keeps no texel of the
rectangle.  Cases: hypothesis triangles (pixel-centre and free vertices,
perspective w, eye-plane crossings, y scissors on row centres), edges
through the rectangles' corner pixels, the collapsed (zero-area)
triangles of a stress cascade stack past its terrain's morph end, and
scissor bands that end on a warp's rows.  The split: the max of the 8
(or 4) interleaved partial walks equals the full walk, bit for bit."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops import raster as raster_ops
from datum_tpu_torch.ops import shadow as shadow_ops
from datum_tpu_torch.ops.raster import tile_image
from datum_tpu_torch.ops.raster_cuda import _entry_ids, _ndc_scale
from datum_tpu_torch.ops.raster_depth_cuda import (depth_inputs, raster_depth_reference,
                                                   warp_rect_reject, warp_rects)
from datum_tpu_torch.render import frame as frame_mod
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import datumtest_scene, stress_scene

W, H, TX, TY = 256, 64, 2, 2          # 4 tiles of 32 x 128, 8 warps each
CX, CY = _ndc_scale(W), _ndc_scale(H)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread (many small ops; several test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _warp_kept(depth, tiles_x, n_tiles):
    """(n_tiles, 8): a texel of warp w's rectangle holds a depth."""
    t = tile_image(depth, tiles_x, n_tiles // tiles_x) > 0      # (n, 32, 128)
    return t.reshape(n_tiles, 2, 16, 4, 32).any(4).any(2).reshape(n_tiles, 8)


def _check_reject(rows, ids, tiles_x, width, height):
    """For every walk slot of ids (n_tiles, E): where the twin rejects the
    slot's entry for a warp, the plain raster of that entry alone keeps no
    texel of the warp's rectangle.  Returns (rejected, kept, checked)
    (entry, warp) counts over the valid entries."""
    n_tiles = ids.shape[0]
    rects = warp_rects(tiles_x, n_tiles, width, height)
    none = torch.zeros(0, dtype=torch.int32)
    counts = torch.zeros(n_tiles, dtype=torch.int32)
    rejected = kept_n = checked = 0
    for k in range(ids.shape[1]):
        col = ids[:, k]
        if not bool((col >= 0).any()):
            continue
        depth = raster_depth_reference(rows, col[:, None].to(torch.int32).contiguous(),
                                       counts, none, tiles_x, width, height)
        kept = _warp_kept(depth, tiles_x, n_tiles)
        r = rows[col.clamp(min=0).long()] * (col >= 0)[:, None].to(rows.dtype)
        rej = warp_rect_reject(r[:, None, :], *rects)
        bad = rej & kept
        assert not bool(bad.any()), (f"slot {k}: the twin rejects entries "
                                     f"{col[bad.any(1)].tolist()} on warps that keep texels")
        valid = (col >= 0)[:, None] & (r[:, None, 12] > 0)
        rejected += int((rej & valid).sum())
        kept_n += int((kept & valid).sum())
        checked += int(valid.expand_as(rej).sum())
    return rejected, kept_n, checked


def _ndc(p, scale):
    return np.float32((np.float32(p) + np.float32(0.5)) * np.float32(scale)
                      - np.float32(1.0))


def _setup(verts, ylim=None):
    """Triangle setup of consecutive (x, y, z, w) clip vertex triples on
    the 256 x 64 test viewport (4 tiles)."""
    clip = torch.tensor(np.asarray(verts, np.float32).reshape(-1, 4))
    tris = torch.arange(clip.shape[0], dtype=torch.int32).reshape(-1, 3)
    return raster_ops.triangle_setup(clip, tris, W, H, TX, TY, ylim=ylim)


def _every_tile(n_tris):
    """An id table that walks every triangle in every tile."""
    return torch.arange(n_tris, dtype=torch.int32)[None, :].expand(TX * TY, n_tris)


# screen coordinates (pixels): pixel centres, or free f32 values
PX = st.one_of(st.integers(-40, W + 40).map(lambda p: (p, True)),
               st.floats(-60.0, W + 60.0, width=32).map(lambda p: (p, False)))
PY = st.one_of(st.integers(-20, H + 20).map(lambda p: (p, True)),
               st.floats(-30.0, H + 30.0, width=32).map(lambda p: (p, False)))
VERTEX = st.tuples(PX, PY, st.floats(0.0, 1.0, width=32),
                   st.sampled_from([1.0, 1.0, 0.5, 2.5, -0.75]))
ROW_Y = st.integers(-2, H + 2).map(lambda r: float(_ndc(r, CY)))


def _clip_vertex(v):
    (px, cx_), (py, cy_), z, w = v
    x = _ndc(px, CX) if cx_ else np.float32(np.float32(px) * np.float32(CX) - 1)
    y = _ndc(py, CY) if cy_ else np.float32(np.float32(py) * np.float32(CY) - 1)
    return [x * w, y * w, z * abs(w), w]


@settings(max_examples=80, deadline=None)
@given(tris=st.lists(st.tuples(VERTEX, VERTEX, VERTEX), min_size=1, max_size=6),
       band=st.one_of(st.none(), st.tuples(ROW_Y, ROW_Y)))
def test_reject_never_drops_a_kept_texel(tris, band):
    """Hypothesis triangles: pixel-centre and free vertices, perspective
    w, eye-plane crossings (w < 0) and y scissors on row centres."""
    verts = [_clip_vertex(v) for t in tris for v in t]
    ylim = None if band is None else tuple(torch.tensor(b) for b in band)
    setup = _setup(verts, ylim)
    _check_reject(setup["row16"], _every_tile(len(tris)), TX, W, H)


def test_reject_with_edges_through_rectangle_corners():
    """Edges through the corner pixels of every warp rectangle of tile 0:
    along each side of the rectangle (through two corners) and fanning
    out from each corner, with the third vertex outside and inside, and
    perspective w on the vertices.  The edge values along a side are
    rounding noise around 0, of either sign from pixel to pixel.  Some of
    these entries keep texels of rectangles they touch only on that side;
    none of those is rejected, and entries that stay outside are."""
    x0, x1, y0, y1 = (r[0] for r in warp_rects(TX, TX * TY, W, H))
    ws = (1.0, 0.7, 1.3, 2.9)
    verts = []

    def tri(p, q, o, k):
        # the triangle p, q, o with w from ws by k: both windings
        w = [np.float32(ws[(k + j) % 4]) for j in range(3)]
        for a, b in ((p, q), (q, p)):
            verts.extend([[*(a * w[0]), 0.5, w[0]], [*(b * w[1]), 0.6, w[1]],
                          [*(o * w[2]), 0.7, w[2]]])

    for w_ in range(8):
        cs = [np.float32([x, y]) for x in (x0[w_], x1[w_]) for y in (y0[w_], y1[w_])]
        cen = (cs[0] + cs[3]) * np.float32(0.5)
        for i, j in ((0, 1), (2, 3), (0, 2), (1, 3)):      # the four sides
            p, q = cs[i], cs[j]
            out = p + (p - cen) * np.float32(3)                # beyond the side
            for k in range(4):
                tri(p, q, out, k)
                tri(p, q, cen, k)
        for c in cs:                                           # fans from each corner
            for dx, dy in ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1)):
                a = c + np.float32([dx, dy]) * np.float32(37 * CX)
                b = c + np.float32([dy, -dx]) * np.float32(23 * CY)
                tri(c, a, b, dx + 2)
    setup = _setup(verts)
    rejected, kept, checked = _check_reject(setup["row16"], _every_tile(len(verts) // 3),
                                            TX, W, H)
    assert kept > 0 and rejected > checked // 2, (rejected, kept, checked)


def test_reject_on_collapsed_terrain_cells():
    """A stress cascade stack whose terrain draw morphs past its farthest
    vertex: the cells of a 4x4 block collapse to its coarse corner, and
    their zero-area triangles cover texels by rounding noise.  The twin
    rejects most (entry, warp) pairs and none that keeps a texel."""
    ctx, cam, params, mk = stress_scene(
        width=256, height=128, terrain_n=32, sphere_detail=8, grid=(2, 2),
        n_point_lights=4, skybox=False, bin_capacity=512, big_capacity=32,
        bin_max_span=8, use_pallas=True, texture_filter="mip_half", shadow_res=256,
        shadow_bin_capacity=256, device="cpu")
    rl = mk(0.3)
    rl.draws[0]["morph"] = np.float32([0.5, 1.0])     # every cell collapses
    s = to_torch(make_sceneset(cam, params, point_lights=rl.point_lights,
                               spot_lights=rl.spot_lights), "cpu")
    d = to_torch(ctx.frame_draws(rl, cam), "cpu")
    ex, _, _, _, _, wp = frame_mod._vertex_stage(ctx.config, ctx.device_state("cpu"),
                                                 d, s)
    (stack,) = shadow_ops.cascade_stacks(wp, ex["tris"], s["mainlight"]["shadowview"],
                                         res=256)
    bins, counts, big = shadow_ops.bin_stack(stack, 256, 32)
    rows = stack["setup"]["row16"]
    assert int(counts.max()) > 64
    rejected, kept, checked = _check_reject(rows, _entry_ids(bins, big), stack["tiles_x"],
                                            stack["res"], stack["height"])
    assert kept > 0 and rejected > checked // 2, (rejected, kept, checked)


@pytest.mark.parametrize("row", [0, 15, 16, 17, 31, 32, 47, 48, 63])
def test_reject_scissor_bands_ending_on_warp_rows(row):
    """A triangle over the whole viewport with its y scissor ending on a
    row's centre (and one f32 ulp either side), from above and from
    below: the twin rejects a warp exactly where none of its rows passes
    (the edges reject nothing here)."""
    y = _ndc(row, CY)
    ends = [np.nextafter(y, np.float32(-2)), y, np.nextafter(y, np.float32(2))]
    verts, los, his = [], [], []
    for e in ends:
        for lo, hi in ((np.float32(-8), e), (e, np.float32(8))):
            verts += [[-3, -3, 0.5, 1], [9, -3, 0.5, 1], [-3, 9, 0.5, 1]]
            los.append(lo)
            his.append(hi)
    setup = _setup(verts, (torch.tensor(np.float32(los)), torch.tensor(np.float32(his))))
    rows = setup["row16"]
    rects = warp_rects(TX, TX * TY, W, H)
    for t in range(rows.shape[0]):
        depth = raster_depth_reference(
            rows, torch.full((TX * TY, 1), t, dtype=torch.int32),
            torch.ones(TX * TY, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
            TX, W, H)
        kept = _warp_kept(depth, TX, TX * TY)
        assert torch.equal(warp_rect_reject(rows[t], *rects), ~kept), t


@pytest.mark.parametrize("split", [4, 8])
def test_split_walk_max_is_the_full_walk(split):
    """The max of the split partial walks (slots g = r mod split of each
    tile's big list + bin sequence) equals the full walk on every texel
    of the small shadowed scene's near cascades."""
    ctx, camera, params, make_rl = datumtest_scene(
        width=256, height=128, sphere_detail=8, grid=(4, 3), n_point_lights=2,
        skybox=False, max_vertices=2048, max_triangles=2048, bin_capacity=128,
        big_capacity=16, use_pallas=True, shadow_res=256, shadow_far_res=128,
        shadow_bin_capacity=128, device="cpu")
    rl = make_rl(0.3)
    s = to_torch(make_sceneset(camera, params, point_lights=rl.point_lights,
                               spot_lights=rl.spot_lights), "cpu")
    d = to_torch(ctx.frame_draws(rl, camera), "cpu")
    ex, _, _, _, _, wp = frame_mod._vertex_stage(ctx.config, ctx.device_state("cpu"),
                                                 d, s)
    st_ = shadow_ops.cascade_stacks(wp, ex["tris"], s["mainlight"]["shadowview"],
                                    res=256, far_res=128)[0]
    bins, counts, big = shadow_ops.bin_stack(st_, 128, 16)
    inp = depth_inputs(st_["setup"], bins, big, counts, st_["tiles_x"], st_["res"],
                       st_["height"])
    full = raster_depth_reference(**inp)
    assert (full > 0).float().mean().item() > 0.05
    ids = _entry_ids(inp["bins"], inp["big_ids"])
    slot = torch.arange(ids.shape[1])
    parts = []
    for r in range(split):
        mine = torch.where((slot % split == r)[None, :], ids, torch.full_like(ids, -1))
        parts.append(raster_depth_reference(**dict(
            inp, bins=mine.to(torch.int32).contiguous(),
            big_ids=torch.zeros(0, dtype=torch.int32))))
    assert torch.equal(torch.stack(parts).amax(0), full)
