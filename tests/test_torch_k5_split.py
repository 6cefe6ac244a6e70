"""K5's split walk and its warp-rectangle reject with the row scissor,
through their plain twins (CPU; no jax).

The K5 kernel (csrc/raster_v1.cu) splits each tile's walk over a
cluster of 2 or 4 blocks (8 when a caller forces it): block r walks the
slots g = r (mod split) of the tile's sequence carrying its partial
(depth, walk slot), the partials combine to the largest depth and then
the smallest slot, and the winning slot is mapped to its id only after
the combine.  `split_walk(..., step=raster_v1_walk_step)` is that walk
in plain PyTorch; with the slot -> id map and `v1_planes` it is the
kernel, which the tests hold bit for bit against `raster_v1_reference`
(the sequential walk) at 2, 4 and 8 blocks.  K5's warps skip the entries
that `warp_rect_reject(..., scissor=True)` rejects (K3's reject: the
scissor compare and the edge-corner test with its margin); the tests
hold that twin against the plain K5 raster of each entry alone, against
the exact (f64-summed) edge at the rectangles' corners, and against
scissor bands that end on a warp's rows, and show that a zero margin or
a dropped scissor compare makes those checks fail.  A split walk that
applies the reject per warp rectangle gives the plain walk's planes."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops import raster as raster_ops
from datum_tpu_torch.ops import raster_depth_cuda
from datum_tpu_torch.ops.raster import _untile, tile_image
from datum_tpu_torch.ops.raster_cuda import (NO_SLOT, _entry_ids, _ndc_scale, _tile_ndc,
                                             split_walk)
from datum_tpu_torch.ops.raster_depth_cuda import warp_rect_reject, warp_rects
from datum_tpu_torch.ops.raster_v1_cuda import (raster_v1_inputs, raster_v1_reference,
                                                raster_v1_walk_step, v1_planes)
from datum_tpu_torch.render import frame as frame_mod
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import stress_scene

W, H, TX, TY = 256, 64, 2, 2          # 4 tiles of 32 x 128, 8 warps of 32 x 16 each
CX, CY = _ndc_scale(W), _ndc_scale(H)
NONE = torch.zeros(0, dtype=torch.int32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread (many small ops; several test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ndc(p, scale):
    return np.float32((np.float32(p) + np.float32(0.5)) * np.float32(scale)
                      - np.float32(1.0))


def _rows(verts, ylim=None):
    """K5's rows (the setup's row16) of consecutive (x, y, z, w) clip
    vertex triples on the 256 x 64 viewport; ylim: per-triangle scissors."""
    clip = torch.tensor(np.asarray(verts, np.float32).reshape(-1, 4))
    tris = torch.arange(clip.shape[0], dtype=torch.int32).reshape(-1, 3)
    return raster_ops.triangle_setup(clip, tris, W, H, TX, TY, ylim=ylim)["row16"]


def _random_rows(seed, n_tris, size=0.3, scissors=True):
    """Rows of n_tris random triangles, a fifth with perspective w and a
    few crossing the eye plane (invalid rows); with scissors, every other
    triangle carries a random y scissor band on row centres."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-1.1, 1.1, (n_tris, 1, 2))
    xy = c + rng.uniform(-size, size, (n_tris, 3, 2))
    z = rng.uniform(0.05, 0.95, (n_tris, 3, 1))
    w = np.where(rng.rand(n_tris, 1, 1) < 0.2, rng.uniform(-0.3, 2.0, (n_tris, 3, 1)), 1.0)
    ylim = None
    if scissors:
        lo = _ndc(rng.randint(-4, H, n_tris), CY)
        hi = _ndc(rng.randint(0, H + 4, n_tris), CY)
        open_ = np.arange(n_tris) % 2 == 0
        ylim = (torch.tensor(np.where(open_, np.float32(-8), lo)),
                torch.tensor(np.where(open_, np.float32(8), hi)))
    return _rows(np.concatenate([xy * w, z * np.abs(w), w], -1).reshape(-1, 4), ylim)


def _random_ids(seed, n_rows, E, n_tiles=TX * TY):
    """A walk table (n_tiles, E) of random ids with repeats and -1s."""
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.randint(-1, n_rows, (n_tiles, E)), dtype=torch.int32)


def _reference(rows, ids):
    """raster_v1_reference walking ids (n_tiles, E) as each tile's bin."""
    return raster_v1_reference(rows, ids.to(torch.int32).contiguous(),
                               torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int32),
                               NONE, TX, W, H)


def _k5_split(rows, ids, split, step=raster_v1_walk_step):
    """The K5 kernel in plain PyTorch: split_walk with K5's step, the
    winning slot mapped to its id after the combine, K5's epilogue.
    Returns the (4, H, W) planes and the (n_tiles, 32, 128) slots."""
    n_tiles = ids.shape[0]
    depth, slot = split_walk(rows, ids, TX, W, H, split, step=step)
    won = slot != NO_SLOT
    win = torch.gather(ids, 1, torch.where(won, slot, 0).reshape(n_tiles, -1))
    win = torch.where(won, win.reshape(slot.shape), -1)
    xn, yn = _tile_ndc(n_tiles, TX, W, H, "cpu")
    planes = torch.stack([_untile(p, TX, TY) for p in v1_planes(rows, win, depth, xn, yn)])
    return planes, slot


def _check_k5(rows, ids, step=raster_v1_walk_step):
    """_k5_split at 2, 4 and 8 blocks equals raster_v1_reference bit for
    bit on all 4 planes; returns the covered share."""
    ref = _reference(rows, ids)
    for split in (2, 4, 8):
        out, _ = _k5_split(rows, ids, split, step)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), split
    return (ref[1] >= 0).float().mean().item()


# ---- the split walk


@pytest.mark.parametrize("seed", [0, 1])
def test_k5_split_random_rows(seed):
    """Random triangles with and without scissors, invalid rows, and each
    tile's sequence with repeated ids and -1s."""
    rows = _random_rows(seed, 40)
    assert bool((rows[:, 12] <= 0).any()) and bool((rows[:, 15] < 8).any())
    assert _check_k5(rows, _random_ids(seed, 40, 90)) > 0.1


def test_k5_split_equal_depths_and_repeated_ids():
    """Copies of large triangles (the same depth at every pixel) and the
    same id again, at slots that fall to different blocks: the first slot
    in walk order wins whichever block walked it, and its id, though the
    same id stands at other slots too."""
    rows = _random_rows(3, 12, size=0.9, scissors=False)
    rows = torch.cat([rows, rows[:6]]).contiguous()      # ids 12-17 copy 0-5
    ids = torch.tensor([[17, 5, 3, 15, 5, 12, 0, 3, 17, 1, 13, 2, 14, 4, 16, 11, 9, -1],
                        [5, 17, 11, 3, 3, 15, 1, 13, -1, -1, 4, 12, 0, 14, 10, 8, 7, 5],
                        [0, 12, 6, 6, 0, 1, 13, 7, 2, 14, 8, 3, 15, 9, -1, 16, 4, 10],
                        [9, 8, 7, 6, 17, 16, 15, 14, 13, 12, 5, 4, 3, 2, 1, 0, 17, 5]],
                       dtype=torch.int32)
    assert _check_k5(rows, ids) > 0.3
    # a repeated id wins at its first slot, and winners come from every block
    _, slot = _k5_split(rows, ids, 4)
    won = slot[slot != NO_SLOT]
    assert set((won % 4).tolist()) == {0, 1, 2, 3}
    first = {}
    for t in range(4):
        for g, i in enumerate(ids[t].tolist()):
            first.setdefault((t, i), g)
    for t in range(4):
        g = slot[t][slot[t] != NO_SLOT]
        assert all(first[t, ids[t, s].item()] == s for s in torch.unique(g).tolist())


# ---- the reject


def _k5_kept(rows, col, every=False):
    """(n_tiles, 8): the plain K5 raster of the entries col (n_tiles,)
    alone keeps a pixel (with every: each pixel) of warp w's 32 x 16
    rectangle."""
    out = _reference(rows, col[:, None])
    t = (tile_image(out[1], TX, TY) >= 0).reshape(-1, 2, 16, 4, 32)
    return (t.all(4).all(2) if every else t.any(4).any(2)).reshape(-1, 8)


def _check_k5_reject(rows, ids):
    """Wherever K5's reject skips a slot's entry for a warp, the plain K5
    raster of that entry alone keeps no pixel of the warp's rectangle.
    Returns the (rejected, kept, rejected by the scissor compare alone)
    counts of valid (entry, warp) pairs."""
    rects = warp_rects(TX, ids.shape[0], W, H)
    rejected = kept_n = by_scissor = 0
    for k in range(ids.shape[1]):
        col = ids[:, k]
        kept = _k5_kept(rows, col)
        r = rows[col.clamp(min=0).long()] * (col >= 0)[:, None].to(rows.dtype)
        rej = warp_rect_reject(r[:, None, :], *rects, scissor=True)
        valid = (col >= 0)[:, None] & (r[:, None, 12] > 0)
        assert not bool((rej & kept).any()), f"slot {k}: K5's reject drops kept pixels"
        rejected += int((rej & valid).sum())
        kept_n += int((kept & valid).sum())
        edges = warp_rect_reject(r[:, None, :], *rects, scissor=False)
        by_scissor += int((rej & ~edges & valid).sum())
    return rejected, kept_n, by_scissor


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


def _every_tile(n):
    return torch.arange(n, dtype=torch.int32)[None].expand(TX * TY, n)


@settings(max_examples=60, deadline=None)
@given(tris=st.lists(st.tuples(VERTEX, VERTEX, VERTEX), min_size=1, max_size=6),
       band=st.one_of(st.none(), st.tuples(ROW_Y, ROW_Y)))
def test_k5_reject_never_drops_a_kept_pixel(tris, band):
    """Hypothesis triangles: pixel-centre and free vertices, perspective
    w, eye-plane crossings (w < 0), and y scissors on row centres, which
    cut through warp rectangles."""
    ylim = None if band is None else tuple(torch.tensor([b] * len(tris)) for b in band)
    rows = _rows([_clip_vertex(v) for t in tris for v in t], ylim)
    _check_k5_reject(rows, _every_tile(len(tris)))


def test_k5_reject_with_scissors_through_warp_rectangles():
    """Random triangles whose scissor bands start and end on row centres
    inside warp rectangles: the scissor compare skips the warps the band
    misses, and no warp that keeps a pixel."""
    rows = _random_rows(7, 60, size=0.5)
    rejected, kept, by_scissor = _check_k5_reject(rows, _every_tile(60))
    assert kept > 0 and rejected > kept and by_scissor > 0, (rejected, kept, by_scissor)


def _corner_triangles():
    """Clip vertices of triangles with edges through the corner pixels of
    every warp rectangle of tile 0: along each side (through two corners)
    with the third vertex beyond the side and at the centre, fans from
    each corner, both windings, perspective w on the vertices.  Their
    edge values at the corners are rounding noise around 0."""
    x0, x1, y0, y1 = (r[0] for r in warp_rects(TX, TX * TY, W, H))
    ws = (1.0, 0.7, 1.3, 2.9)
    verts = []

    def tri(p, q, o, k):
        w = [np.float32(ws[(k + j) % 4]) for j in range(3)]
        for a, b in ((p, q), (q, p)):
            verts.extend([[*(a * w[0]), 0.5, w[0]], [*(b * w[1]), 0.6, w[1]],
                          [*(o * w[2]), 0.7, w[2]]])

    for w_ in range(8):
        cs = [np.float32([x, y]) for x in (x0[w_], x1[w_]) for y in (y0[w_], y1[w_])]
        cen = (cs[0] + cs[3]) * np.float32(0.5)
        for i, j in ((0, 1), (2, 3), (0, 2), (1, 3)):
            p, q = cs[i], cs[j]
            out = p + (p - cen) * np.float32(3)
            for k in range(4):
                tri(p, q, out, k)
                tri(p, q, cen, k)
        for c in cs:
            for dx, dy in ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1)):
                a = c + np.float32([dx, dy]) * np.float32(37 * CX)
                b = c + np.float32([dy, -dx]) * np.float32(23 * CY)
                tri(c, a, b, dx + 2)
    return verts


def _check_exact_corners(rows):
    """Wherever the reject drops an edge for a warp of tile 0, that edge's
    exact value (its f32 coefficients and corners, summed exactly) is
    below 0 at all four corners, so on the whole rectangle.  Returns the
    rejected (edge, warp) count."""
    x0, x1, y0, y1 = (r[0] for r in warp_rects(TX, TX * TY, W, H))
    corners = [(float(x[w]), float(y[w])) for w in range(8) for x in (x0, x1)
               for y in (y0, y1)]
    n_rejected = 0
    for k in range(3):
        only = torch.zeros_like(rows)                  # edge k alone, open scissor
        only[:, 3 * k:3 * k + 3] = rows[:, 3 * k:3 * k + 3]
        only[:, 14], only[:, 15] = -8.0, 8.0
        rej = warp_rect_reject(only[:, None, :], x0, x1, y0, y1)        # (T, 8)
        a, b, c = (rows[:, 3 * k + j].tolist() for j in range(3))
        for t, w in torch.nonzero(rej).tolist():
            exact = [math.fsum((a[t] * x, b[t] * y, c[t]))
                     for x, y in corners[4 * w:4 * w + 4]]
            assert max(exact) < 0, (k, t, w, exact)
            n_rejected += 1
    return n_rejected


def test_k5_reject_with_edges_through_rectangle_corners():
    """The corner triangles: the reject drops no pixel the plain K5 raster
    keeps, and every edge it rejects is exactly below 0 on the rectangle."""
    rows = _rows(_corner_triangles())
    rejected, kept, _ = _check_k5_reject(rows, _every_tile(rows.shape[0]))
    assert kept > 0 and rejected > 0, (rejected, kept)
    assert _check_exact_corners(rows) > rows.shape[0]


def _check_scissor_band(row, scissor=True):
    """A triangle over the whole viewport with its y scissor ending on
    row `row`'s centre (and one f32 ulp either side), from above and from
    below: the reject skips a warp exactly where none of its rows passes
    (the edges reject nothing here), and the kernel's test for dropping
    the per-pixel compare, y0 >= ylo and y1 < yhi, holds exactly where
    every row passes."""
    y = _ndc(row, CY)
    ends = [np.nextafter(y, np.float32(-2)), y, np.nextafter(y, np.float32(2))]
    verts, los, his = [], [], []
    for e in ends:
        for lo, hi in ((np.float32(-8), e), (e, np.float32(8))):
            verts += [[-3, -3, 0.5, 1], [9, -3, 0.5, 1], [-3, 9, 0.5, 1]]
            los.append(lo)
            his.append(hi)
    rows = _rows(verts, (torch.tensor(np.float32(los)), torch.tensor(np.float32(his))))
    rects = warp_rects(TX, TX * TY, W, H)
    for t in range(rows.shape[0]):
        col = torch.full((TX * TY,), t, dtype=torch.int32)
        kept = _k5_kept(rows, col)
        assert torch.equal(warp_rect_reject(rows[t], *rects, scissor=scissor), ~kept), t
        inside = (rects[2] >= rows[t, 14]) & (rects[3] < rows[t, 15])
        assert torch.equal(inside, _k5_kept(rows, col, every=True)), t


@pytest.mark.parametrize("row", [0, 15, 16, 17, 31, 32, 47, 63])
def test_k5_reject_scissor_bands_ending_on_warp_rows(row):
    _check_scissor_band(row)


def test_k5_reject_checks_fail_without_margin_or_scissor(monkeypatch):
    """The checks above can fail: without the scissor compare the twin
    keeps warps whose rows the band misses (the band check fails), and
    with the margin set to 0 it rejects edges whose exact value is 0 or
    above at a corner of the rectangle (the corner check fails)."""
    with pytest.raises(AssertionError):
        _check_scissor_band(16, scissor=False)
    rows = _rows(_corner_triangles())
    monkeypatch.setattr(raster_depth_cuda, "REJECT_REL", 0.0)
    monkeypatch.setattr(raster_depth_cuda, "REJECT_ABS", 0.0)
    with pytest.raises(AssertionError):
        _check_exact_corners(rows)


def _rejecting_step(rows, idk, xn, yn, depth, peel_t=None):
    """K5's walk step with the reject applied as the kernel applies it:
    a warp that rejects the entry tests none of its pixels."""
    passed, d = raster_v1_walk_step(rows, idk, xn, yn, depth)
    n = idk.shape[0]
    r = rows[idk.clamp(min=0).long()] * (idk >= 0)[:, None].to(rows.dtype)
    rej = warp_rect_reject(r[:, None, :], *warp_rects(TX, n, W, H))      # (n, 8)
    pix = rej.reshape(n, 2, 1, 4, 1).expand(n, 2, 16, 4, 32).reshape(n, 32, 128)
    return passed & ~pix, d


@pytest.mark.parametrize("seed", [0, 5])
def test_k5_split_walk_with_the_reject_gives_the_plain_planes(seed):
    """The split walk with the reject applied per warp rectangle, at 2, 4
    and 8 blocks, gives the plain walk's 4 planes bit for bit, while the
    reject skips pixels' tests."""
    rows = _random_rows(seed, 50, size=0.4)
    ids = _random_ids(seed, 50, 70)
    assert _check_k5(rows, ids, step=_rejecting_step) > 0.1
    r = rows[ids.clamp(min=0).long()]
    rej = warp_rect_reject(r[:, :, None, :], *(v[:, None, :] for v in
                                              warp_rects(TX, TX * TY, W, H)))
    assert float(rej[ids >= 0].float().mean()) > 0.5


def test_k5_reject_on_collapsed_terrain_cells():
    """The main view of a stress frame whose terrain morphs past its
    farthest vertex, through raster_v1_inputs: collapsed (zero-area)
    cells cover pixels by rounding noise.  The reject skips most (entry,
    warp) pairs and none that keeps a pixel, and the split walks give the
    full walk's planes on this frame."""
    ctx, cam, params, mk = stress_scene(
        width=W, height=H, terrain_n=40, sphere_detail=6, grid=(2, 1),
        n_point_lights=4, skybox=False, bin_capacity=256, big_capacity=16,
        bin_max_span=8, use_pallas=True, texture_filter="bilinear", shadow_res=128,
        shadow_bin_capacity=128, enable_shadows=False, device="cpu")
    rl = mk(0.3)
    rl.draws[0]["morph"] = np.float32([0.5, 1.0])     # every cell collapses
    s = to_torch(make_sceneset(cam, params, point_lights=rl.point_lights,
                               spot_lights=rl.spot_lights), "cpu")
    d = to_torch(ctx.frame_draws(rl, cam), "cpu")
    cfg = ctx.config
    ex, _, clip, _, _, _ = frame_mod._vertex_stage(cfg, ctx.device_state("cpu"), d, s)
    setup, bins, counts, big, _ = frame_mod._bin_stage(cfg, ex, clip)
    assert (cfg.tiles_x, cfg.padded_width, cfg.padded_height) == (TX, W, H)
    assert int(counts.max()) > 64
    inp = raster_v1_inputs(setup, bins, big, counts, TX, W, H)
    ids = _entry_ids(inp["bins"], inp["big_ids"]).to(torch.int32)
    rejected, kept, _ = _check_k5_reject(inp["rows"], ids)
    assert kept > 0 and rejected > kept, (rejected, kept)
    assert _check_k5(inp["rows"], ids) > 0.2
