"""K6's and K7's split walks and K7's edges-only reject, through their
plain twins (CPU; no jax).

The K6 kernel (csrc/raster_shade_2p.cu) walks as K1 does: a cluster of
2 or 4 blocks a tile, block r walking the slots g = r (mod split) of the
tile's sequence with its own early-z exit, the partials combined to the
largest depth and then the smallest slot.  Then each block runs the
second phase on the rows it combined: it flags the slots won in them,
compacts the flags with a prefix sum, stages the won rows and evaluates
each pixel's planes from its staged row.  `_k6_split` below is that
kernel in plain PyTorch (`ops/raster_cuda.split_walk`, then the
per-block phase 2); the tests hold it bit for bit against
`raster_shade_2p_reference` at 2, 4 and 8 blocks.  K7
(csrc/raster_mxu.cu) splits its walk the same way in its own
arithmetic (`split_walk` with `mxu_walk_step`), carrying slots and
mapping the winner's slot to its id after the combine; the tests hold
that against `raster_mxu_reference`.  K7's warps skip the entries that
`warp_rect_reject(..., scissor=False, form="dot")` rejects; the tests
hold that twin against the plain K7 raster of each entry alone, against
the exact (f64-summed) edge at the rectangle's corners, and, with the
margin set to 0, against K7's own per-pixel edge values."""

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
                                             _winner_planes, early_z_bounds,
                                             raster_shade_2p_reference, split_walk)
from datum_tpu_torch.ops.raster_depth_cuda import warp_rect_reject, warp_rects
from datum_tpu_torch.ops.raster_mxu_cuda import (_dot_plane, mxu_planes, mxu_rows,
                                                 mxu_walk_step, raster_mxu_inputs,
                                                 raster_mxu_reference)
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


def _clip(seed, n_tris, size=0.3):
    """(3 * n_tris, 4) clip vertices of random triangles on the 256 x 64
    viewport, a fifth with perspective w and a few crossing the eye plane."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-1.1, 1.1, (n_tris, 1, 2))
    xy = c + rng.uniform(-size, size, (n_tris, 3, 2))
    z = rng.uniform(0.05, 0.95, (n_tris, 3, 1))
    w = np.where(rng.rand(n_tris, 1, 1) < 0.2, rng.uniform(-0.3, 2.0, (n_tris, 3, 1)), 1.0)
    return np.concatenate([xy * w, z * np.abs(w), w], -1).reshape(-1, 4)


def _setup(clip):
    clip = torch.tensor(np.asarray(clip, np.float32).reshape(-1, 4))
    tris = torch.arange(clip.shape[0], dtype=torch.int32).reshape(-1, 3)
    return raster_ops.triangle_setup(clip, tris, W, H, TX, TY), tris


def _k6_rows(seed, n_tris, size=0.3, copies=0):
    """K6 rows (T, 64): the setup's row16 and random attribute slots;
    with copies, rows n_tris.. repeat rows 0.. (the same depth)."""
    setup, _ = _setup(_clip(seed, n_tris, size))
    g = torch.Generator().manual_seed(seed)
    rows = torch.cat([setup["row16"], torch.rand((n_tris, 48), generator=g) * 2 - 1], 1)
    return torch.cat([rows, rows[:copies]]).contiguous()


def _mxu_rows(clip, seed):
    """K7 rows (T, 40) of the triangles of clip, with random uv, normals
    and materials."""
    setup, tris = _setup(clip)
    rng = np.random.RandomState(seed)
    n_v, n_t, nm = setup["adj"].shape[0] * 3, tris.shape[0], 5
    f = lambda *s: torch.tensor(rng.rand(*s), dtype=torch.float32)
    mats = dict(color=f(nm, 4), emissive=f(nm), metalness=f(nm), roughness=f(nm),
                reflectivity=f(nm),
                albedomap=torch.tensor(rng.randint(0, 4, nm), dtype=torch.int32))
    return mxu_rows(setup, tris, f(n_v, 2), f(n_v, 3) * 2 - 1,
                    torch.tensor(rng.randint(0, nm, n_t), dtype=torch.int32), mats)


def _random_ids(seed, n_rows, E, n_tiles=TX * TY):
    """A walk table (n_tiles, E) of random ids with repeats and -1s."""
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.randint(-1, n_rows, (n_tiles, E)), dtype=torch.int32)


# ---- K6


def _k6_split(rows, ids, split, peel=None, szb=None):
    """The K6 kernel in plain PyTorch: split_walk, then each block's
    second phase over its 32 / split rows of every tile — flag the won
    slots, compact them (prefix sum), stage the won rows, evaluate each
    pixel's planes from its staged row.  Returns the (22, H, W) planes
    and, per block, (won, staged): won (n_tiles, E) the flags and
    staged[t][j] the slot staged at compacted index j of tile t."""
    n_tiles, E = ids.shape
    depth, slot = split_walk(rows, ids, TX, W, H, split, peel, szb)
    xn, yn = _tile_ndc(n_tiles, TX, W, H, "cpu")
    tile = torch.arange(n_tiles)[:, None, None]
    band = 32 // split
    planes, blocks = [], []
    for r in range(split):
        g = slot[:, r * band:(r + 1) * band]
        has = g != NO_SLOT
        won = torch.zeros((n_tiles, E + 1), dtype=torch.int64)
        won.scatter_(1, torch.where(has, g, E).reshape(n_tiles, -1), 1)
        won = won[:, :E]
        pos = torch.cumsum(won, 1) - 1                      # compacted index
        staged = [torch.nonzero(won[t]).flatten() for t in range(n_tiles)]
        rows_t = torch.zeros((n_tiles, max(1, int(won.sum(1).max())), rows.shape[1]))
        for t in range(n_tiles):
            rows_t[t, :len(staged[t])] = rows[ids[t, staged[t]].long()]
        gc = torch.where(has, g, 0).reshape(n_tiles, -1)
        k = torch.gather(pos, 1, gc).reshape(g.shape)
        visf = torch.gather(ids, 1, gc).reshape(g.shape).to(torch.float32)
        planes.append(torch.stack(_winner_planes(
            rows_t[tile, k], depth[:, r * band:(r + 1) * band], has, visf, xn,
            yn[:, r * band:(r + 1) * band])))
        blocks.append((won, staged))
    out = torch.cat(planes, 2)                              # (22, n, 32, 128)
    return torch.stack([_untile(p, TX, TY) for p in out]), blocks, slot


def _check_k6(rows, ids, peel=None, szb=None):
    """_k6_split at 2, 4 and 8 blocks equals raster_shade_2p_reference
    bit for bit, and each block's compacted list is the set of slots won
    in its rows, in walk order; returns the covered share."""
    ref = raster_shade_2p_reference(rows, ids.contiguous(),
                                    torch.zeros(ids.shape[0], dtype=torch.int32), NONE,
                                    TX, W, H, peel=peel)
    for split in (2, 4, 8):
        out, blocks, slot = _k6_split(rows, ids, split, peel, szb)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), split
        band = 32 // split
        for r, (won, staged) in enumerate(blocks):
            for t in range(ids.shape[0]):
                mine = slot[t, r * band:(r + 1) * band]
                expect = torch.unique(mine[mine != NO_SLOT])    # sorted: walk order
                assert torch.equal(staged[t], expect), (split, r, t)
                assert int(won[t].sum()) == len(expect)
    return (ref[1] >= 0).float().mean().item()


@pytest.mark.parametrize("seed", [0, 1])
def test_k6_split_random_rows(seed):
    """Random triangles, each tile's sequence with repeated ids and -1s."""
    rows = _k6_rows(seed, 40)
    assert _check_k6(rows, _random_ids(seed, 40, 90)) > 0.1


def test_k6_split_equal_depths_across_blocks():
    """Copies of large triangles (the same depth at every pixel) and the
    same id again, at slots that fall to different blocks: the first slot
    in walk order wins whichever block walked it, and a slot that wins
    rows of two blocks is staged by both."""
    rows = _k6_rows(3, 12, size=0.9, copies=6)          # ids 12-17 copy 0-5
    ids = torch.tensor([[17, 5, 3, 15, 5, 12, 0, 3, 17, 1, 13, 2, 14, 4, 16, 11, 9, -1],
                        [5, 17, 11, 3, 3, 15, 1, 13, 2, 16, 4, 12, 0, 14, 10, 8, 7, 5],
                        [0, 12, 6, 6, 0, 1, 13, 7, 2, 14, 8, 3, 15, 9, -1, 16, 4, 10],
                        [9, 8, 7, 6, 17, 16, 15, 14, 13, 12, 5, 4, 3, 2, 1, 0, 17, 5]],
                       dtype=torch.int32)
    assert _check_k6(rows, ids) > 0.3
    _, blocks, _ = _k6_split(rows, ids, 2)
    both = blocks[0][0].bool() & blocks[1][0].bool()
    assert bool(both.any())


def test_k6_split_with_peel_and_early_z():
    """A peel plane and the early-z bounds (indexed by the global walk
    slot), whose exits each block takes on its own partial depths; then a
    near-first stack of full-screen quads where the exits end most walks."""
    rows = _k6_rows(4, 50, size=0.6)
    ids = _random_ids(4, 50, 130)
    peel = torch.rand((H, W), generator=torch.Generator().manual_seed(4)) * 0.6 + 0.4
    szb = early_z_bounds(rows, ids, NONE, TX, W, H)
    assert _check_k6(rows, ids, peel=peel) > 0.2
    assert _check_k6(rows, ids, peel=peel, szb=szb) > 0.2
    quads = []
    for i in range(24):
        z, sz = 0.9 - 0.8 * i / 23, 1.2 - 0.01 * i
        quads += [[-sz, -sz, z, 1], [sz, -sz, z, 1], [-sz, sz, z, 1],
                  [-sz, sz, z, 1], [sz, -sz, z, 1], [sz, sz, z, 1]]
    setup, _ = _setup(quads)
    g = torch.Generator().manual_seed(5)
    stack = torch.cat([torch.cat([setup["row16"], torch.rand((48, 48), generator=g)], 1),
                       rows]).contiguous()
    ids = torch.cat([torch.arange(48)[None].expand(4, 48),
                     _random_ids(5, 50, 80) + 48], 1).to(torch.int32)
    ids = torch.where(ids == 47, -1, ids)
    szb = early_z_bounds(stack, ids, NONE, TX, W, H)
    d, _ = split_walk(stack, ids, TX, W, H, 8, szb=szb)
    assert bool((szb[:, 64:] <= d.amin((1, 2))[:, None]).any())
    assert _check_k6(stack, ids, szb=szb) > 0.9


# ---- K7


def _k7_split(rows, ids, split):
    """The K7 kernel in plain PyTorch: split_walk with K7's step, the
    winning slot mapped to its id after the combine, K7's epilogue."""
    n_tiles = ids.shape[0]
    depth, slot = split_walk(rows, ids, TX, W, H, split, step=mxu_walk_step)
    won = slot != NO_SLOT
    win = torch.gather(ids, 1, torch.where(won, slot, 0).reshape(n_tiles, -1))
    win = torch.where(won, win.reshape(slot.shape), -1)
    xn, yn = _tile_ndc(n_tiles, TX, W, H, "cpu")
    return torch.stack([_untile(p, TX, TY) for p in mxu_planes(rows, win, depth, xn, yn)])


def _check_k7(rows, ids):
    """_k7_split at 2, 4 and 8 blocks equals raster_mxu_reference bit for
    bit; returns the covered share."""
    ref = raster_mxu_reference(rows, ids.contiguous(),
                               torch.zeros(ids.shape[0], dtype=torch.int32), NONE,
                               TX, W, H)
    for split in (2, 4, 8):
        out = _k7_split(rows, ids, split)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), split
    return (ref[1] >= 0).float().mean().item()


@pytest.mark.parametrize("seed", [0, 1])
def test_k7_split_random_rows(seed):
    """Random triangles (perspective, eye-plane crossings: zero-area and
    degenerate ones too, K7 has no valid flag), repeated ids and -1s."""
    rows = _mxu_rows(_clip(seed, 40), seed)
    assert _check_k7(rows, _random_ids(seed, 40, 90)) > 0.1


def test_k7_split_ties_and_zero_rows():
    """Copies of large triangles at slots of different blocks (equal
    depths: the first slot in walk order wins, and its id, though the
    same id stands at other slots too), -1 slots (zero rows) in every
    block, and a tile of -1s only."""
    rows = _mxu_rows(_clip(3, 12, size=0.9), 3)
    rows = torch.cat([rows, rows[:6]]).contiguous()      # ids 12-17 copy 0-5
    ids = torch.tensor([[17, 5, 3, 15, 5, 12, 0, 3, 17, 1, 13, 2, 14, 4, 16, 11, 9, -1],
                        [5, 17, 11, 3, 3, 15, 1, 13, -1, -1, 4, 12, 0, 14, 10, 8, 7, 5],
                        [-1] * 18,
                        [9, 8, 7, 6, 17, 16, 15, 14, 13, 12, 5, 4, 3, 2, 1, 0, 17, 5]],
                       dtype=torch.int32)
    assert _check_k7(rows, ids) > 0.3


def _k7_kept(rows, col):
    """(n_tiles, 8): the plain K7 raster of the entries col (n_tiles,)
    alone keeps a pixel of warp w's 32 x 16 rectangle."""
    out = raster_mxu_reference(rows, col[:, None].to(torch.int32).contiguous(),
                               torch.ones(col.shape[0], dtype=torch.int32), NONE, TX, W, H)
    t = tile_image(out[1], TX, TY) >= 0
    return t.reshape(-1, 2, 16, 4, 32).any(4).any(2).reshape(-1, 8)


def _check_k7_reject(rows, ids):
    """Wherever K7's reject skips a slot's entry for a warp, the plain K7
    raster of that entry alone keeps no pixel of the warp's rectangle.
    Returns the (rejected, kept) (entry, warp) counts."""
    rects = warp_rects(TX, ids.shape[0], W, H)
    rejected = kept_n = 0
    for k in range(ids.shape[1]):
        col = ids[:, k]
        kept = _k7_kept(rows, col)
        r = rows[col.clamp(min=0).long()] * (col >= 0)[:, None].to(rows.dtype)
        rej = warp_rect_reject(r[:, None, :], *rects, scissor=False, form="dot")
        valid = (col >= 0)[:, None]
        assert not bool((rej & kept).any()), f"slot {k}: K7's reject drops kept pixels"
        rejected += int((rej & valid).sum())
        kept_n += int((kept & valid).sum())
    return rejected, kept_n


# screen coordinates (pixels): pixel centres, or free f32 values
PX = st.one_of(st.integers(-40, W + 40).map(lambda p: (p, True)),
               st.floats(-60.0, W + 60.0, width=32).map(lambda p: (p, False)))
PY = st.one_of(st.integers(-20, H + 20).map(lambda p: (p, True)),
               st.floats(-30.0, H + 30.0, width=32).map(lambda p: (p, False)))
VERTEX = st.tuples(PX, PY, st.floats(0.0, 1.0, width=32),
                   st.sampled_from([1.0, 1.0, 0.5, 2.5, -0.75]))


def _ndc(p, scale):
    return np.float32((np.float32(p) + np.float32(0.5)) * np.float32(scale)
                      - np.float32(1.0))


def _clip_vertex(v):
    (px, cx_), (py, cy_), z, w = v
    x = _ndc(px, CX) if cx_ else np.float32(np.float32(px) * np.float32(CX) - 1)
    y = _ndc(py, CY) if cy_ else np.float32(np.float32(py) * np.float32(CY) - 1)
    return [x * w, y * w, z * abs(w), w]


@settings(max_examples=60, deadline=None)
@given(tris=st.lists(st.tuples(VERTEX, VERTEX, VERTEX), min_size=1, max_size=6))
def test_k7_reject_never_drops_a_kept_pixel(tris):
    """Hypothesis triangles: pixel-centre and free vertices, perspective
    w, eye-plane crossings (w < 0)."""
    rows = _mxu_rows([_clip_vertex(v) for t in tris for v in t], 0)
    ids = torch.arange(len(tris), dtype=torch.int32)[None].expand(TX * TY, len(tris))
    _check_k7_reject(rows, ids)


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


def _edge_rows(rows, k):
    """rows with only edge k kept (the others zero: never rejected)."""
    out = torch.zeros_like(rows)
    out[:, 3 * k:3 * k + 3] = rows[:, 3 * k:3 * k + 3]
    return out


def test_k7_reject_with_edges_through_rectangle_corners():
    """The corner triangles: the reject drops no pixel the plain K7 raster
    keeps, and wherever it rejects an edge for a warp of tile 0, that
    edge's exact value (its f32 coefficients and corners, summed exactly)
    is below 0 at all four corners, so on the whole rectangle.  Without
    the margin the corner's rounding noise would reject edges that are
    exactly 0 there."""
    rows = _mxu_rows(_corner_triangles(), 1)
    T = rows.shape[0]
    rejected, kept = _check_k7_reject(rows, torch.arange(T, dtype=torch.int32)[None]
                                      .expand(TX * TY, T))
    assert kept > 0 and rejected > 0, (rejected, kept)
    x0, x1, y0, y1 = (r[0] for r in warp_rects(TX, TX * TY, W, H))
    corners = [(float(x[w]), float(y[w])) for w in range(8) for x in (x0, x1)
               for y in (y0, y1)]
    n_rejected = 0
    for k in range(3):
        rej = warp_rect_reject(_edge_rows(rows, k)[:, None, :], x0, x1, y0, y1,
                               scissor=False, form="dot")              # (T, 8)
        a, b, c = (rows[:, 3 * k + j].tolist() for j in range(3))
        for t, w in torch.nonzero(rej).tolist():
            exact = [math.fsum((a[t] * x, b[t] * y, c[t]))
                     for x, y in corners[4 * w:4 * w + 4]]
            assert max(exact) < 0, (k, t, w, exact)
            n_rejected += 1
    assert n_rejected > rows.shape[0]


def test_k7_reject_corner_in_k7_form(monkeypatch):
    """With the margin set to 0 the reject rests on the corner value
    alone.  Computed in K7's form, fma(b, y, a*x) + c, that value bounds
    every pixel's value of the edge in the same form (rounding is
    monotone), so even then a rejected edge is below 0 at all 512 pixels
    of the warp's rectangle, as the walk evaluates them: the corner
    triangles' edges, rounding noise around 0 there, show a corner taken
    in another form (K1's fma(a, x, b*y) + c) to be off."""
    monkeypatch.setattr(raster_depth_cuda, "REJECT_REL", 0.0)
    monkeypatch.setattr(raster_depth_cuda, "REJECT_ABS", 0.0)
    rows = _mxu_rows(_corner_triangles(), 2)
    xn, yn = _tile_ndc(TX * TY, TX, W, H, "cpu")
    xs = xn[0, 0].reshape(4, 32)                     # warp column band -> its xn
    ys = yn[0, :, 0].reshape(2, 16)
    x0, x1, y0, y1 = (r[0] for r in warp_rects(TX, TX * TY, W, H))
    n_rejected = 0
    for k in range(3):
        rej = warp_rect_reject(_edge_rows(rows, k)[:, None, :], x0, x1, y0, y1,
                               scissor=False, form="dot")
        a, b, c = (rows[:, 3 * k + j] for j in range(3))
        for w in range(8):
            v = _dot_plane(a[:, None, None], b[:, None, None], c[:, None, None],
                           xs[w % 4][None, None, :], ys[w // 4][None, :, None])
            worst = v.amax((1, 2))                   # (T,)
            assert not bool((rej[:, w] & (worst >= 0)).any()), (k, w)
            n_rejected += int(rej[:, w].sum())
    assert n_rejected > rows.shape[0]


def test_k7_reject_on_collapsed_terrain_cells():
    """The main view of a stress frame whose terrain morphs past its
    farthest vertex, through raster_mxu_inputs: collapsed (zero-area)
    cells, which K7 walks (it has no valid flag), cover pixels by
    rounding noise.  The reject skips most (entry, warp) pairs and none
    that keeps a pixel."""
    ctx, cam, params, mk = stress_scene(
        width=W, height=H, terrain_n=40, sphere_detail=6, grid=(2, 1),
        n_point_lights=4, skybox=False, bin_capacity=256, big_capacity=16,
        bin_max_span=8, use_pallas=True, texture_filter="mip_half", shadow_res=128,
        shadow_bin_capacity=128, enable_shadows=False, device="cpu")
    rl = mk(0.3)
    rl.draws[0]["morph"] = np.float32([0.5, 1.0])     # every cell collapses
    s = to_torch(make_sceneset(cam, params, point_lights=rl.point_lights,
                               spot_lights=rl.spot_lights), "cpu")
    d = to_torch(ctx.frame_draws(rl, cam), "cpu")
    cfg = ctx.config
    state = ctx.device_state("cpu")
    ex, uv, clip, wn, _, _ = frame_mod._vertex_stage(cfg, state, d, s)
    setup, bins, counts, big, _ = frame_mod._bin_stage(cfg, ex, clip)
    assert (cfg.tiles_x, cfg.padded_width, cfg.padded_height) == (TX, W, H)
    assert int(counts.max()) > 64
    inp = raster_mxu_inputs(setup, bins, big, counts, ex["tris"], uv, wn, d["tri_mat"],
                            state["materials"], TX, W, H)
    ids = _entry_ids(inp["bins"], inp["big_ids"])
    rejected, kept = _check_k7_reject(inp["rows"], ids)
    assert kept > 0 and rejected > kept, (rejected, kept)
    # and the split walks give the full walk's planes on this frame
    assert _check_k7(inp["rows"], ids.to(torch.int32)) > 0.2
