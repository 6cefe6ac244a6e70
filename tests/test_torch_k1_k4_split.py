"""K1's split walk and edges-only reject, and K4's no-op reject, through
their plain twins (CPU).

The K1 kernel (csrc/raster_shade.cu) splits each tile's walk over a
cluster of 4 blocks (2 on large frames with shallow bins): block r walks the slots g = r
(mod split) of the tile's sequence, with its own early-z exit, carrying
its partial (depth, slot); the combine takes the largest depth and,
among equal ones, the smallest slot.  `ops/raster_cuda.split_walk` is
that walk in plain PyTorch (the kernel's per-thread exit and chunking
included), built from `walk_step`, the plain K1's own step; the tests
hold it against the full walk `raster_shade_reference`.  K1's warps
skip the entries that `warp_rect_reject(..., scissor=False)` rejects; the tests hold that
against the plain raster of each entry alone.  K4 (csrc/raster_blend.cu)
skips an entry for a warp where `blend_reject` says its terms are exact
no-ops there; the tests hold that against the plain accumulation."""

import numpy as np
import pytest
import torch

from datum_tpu_torch.convert import to_torch
from datum_tpu_torch.ops import raster as raster_ops
from datum_tpu_torch.ops.raster import tile_image
from datum_tpu_torch.ops.raster_blend_cuda import (blend_inputs, blend_reject,
                                                   raster_blend_reference)
from datum_tpu_torch.ops.raster_cuda import (NO_SLOT, _entry_ids, _plane, _tile_ndc,
                                             early_z_bounds, raster_shade_reference,
                                             split_walk)
from datum_tpu_torch.ops.raster_depth_cuda import warp_rect_reject, warp_rects
from datum_tpu_torch.render import frame as frame_mod
from datum_tpu_torch.render.types import make_sceneset
from datum_tpu_torch.scenes import stress_scene

W, H, TX, TY = 256, 64, 2, 2          # 4 tiles of 32 x 128


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread (many small ops; several test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_split(rows, ids, tiles_x, width, height, peel=None, szb=None):
    """split_walk at 2, 4 and 8 blocks equals the full walk's depth and
    winning id, bit for bit; returns the covered share."""
    full = raster_shade_reference(rows, ids.to(torch.int32).contiguous(),
                                  torch.zeros(ids.shape[0], dtype=torch.int32),
                                  torch.zeros(0, dtype=torch.int32), tiles_x, width,
                                  height, peel=peel)
    n_tiles = ids.shape[0]
    fd = tile_image(full[0], tiles_x, n_tiles // tiles_x)
    fid = tile_image(full[1], tiles_x, n_tiles // tiles_x)
    for split in (2, 4, 8):
        depth, slot = split_walk(rows, ids, tiles_x, width, height, split, peel, szb)
        won = slot != NO_SLOT
        wid = torch.gather(ids.long(), 1, torch.where(won, slot, 0).reshape(n_tiles, -1))
        wid = torch.where(won, wid.reshape(slot.shape), -1).to(torch.float32)
        assert torch.equal(depth.view(torch.int32), fd.view(torch.int32)), split
        assert torch.equal(wid, fid), split
    return (fid >= 0).float().mean().item()


def _k1_rows(row16):
    """K1's (T, 64) rows from the setup's row16 (the walk reads 0-12)."""
    return torch.cat([row16, torch.zeros((row16.shape[0], 48))], 1).contiguous()


def _random_rows(seed, n_tris, size=0.3, ylim=None):
    """K1 rows of n_tris random triangles on the 256 x 64 viewport, a
    fifth with perspective w and a few crossing the eye plane."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-1.1, 1.1, (n_tris, 1, 2))
    xy = c + rng.uniform(-size, size, (n_tris, 3, 2))
    z = rng.uniform(0.05, 0.95, (n_tris, 3, 1))
    w = np.where(rng.rand(n_tris, 1, 1) < 0.2, rng.uniform(-0.3, 2.0, (n_tris, 3, 1)), 1.0)
    clip = torch.tensor(np.concatenate([xy * w, z * np.abs(w), w], -1).reshape(-1, 4),
                        dtype=torch.float32)
    tris = torch.arange(3 * n_tris, dtype=torch.int32).reshape(-1, 3)
    setup = raster_ops.triangle_setup(clip, tris, W, H, TX, TY, ylim=ylim)
    return _k1_rows(setup["row16"])


def _random_ids(seed, n_rows, E, n_tiles=TX * TY):
    """A walk table (n_tiles, E) of random ids with repeats and -1s."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(-1, n_rows, (n_tiles, E))
    return torch.tensor(ids, dtype=torch.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_walk_random_rows(seed):
    """Random triangles, each tile's sequence with repeated ids and -1s."""
    rows = _random_rows(seed, 40)
    ids = _random_ids(seed, 40, 90)
    assert _check_split(rows, ids, TX, W, H) > 0.1


def test_split_walk_equal_depths_across_blocks():
    """Copies of one triangle (the same depth at every pixel) and the
    same id again, at slots that fall to different blocks: the first in
    walk order wins, whichever block walked it."""
    rows = _random_rows(3, 12, size=0.9)
    copies = torch.cat([rows, rows[:6], rows[:6]]).contiguous()      # ids 12-23 copy 0-5
    ids = torch.tensor([[17, 5, 3, 15, 5, 12, 0, 3, 17, 23, 1, 13, 2, 14, 4, 16, 11, 9],
                        [5, 17, 23, 11, 3, 3, 15, 1, 13, 2, 16, 4, 12, 0, 14, 10, 8, 7],
                        [0, 12, 18, 6, 6, 0, 1, 19, 13, 7, 2, 20, 14, 8, 21, 3, 15, 9],
                        [9, 8, 7, 6, 23, 22, 21, 20, 19, 18, 17, 16, 15, 14, 13, 12, 5, 4]],
                       dtype=torch.int32)
    assert _check_split(copies, ids, TX, W, H) > 0.3


def test_split_walk_with_peel_and_early_z():
    """A peel plane (fragments must lie behind it) and the early-z
    bounds, whose exits each block takes on its own partial depths; also
    a near-first depth stack where the exits end most walks."""
    rows = _random_rows(4, 50, size=0.6)
    ids = _random_ids(4, 50, 130)
    peel = torch.rand((H, W), generator=torch.Generator().manual_seed(4)) * 0.6 + 0.4
    szb = early_z_bounds(rows, ids, torch.zeros(0, dtype=torch.int32), TX, W, H)
    assert _check_split(rows, ids, TX, W, H, peel=peel, szb=szb) > 0.2
    # full-screen quads from near (0.9) to far, then small triangles
    quads = []
    for i in range(24):
        z, sz = 0.9 - 0.8 * i / 23, 1.2 - 0.01 * i
        quads += [[-sz, -sz, z, 1], [sz, -sz, z, 1], [-sz, sz, z, 1],
                  [-sz, sz, z, 1], [sz, -sz, z, 1], [sz, sz, z, 1]]
    clip = torch.tensor(quads, dtype=torch.float32)
    setup = raster_ops.triangle_setup(clip, torch.arange(len(quads), dtype=torch.int32)
                                      .reshape(-1, 3), W, H, TX, TY)
    stack = torch.cat([_k1_rows(setup["row16"]), rows]).contiguous()
    ids = torch.cat([torch.arange(48)[None].expand(4, 48),
                     _random_ids(5, 50, 80) + 48], 1).to(torch.int32)
    ids = torch.where(ids == 47, -1, ids)
    szb = early_z_bounds(stack, ids, torch.zeros(0, dtype=torch.int32), TX, W, H)
    d, _ = split_walk(stack, ids, TX, W, H, 8, szb=szb)
    assert bool((szb[:, 64:] <= d.amin((1, 2))[:, None]).any())
    assert _check_split(stack, ids, TX, W, H, szb=szb) > 0.9


def _k1_kept(rows, col):
    """(n_tiles, 8): K1's plain raster of the entries col (n_tiles,)
    alone keeps a pixel of warp w's 32 x 16 rectangle."""
    out = raster_shade_reference(rows, col[:, None].to(torch.int32).contiguous(),
                                 torch.zeros(col.shape[0], dtype=torch.int32),
                                 torch.zeros(0, dtype=torch.int32), TX, W, H)
    t = tile_image(out[1], TX, TY) >= 0
    return t.reshape(-1, 2, 16, 4, 32).any(4).any(2).reshape(-1, 8)


def _check_k1_reject(rows, ids):
    """Wherever K1's reject (edges only) skips a slot's entry for a warp,
    the plain raster of that entry alone keeps no pixel of the warp's
    rectangle.  Returns (rejected, kept, rejected by the scissor too but
    kept) (entry, warp) counts."""
    rects = warp_rects(TX, ids.shape[0], W, H)
    rejected = kept_n = trap = 0
    for k in range(ids.shape[1]):
        col = ids[:, k]
        kept = _k1_kept(rows, col)
        r = rows[col.clamp(min=0).long()] * (col >= 0)[:, None].to(rows.dtype)
        rej = warp_rect_reject(r[:, None, :], *rects, scissor=False)
        valid = (col >= 0)[:, None] & (r[:, None, 12] > 0)
        assert not bool((rej & kept).any()), f"slot {k}: K1's reject drops kept pixels"
        rejected += int((rej & valid).sum())
        kept_n += int((kept & valid).sum())
        trap += int((warp_rect_reject(r[:, None, :], *rects) & kept & valid).sum())
    return rejected, kept_n, trap


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_reject_ignores_the_scissor_slots(seed):
    """Rows whose slots 14-15 carry a narrow y scissor (a band of 4 rows)
    that K1 must not apply: the edges-only reject keeps every entry that
    K1 keeps, where a reject that read the scissor would drop some."""
    lo = torch.full((30,), float(np.float32(-0.3)))
    rows = _random_rows(seed, 30, size=0.5, ylim=(lo, lo + 4 * 2.0 / H))
    assert bool((rows[:, 15] < 8).all())
    ids = torch.arange(30, dtype=torch.int32)[None].expand(TX * TY, 30)
    rejected, kept, trap = _check_k1_reject(rows, ids)
    assert rejected > 0 and kept > 0 and trap > 0, (rejected, kept, trap)


def test_k1_reject_on_collapsed_terrain_cells():
    """The main view of a stress frame whose terrain morphs past its
    farthest vertex: collapsed (zero-area) cells cover pixels by rounding
    noise.  The reject skips most (entry, warp) pairs and none that
    keeps a pixel."""
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
    ex, _, clip, _, _, _ = frame_mod._vertex_stage(cfg, ctx.device_state("cpu"), d, s)
    setup, bins, counts, big, _ = frame_mod._bin_stage(cfg, ex, clip)
    assert (cfg.tiles_x, cfg.padded_width, cfg.padded_height) == (TX, W, H)
    assert int(counts.max()) > 64
    rows = _k1_rows(setup["row16"])
    rejected, kept, _ = _check_k1_reject(rows, _entry_ids(bins, big))
    assert kept > 0 and rejected > kept, (rejected, kept)


# ---- K4

# entries with edge 0 below 0 everywhere whose invisible pixels' terms
# are NaN in the plain version: s = 1e-38 (l0 and l1 overflow); s = 1
# with red coefficients whose sum overflows (cr = inf); a NaN depth
# coefficient (wk = NaN)
BAD_ROWS = ({2: -100.0, 5: 100.0, 8: 1e-38, 11: 0.5},
            {2: -1.0, 5: 1.0, 8: 1.0, 11: 0.5, 22: -3e38, 26: 3e38},
            {2: -1.0, 5: 1.0, 8: 1.0, 9: float("nan"), 11: 0.5})


def _blend_case(seed, n_tris=60):
    """K4 inputs on the 256 x 64 viewport: random triangles (a fifth in
    perspective, some crossing the eye plane, so s crosses 0 on screen),
    two triangles whose horizon line (s = 0) crosses warp rectangles, and
    the BAD_ROWS entries last, every entry in every tile."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-1.1, 1.1, (n_tris, 1, 2))
    xy = c + rng.uniform(-0.25, 0.25, (n_tris, 3, 2))
    z = rng.uniform(0.05, 0.95, (n_tris, 3, 1))
    w = np.where(rng.rand(n_tris, 1, 1) < 0.2, rng.uniform(-0.3, 2.0, (n_tris, 3, 1)), 1.0)
    verts = np.concatenate([xy * w, z * np.abs(w), w], -1).reshape(-1, 4)
    # s = 0 where w = 0: vertices with w = 1, 1, -1 put it across the viewport
    horizon = [[0.2, 0.1, 0.5, 1.0], [0.5, 0.3, 0.5, 1.0], [-0.6, -0.2, 0.4, -1.0],
               [-0.9, 0.8, 0.5, 1.0], [-0.7, 0.9, 0.5, 1.0], [0.3, -0.5, 0.4, -1.0]]
    clip = torch.tensor(np.concatenate([verts, horizon]), dtype=torch.float32)
    T = clip.shape[0] // 3
    tris = torch.arange(3 * T, dtype=torch.int32).reshape(-1, 3)
    setup = raster_ops.triangle_setup(clip, tris, W, H, TX, TY)
    g = torch.Generator().manual_seed(seed)
    n_v = clip.shape[0]
    inp = blend_inputs(setup, torch.zeros((TX * TY, 0), dtype=torch.int32),
                       torch.arange(T + len(BAD_ROWS), dtype=torch.int32),
                       torch.zeros(TX * TY),
                       tris, torch.rand((n_v, 2), generator=g),
                       torch.rand((n_v, 4), generator=g),
                       torch.rand((H, W), generator=g) * 0.3, TX, W, H, "per_tri",
                       torch.rand((H, W), generator=g) * 0.5 + 0.5,
                       torch.rand(T, generator=g) < 0.5, torch.rand(T, generator=g) < 0.5)
    bad = torch.zeros((len(BAD_ROWS), 36))
    bad[:, 12] = 1.0
    bad[:, 22:34] = 0.5
    for i, row in enumerate(BAD_ROWS):
        for k, v in row.items():
            bad[i, k] = v
    inp["rows"] = torch.cat([inp["rows"], bad]).contiguous()
    return inp


def _single(inp, t):
    """The plain K4 planes of entry t alone (from the zero state)."""
    return raster_blend_reference(**dict(
        inp, bins=torch.zeros((TX * TY, 0), dtype=torch.int32),
        big_ids=torch.tensor([t], dtype=torch.int32)))


def _by_warp(t):
    """(..., n_tiles, 32, 128) tiled values -> (..., n_tiles, 16, 256),
    by K4 warp (32 x 8; w = 4 * row band + column band)."""
    lead = t.shape[:-2]
    return t.reshape(*lead, 4, 8, 4, 32).transpose(-3, -2).reshape(*lead, 16, 256)


def _warp_planes(planes):
    """(5, n_tiles, 16, 256): K4's planes (5, H, W) by warp."""
    return _by_warp(torch.stack([tile_image(p, TX, TY) for p in planes]))


def _k4_skips(inp):
    """(T, n_tiles, 16) K4's reject over every entry and warp."""
    rects = warp_rects(TX, TX * TY, W, H, warp_h=8)
    return blend_reject(inp["rows"][:, None, None, :], *rects)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k4_reject_skips_only_no_ops(seed):
    """Every (entry, warp) pair the reject skips: the entry's step there,
    from the zero state, leaves ar, ag, ab, aw at +0 and rv at 1, bit for
    bit.  A step from any state is then a no-op (ar = fma(cr, +0, ar) =
    ar with cr finite, rv * 1), since a non-finite cr or wk shows as NaN
    from the zero state.  The reject skips most pairs of entries outside
    a warp, and none where s crosses 0 in the rectangle or of BAD_ROWS."""
    inp = _blend_case(seed)
    skips = _k4_skips(inp)
    T = inp["rows"].shape[0]
    rects = warp_rects(TX, TX * TY, W, H, warp_h=8)
    outside = warp_rect_reject(inp["rows"][:, None, None, :16], *rects, scissor=False)
    zero, one = torch.zeros(()).view(torch.int32), torch.ones(()).view(torch.int32)
    xn, yn = _tile_ndc(TX * TY, TX, W, H, "cpu")
    crossings = 0
    for t in range(T):
        planes = _warp_planes(_single(inp, t)).view(torch.int32)
        noop = (planes[:4] == zero).all(0).all(-1) & (planes[4] == one).all(-1)
        assert not bool((skips[t] & ~noop).any()), f"entry {t}: a skipped step moves a value"
        r = inp["rows"][t]
        s = (_plane(r[0], r[1], r[2], xn, yn) + _plane(r[3], r[4], r[5], xn, yn)
             + _plane(r[6], r[7], r[8], xn, yn))
        s = _by_warp(s)
        cross = (s.amin(-1) <= 0) & (s.amax(-1) > 0)
        assert not bool((skips[t] & cross).any()), f"entry {t}: skipped across s = 0"
        crossings += int((cross & outside[t]).sum())
    assert crossings > 0
    for t in range(T - len(BAD_ROWS), T):            # walked everywhere
        assert not bool(skips[t].any()) and bool(torch.isnan(_single(inp, t)).any()), t
    assert int(skips.sum()) > int(outside.sum()) // 2


def test_k4_reject_keeps_the_walk_bit_for_bit():
    """The whole walk with the entries the reject skips on every warp of a
    tile taken out of that tile's sequence: the same bits as the full
    walk (NaNs where the full walk has them)."""
    inp = _blend_case(5)
    full = raster_blend_reference(**inp)
    skips = _k4_skips(inp).all(-1)                    # (T, n_tiles)
    T = inp["rows"].shape[0]
    ids = torch.arange(T)[None].expand(TX * TY, T)
    kept = torch.where(skips.T, -1, ids).to(torch.int32).contiguous()
    assert int(skips.sum()) > T
    cut = raster_blend_reference(**dict(inp, bins=kept,
                                        big_ids=torch.zeros(0, dtype=torch.int32)))
    nan = torch.isnan(full)
    assert bool(nan.any()) and torch.equal(nan, torch.isnan(cut))
    assert torch.equal(full[~nan].view(torch.int32), cut[~nan].view(torch.int32))
