"""Triangle setup, tile binning and the scan raster (counterpart of
datum_tpu/ops/raster.py).

2D-homogeneous (Olano-Greer) edge functions, as in the JAX package:

    M  = [[x0, x1, x2], [y0, y1, y2], [w0, w1, w2]]   (clip coords)
    e  = adj(M) @ (x_ndc, y_ndc, 1)
    inside <=> all e_i >= 0 after the winding sign fix, and sum(e) > 0

Binning builds per-tile triangle lists by pair expansion + sort.  The
sort keys pack (tile | depth band | triangle) and are unique, so any
correct sort reproduces the JAX bins exactly; the port builds them as
int64, which also covers the key widths where the JAX package switches
to uint32.

The scan raster (`raster`, `resolve_barycentrics`, `rasterize`) is the
JAX package's XLA raster, what `use_pallas=False` runs: plain PyTorch on
every device.
"""

from __future__ import annotations

import torch

from .common import TILE_H, TILE_W, fma

BIN_MAX_SPAN = 16  # max tiles a binned triangle may cover; larger -> big list

# float -> int32 conversions saturate (as XLA's convert does) instead of
# running into undefined behaviour for far-off-screen vertices
_I32_SAT = 2.0e9


def _floor_i32(x):
    return torch.floor(torch.clamp(x, -_I32_SAT, _I32_SAT)).to(torch.int32)


def adjugate3(m):
    """Adjugate of (..., 3, 3) matrices: adj(M) @ M = det(M) * I."""
    a = m
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    return torch.stack(
        [torch.stack([c00, c10, c20], -1),
         torch.stack([c01, c11, c21], -1),
         torch.stack([c02, c12, c22], -1)], dim=-2)


def triangle_setup_comps(comps, shared, width, height, tiles_x, tiles_y,
                         tri_valid=None, cull=0, max_span=BIN_MAX_SPAN,
                         ylim=None):
    """SoA triangle setup core.

    comps: dict of (T,) f32 tensors x0,y0,z0,w0,x1,...,w2 (clip coords
    per corner); shared: (T,) bool degenerate-id mask.

    Returns the setup dict: bbox_soa (tx0,ty0,tx1,ty1), valid (binned)
    and big (T,), row16 (T,16) kernel rows [adj*sgn 0-8, zs 9-11, valid
    12, id 13 (set per entry), y scissor 14-15], zbound (T,).

    ylim: optional (ylo, yhi) NDC y scissor per triangle (tensors that
    broadcast to (T,)), which the depth-only raster applies per pixel as
    ylo <= yn < yhi; None leaves it open at (-8, 8)."""
    x0, y0, z0, w0 = comps["x0"], comps["y0"], comps["z0"], comps["w0"]
    x1, y1, z1, w1 = comps["x1"], comps["y1"], comps["z1"], comps["w1"]
    x2, y2, z2, w2 = comps["x2"], comps["y2"], comps["z2"], comps["w2"]

    a00 = y1 * w2 - w1 * y2
    a01 = w1 * x2 - x1 * w2
    a02 = x1 * y2 - y1 * x2
    a10 = w0 * y2 - y0 * w2
    a11 = x0 * w2 - w0 * x2
    a12 = y0 * x2 - x0 * y2
    a20 = y0 * w1 - w0 * y1
    a21 = w0 * x1 - x0 * w1
    a22 = x0 * y1 - y0 * x1
    det = x0 * a00 + y0 * a01 + w0 * a02

    # conservative frustum reject: all vertices outside one clip plane
    out = (((x0 > w0) & (x1 > w1) & (x2 > w2))
           | ((x0 < -w0) & (x1 < -w1) & (x2 < -w2))
           | ((y0 > w0) & (y1 > w1) & (y2 > w2))
           | ((y0 < -w0) & (y1 < -w1) & (y2 < -w2))
           | ((z0 < 0) & (z1 < 0) & (z2 < 0))
           | ((z0 > w0) & (z1 > w1) & (z2 > w2)))
    # relative degeneracy test (64 ulps of the determinant's terms)
    det_mag = (torch.abs(x0 * a00) + torch.abs(y0 * a01) + torch.abs(w0 * a02))
    degenerate = shared | (torch.abs(det) <= 64.0 * 1.1920929e-07 * det_mag)
    valid = ~(out | degenerate)
    if cull > 0:
        valid = valid & (det > 0)
    elif cull < 0:
        valid = valid & (det < 0)
    if tri_valid is not None:
        valid = valid & tri_valid

    # screen bbox (only meaningful when all w comfortably positive)
    w_ok = (w0 > 1e-6) & (w1 > 1e-6) & (w2 > 1e-6)
    one = torch.ones_like(w0)
    iw0 = 1.0 / torch.where(w_ok, w0, one)
    iw1 = 1.0 / torch.where(w_ok, w1, one)
    iw2 = 1.0 / torch.where(w_ok, w2, one)
    sx0, sx1, sx2 = x0 * iw0, x1 * iw1, x2 * iw2
    sy0, sy1, sy2 = y0 * iw0, y1 * iw1, y2 * iw2
    sxmin = (torch.minimum(torch.minimum(sx0, sx1), sx2) * 0.5 + 0.5) * width
    sxmax = (torch.maximum(torch.maximum(sx0, sx1), sx2) * 0.5 + 0.5) * width
    symin = (torch.minimum(torch.minimum(sy0, sy1), sy2) * 0.5 + 0.5) * height
    symax = (torch.maximum(torch.maximum(sy0, sy1), sy2) * 0.5 + 0.5) * height
    tx0 = torch.clamp(_floor_i32(sxmin / TILE_W), 0, tiles_x - 1)
    tx1 = torch.clamp(_floor_i32(sxmax / TILE_W), 0, tiles_x - 1)
    ty0 = torch.clamp(_floor_i32(symin / TILE_H), 0, tiles_y - 1)
    ty1 = torch.clamp(_floor_i32(symax / TILE_H), 0, tiles_y - 1)

    onscreen = (sxmax >= 0) & (sxmin < width) & (symax >= 0) & (symin < height)
    valid = valid & (w_ok & onscreen | ~w_ok)

    span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    big = valid & (~w_ok | (span > max_span))
    binned = valid & ~big

    # depth-plane coefficients: depth = sum_k e_k * z_k / det
    idet = 1.0 / torch.where(torch.abs(det) < 1e-30, one, det)
    zs0 = (a00 * z0 + a10 * z1 + a20 * z2) * idet
    zs1 = (a01 * z0 + a11 * z1 + a21 * z2) * idet
    zs2 = (a02 * z0 + a12 * z1 + a22 * z2) * idet
    sgn = torch.sign(det)
    if ylim is None:
        ylo, yhi = torch.full_like(det, -8.0), torch.full_like(det, 8.0)
    else:
        ylo, yhi = (torch.broadcast_to(torch.as_tensor(v, dtype=det.dtype,
                                                       device=det.device),
                                       det.shape) for v in ylim)
    val_f = valid | big   # kernel-visible validity (slot 12)
    row16 = torch.stack([
        a00 * sgn, a01 * sgn, a02 * sgn,
        a10 * sgn, a11 * sgn, a12 * sgn,
        a20 * sgn, a21 * sgn, a22 * sgn,
        zs0, zs1, zs2,
        val_f.to(det.dtype), torch.zeros_like(det), ylo, yhi,
    ], dim=-1)

    # conservative screen-depth upper bound (see the JAX package): the
    # max vertex z/w padded by ~32 ulps; behind-eye triangles get 1.0
    zb = torch.maximum(torch.maximum(z0 * iw0, z1 * iw1), z2 * iw2)
    zb = zb + torch.abs(zb) * 4e-6 + 1e-9
    zbound = torch.where(w_ok & torch.isfinite(zb), torch.clamp(zb, 0.0, 1.0),
                         one)

    # the AoS adjugate, determinant and corner depths the scan raster,
    # the deferred resolve, K7's rows and the XLA WBOIT read
    adj = torch.stack([torch.stack([a00, a01, a02], -1),
                       torch.stack([a10, a11, a12], -1),
                       torch.stack([a20, a21, a22], -1)], dim=-2)     # (T, 3, 3)
    zc = torch.stack([z0, z1, z2], -1)
    return dict(row16=row16, zbound=zbound, bbox_soa=(tx0, ty0, tx1, ty1),
                valid=binned, big=big, adj=adj, det=det, zc=zc)


def triangle_setup(clip, tris, width, height, tiles_x, tiles_y, tri_valid=None,
                   cull=0, max_span=BIN_MAX_SPAN, ylim=None):
    """Per-triangle raster setup.

    clip: (V, 4) clip positions; tris: (T, 3) int32 vertex ids (padding
    triangles use [0,0,0] -> zero area -> culled); cull: 0 = two-sided,
    +1 = cull det<0, -1 = cull det>0."""
    t = tris.long()
    v0 = clip[t[:, 0]].T                            # (4, T)
    v1 = clip[t[:, 1]].T
    v2 = clip[t[:, 2]].T
    comps = dict(x0=v0[0], y0=v0[1], z0=v0[2], w0=v0[3],
                 x1=v1[0], y1=v1[1], z1=v1[2], w1=v1[3],
                 x2=v2[0], y2=v2[1], z2=v2[2], w2=v2[3])
    shared = ((tris[:, 0] == tris[:, 1]) | (tris[:, 1] == tris[:, 2])
              | (tris[:, 0] == tris[:, 2]))
    return triangle_setup_comps(comps, shared, width, height, tiles_x,
                                tiles_y, tri_valid=tri_valid, cull=cull,
                                max_span=max_span, ylim=ylim)


def bin_triangles(setup, n_tris, tiles_x, tiles_y, bin_capacity, big_capacity,
                  max_span=BIN_MAX_SPAN, return_overflow=False,
                  depth_prio=None, return_zub=False, tri_block=None):
    """Per-tile triangle lists via pair expansion + sort.

    Returns (bins (n_tiles, bin_capacity) i32 with -1 padding, counts
    (n_tiles,) i32, big_ids (big_capacity,) i32 with -1 padding[,
    overflow () i32][, bin_zub (n_tiles, bin_capacity) f32]).

    depth_prio: optional (T,) reverse-Z depth in [0, 1]; a 4-bit
    near-first depth band then rides the key, so a saturated bin keeps
    the nearest triangles.

    tri_block: optional (n_blocks, tiles_per_block) for a stacked atlas
    (the shadow stacks): block b owns triangle ids [b*T/n, (b+1)*T/n)
    and tiles [b*tiles_per_block, ...), and each triangle bins only into
    its own block's tile rows.  The key then packs tri % (T/n_blocks),
    as in the JAX package (so the depth band gets the same bits), and
    the block-global id is recovered from the tile at unpack.

    Everything here stays on the device: no host sync."""
    dev = setup["valid"].device
    n_tiles = tiles_x * tiles_y
    tx0, ty0, tx1, ty1 = setup["bbox_soa"]
    T = n_tris
    T_local = T
    if tri_block is not None:
        n_blocks, tiles_per_block = tri_block
        if T % n_blocks or n_tiles != n_blocks * tiles_per_block \
                or tiles_per_block % tiles_x:
            raise ValueError(f"tri_block {tri_block} does not split {T} "
                             f"triangles and {n_tiles} tiles into whole "
                             "blocks of tile rows")
        T_local = T // n_blocks
        # clamp each triangle's rows to its block: a bbox spilling into
        # the neighbour band would unpack there (the raster's y scissor
        # removes those pixels anyway)
        rows_per_block = tiles_per_block // tiles_x
        lo = (torch.arange(T, dtype=torch.int32, device=dev) // T_local
              * rows_per_block)
        hi = lo + rows_per_block - 1
        ty0 = torch.minimum(torch.maximum(ty0, lo), hi)
        ty1 = torch.minimum(torch.maximum(ty1, lo), hi)
    span_w = tx1 - tx0 + 1
    span = span_w * (ty1 - ty0 + 1)

    # pair expansion (span, T); pairs past a triangle's span are masked,
    # so the divisor clamp only guards those masked lanes
    k = torch.arange(max_span, dtype=torch.int32, device=dev)[:, None]
    sw = torch.clamp(span_w, min=1)[None, :]
    kx = k % sw
    ky = k // sw
    tile = (ty0[None, :] + ky) * tiles_x + (tx0[None, :] + kx)         # (S, T)
    pair_ok = setup["valid"][None, :] & (k < span[None, :])
    tile = torch.where(pair_ok, tile, torch.full_like(tile, n_tiles))

    # key = (tile | depth band | tri), the JAX package's bit layout
    tile_bits = max(int(n_tiles).bit_length(), 1)
    tri_bits = max(int(T_local - 1).bit_length(), 1)
    if depth_prio is None:
        dq_bits = 0
    else:
        dq_bits = min(4, 32 - tile_bits - tri_bits)
        if dq_bits < 2:
            raise ValueError(
                f"depth-prio binning needs >=2 spare key bits: "
                f"{n_tiles} tiles ({tile_bits}b) + {T} tris ({tri_bits}b)")
    if tile_bits + dq_bits + tri_bits > 32:
        raise ValueError(
            f"bin sort key overflow: {n_tiles} tiles ({tile_bits}b) + "
            f"{T} tris ({tri_bits}b) + {dq_bits} depth bits > 32")
    shift = dq_bits + tri_bits

    tri_ids = torch.arange(T, dtype=torch.int64, device=dev)[None, :] % T_local
    key = (tile.to(torch.int64) << shift) | tri_ids
    if depth_prio is not None:
        levels = (1 << dq_bits) - 1
        dq = torch.clamp(((1.0 - depth_prio) * levels).to(torch.int32),
                         0, levels)
        key = key | (dq.to(torch.int64)[None, :] << tri_bits)
    skey, _ = torch.sort(key.reshape(-1))
    sorted_tile = skey >> shift

    # starts[t] = #{keys with tile < t}
    starts = torch.searchsorted(
        sorted_tile, torch.arange(n_tiles + 1, dtype=torch.int64, device=dev))
    raw_counts = starts[1:] - starts[:-1]
    counts = torch.clamp(raw_counts, max=bin_capacity)

    # each tile's entries are consecutive in skey: read capacity keys from
    # its start; keys past the tile's run belong to a later tile (or are
    # sentinels) and become -1
    L = skey.shape[0]
    j = torch.arange(bin_capacity, dtype=torch.int64, device=dev)[None, :]
    kk = skey[torch.clamp(starts[:-1, None] + j, max=L - 1)]
    entry_ok = ((kk >> shift)
                == torch.arange(n_tiles, dtype=torch.int64, device=dev)[:, None])
    tri_unpacked = (kk & ((1 << tri_bits) - 1)).to(torch.int32)
    if tri_block is not None:
        block = torch.arange(n_tiles, dtype=torch.int32,
                             device=dev) // tiles_per_block
        tri_unpacked = tri_unpacked + block[:, None] * T_local
    bins = torch.where(entry_ok, tri_unpacked, torch.full_like(tri_unpacked, -1))
    bin_zub = None
    if return_zub:
        if depth_prio is None:
            raise ValueError("return_zub needs depth_prio")
        levels = (1 << dq_bits) - 1
        dq_e = ((kk >> tri_bits) & levels).to(torch.float32)
        bin_zub = torch.where(entry_ok, 1.0 - dq_e * (1.0 / levels),
                              torch.zeros_like(dq_e))

    # compact big-triangle ids: id[j] = index of the (j+1)-th set bit =
    # #{t: cumsum[t] <= j} (a dense compare, no data-dependent shape)
    bigm = setup["big"]
    cs = torch.cumsum(bigm.to(torch.int32), 0)
    jj = torch.arange(big_capacity, dtype=torch.int32, device=dev)
    big_ids = (cs[None, :] <= jj[:, None]).sum(1).to(torch.int32)
    big_ids = torch.where(jj < cs[-1], big_ids, torch.full_like(big_ids, -1))
    ret = (bins, counts.to(torch.int32), big_ids)
    if return_overflow:
        overflow = (torch.clamp(raw_counts - bin_capacity, min=0).sum()
                    + torch.clamp(bigm.sum() - big_capacity, min=0))
        ret = ret + (overflow.to(torch.int32),)
    if return_zub:
        ret = ret + (bin_zub,)
    return ret


def depth_plane_coefs(setup):
    """(T, 3) depth-plane coefficients sum_i adj[i, :] * (z_i / det), as
    the scan raster, K7's rows and the XLA WBOIT compute them: each
    product rounded, then summed in row order ((r0 + r1) + r2) — not
    row16's zs, which multiplies by 1/det after the sum."""
    ez = setup["adj"] * (setup["zc"] / setup["det"][:, None])[:, :, None]
    return (ez[:, 0] + ez[:, 1]) + ez[:, 2]


def _tile_ndc(tile_idx, tiles_x, width, height):
    """NDC (xn, yn) of the pixel centres of the tiles tile_idx (n,):
    each (n, TILE_H, TILE_W), as the scan raster computes them,
    (p + 0.5) / size * 2 - 1."""
    dev = tile_idx.device
    ty = (tile_idx // tiles_x)[:, None, None]
    tx = (tile_idx % tiles_x)[:, None, None]
    py = ty * TILE_H + torch.arange(TILE_H, dtype=torch.float32, device=dev)[None, :, None]
    px = tx * TILE_W + torch.arange(TILE_W, dtype=torch.float32, device=dev)[None, None, :]
    yn = (py + 0.5) / height * 2.0 - 1.0
    xn = (px + 0.5) / width * 2.0 - 1.0
    n = tile_idx.shape[0]
    return xn.expand(n, TILE_H, TILE_W), yn.expand(n, TILE_H, TILE_W)


def check_band(n_tiles, tiles_x, tile0, tiles_y=None):
    """Raise unless n_tiles tiles from the frame tile tile0 on are whole
    tile rows of tiles_x (inside the tiles_y-row frame when given): the
    whole frame, or a band of the tile-sharded frame."""
    if (n_tiles % tiles_x or tile0 % tiles_x or tile0 < 0
            or (tiles_y is not None and tile0 + n_tiles > tiles_x * tiles_y)):
        raise ValueError(f"{n_tiles} tiles from tile {tile0} are not whole rows of "
                         f"{tiles_x}" + ("" if tiles_y is None else f" in {tiles_y}"))


def raster(setup, bins, big_ids, tiles_x, tiles_y, width, height, tile0=0):
    """The scan raster: depth (Hp, Wp) f32 (reverse-Z, cleared to 0) and
    vis (Hp, Wp) int32 triangle id (-1 = background) over all tiles.

    What `use_pallas=False` means: it is the JAX package's XLA raster
    and runs as plain PyTorch on every device, the card included — the
    reference's own algorithm for that flag, not a fallback.  One step a
    walk slot, K + B steps of whole-frame element-wise ops: the tile's
    bins first, then the big list (not K5's order).  Either winding is
    inside, with the interpolated w (e0 + e1 + e2) * det > 0; no valid
    flag (the bins hold only valid triangles); no y scissor (the JAX
    setup carries no "ylim" key, so the stacked shadow atlases raster
    without their band scissor here).  Planes are fma(a, xn, b*yn) + c,
    as XLA contracts a*xn + b*yn + c.  Band mode (the tile-sharded frame):
    bins holds the whole tile rows from the frame tile tile0 on, and the
    planes are theirs."""
    dev = bins.device
    adj, det = setup["adj"], setup["det"]
    zs = depth_plane_coefs(setup)
    n_tiles = bins.shape[0]
    check_band(n_tiles, tiles_x, tile0, tiles_y)
    tiles_y = n_tiles // tiles_x
    xn, yn = _tile_ndc(torch.arange(n_tiles, device=dev) + tile0, tiles_x, width, height)
    depth = torch.zeros((n_tiles, TILE_H, TILE_W), device=dev)
    vis = torch.full((n_tiles, TILE_H, TILE_W), -1, dtype=torch.int32, device=dev)
    ids = torch.cat([bins, big_ids[None, :].expand(n_tiles, big_ids.shape[0])], 1)
    for k in range(ids.shape[1]):
        tri = ids[:, k]
        t = torch.clamp(tri, min=0).long()
        a = adj[t][:, :, :, None, None]                # (n, 3, 3, 1, 1)
        e0 = fma(a[:, 0, 0], xn, a[:, 0, 1] * yn) + a[:, 0, 2]
        e1 = fma(a[:, 1, 0], xn, a[:, 1, 1] * yn) + a[:, 1, 2]
        e2 = fma(a[:, 2, 0], xn, a[:, 2, 1] * yn) + a[:, 2, 2]
        inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                  | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
        inside = inside & ((e0 + e1 + e2) * det[t][:, None, None] > 0)
        z = zs[t][:, :, None, None]
        d = fma(z[:, 0], xn, z[:, 1] * yn) + z[:, 2]
        passed = inside & (tri >= 0)[:, None, None] & (d > depth) & (d <= 1.0)
        depth = torch.where(passed, d, depth)
        vis = torch.where(passed, t.to(torch.int32)[:, None, None], vis)
    return _untile(depth, tiles_x, tiles_y), _untile(vis, tiles_x, tiles_y)


def resolve_barycentrics(vis, setup, width, height, y0=0):
    """Per-pixel perspective-correct barycentrics of the winning triangle:
    (lam (H, W, 3) summing to 1 on covered pixels, mask (H, W)).  y0:
    vis's first row in the frame (a band of the tile-sharded frame)."""
    h, w = vis.shape
    dev = vis.device
    ys = ((torch.arange(h, dtype=torch.float32, device=dev)[:, None] + y0 + 0.5)
          / height * 2.0 - 1.0)
    xs = ((torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5)
          / width * 2.0 - 1.0)
    mask = vis >= 0
    a = setup["adj"][torch.clamp(vis, min=0).long()]          # (H, W, 3, 3)
    e = fma(a[..., 0], xs[..., None], a[..., 1] * ys[..., None]) + a[..., 2]
    s = (e[..., 0:1] + e[..., 1:2]) + e[..., 2:3]
    lam = e / torch.where(torch.abs(s) < 1e-20, torch.ones_like(s), s)
    return lam, mask


def rasterize(clip, tris, *, width, height, tiles_x, tiles_y, bin_capacity=256,
              big_capacity=64):
    """End to end: clip-space triangles -> (depth, vis id, setup)."""
    setup = triangle_setup(clip, tris, width, height, tiles_x, tiles_y)
    bins, counts, big_ids = bin_triangles(setup, tris.shape[0], tiles_x, tiles_y,
                                          bin_capacity, big_capacity)
    depth, vis = raster(setup, bins, big_ids, tiles_x, tiles_y, width, height)
    return depth, vis, setup


def _untile(tiled, tiles_x, tiles_y):
    """(n_tiles, TH, TW, ...) -> (tiles_y*TH, tiles_x*TW, ...)."""
    th, tw, rest = tiled.shape[1], tiled.shape[2], tiled.shape[3:]
    return (tiled.reshape(tiles_y, tiles_x, th, tw, *rest).transpose(1, 2)
            .reshape(tiles_y * th, tiles_x * tw, *rest))


def tile_image(img, tiles_x, tiles_y):
    """(H, W, ...) -> (n_tiles, TH, TW, ...)."""
    rest = img.shape[2:]
    return (img.reshape(tiles_y, TILE_H, tiles_x, TILE_W, *rest)
            .permute(0, 2, 1, 3, *(range(4, 4 + len(rest))))
            .reshape(tiles_y * tiles_x, TILE_H, TILE_W, *rest))
