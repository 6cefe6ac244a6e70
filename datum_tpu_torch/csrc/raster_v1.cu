// K5: the v1 visibility raster (depth, triangle id, two barycentrics).
//
// Replaces the Pallas kernel datum_tpu/ops/raster_pallas.py
// `_raster_kernel` (launched by `raster_pallas`).  The deferred resolve
// (ops/shade.py::resolve_gbuffer with lam=) reads its planes.
//
// What it computes.  For every pixel of a 32 x 128 tile it walks the
// frame's big-triangle list, then the tile's bin entries, in order.  Per
// entry, from the setup's 16-float row: three edge functions
// e_k = a_k*xn + b_k*yn + c_k (sign-fixed adjugate rows), the inside test
// (all e >= 0, s = e0 + e1 + e2 > 0, valid slot 12 > 0, and the row
// scissor ylo <= yn < yhi from slots 14-15), the depth plane d (slots
// 9-11) and the strict reverse-Z test d > depth && d <= 1.  The last
// entry that passes wins (ties keep the earlier one).  Out: depth, the
// winner's id as f32 (-1 uncovered), l0 = e0 * inv_s and l1 = e1 * inv_s
// with inv_s = 1 / (s == 0 ? 1 : s).
//
// What bounds it on the H100.  ~18 f32 operations per (pixel, entry) on
// coefficients uniform across the tile: instruction throughput, not
// memory (a frame reads ~E rows of 16 floats per tile and writes 4 f32
// planes).  The work is uneven: the busiest tiles' walks set the time of
// a kernel that gives each tile to one block.
//
// What the design does about it (K1's design, csrc/raster_shade.cu, with
// K3's scissor in the reject):
//  * One tile's walk is split over a thread-block cluster of SPLIT blocks
//    (grid n_tiles * SPLIT).  Block r walks the slots g = r (mod SPLIT)
//    of the tile's sequence (the big list, then the bin), with K1's
//    launcher rule: SPLIT 2 where there are at least twice as many tiles
//    as SMs and n_big + bin_capacity <= 512, else 4 (a caller may force
//    2, 4 or 8).  Measured on an H100 80GB HBM3 at 700 W: the bench
//    inputs (510 tiles, 224 entries a tile) 0.066 ms at 2, 0.079 at 4,
//    0.117 at 8; the stress frame's bins (510 tiles, 1152) 0.320, 0.241,
//    0.274.  256 threads a block, 16 pixels a thread (one column, 16
//    rows); each block stages its own entries' 16-float rows in shared
//    memory, 64 at a time, so every coefficient load is a broadcast that
//    feeds 16 pixels.
//  * A block carries, per pixel, its partial (depth, walk slot g): the
//    slot, not the id, since the same id can stand twice in a tile's
//    sequence and the id order is not the walk order.
//  * The combine is exact.  Every condition but d > depth (the inside
//    test, the valid flag, the scissor, d <= 1) is independent of the
//    walk's state, so the sequential walk's depth at a pixel is the
//    largest d among the entries that pass them, and its winner the
//    FIRST slot that reaches it: the depth is below it until then, and
//    no later entry passes a strict test against it.  A block's partial
//    walk gives the same over its own slots.  So the full walk's (depth,
//    slot) is the largest partial depth and, among the blocks that reach
//    it, the smallest partial slot; a pixel nothing passes keeps depth 0
//    and NO_SLOT, which every winner (d > 0) beats.  Only after the
//    combine is the slot mapped to its id.
//  * The combine goes through distributed shared memory: block r reduces
//    rows r*32/SPLIT.. of the tile.  After its walk each block stores its
//    partial rows into their reducer's shared memory, then one full
//    cluster barrier, after which no block touches another's memory (the
//    split arrive/wait at the start only makes sure every peer runs
//    before its memory is written).  Each block then gathers the
//    winner's row of each of its pixels from global memory and writes
//    the 4 planes, coalesced, each texel once, with no atomics.
//  * A warp-uniform rectangle reject with the row scissor (K3's).  Warp w
//    covers 32 columns x 16 rows; y0 and y1 are the yn of its first and
//    last row, computed as the pixels compute them.  Before the 16-pixel
//    loop the warp skips an entry whose scissor misses its rows, y1 < ylo
//    or y0 >= yhi: yn is monotone in the row, so every pixel fails ylo <=
//    yn < yhi (exact; a NaN bound never rejects).  It also skips one of
//    whose edges is below 0 on the whole rectangle: its value at the
//    corner where the exact affine function is largest (x1 where a > 0
//    else x0, y1 where b > 0 else y0), computed in the pixels' form
//    fma(a, x, b*y) + c, plus the margin m = fl(fl(|a| mx + |b| my + |c|)
//    * 8u + 1e-36), is < 0 (mx, my: the largest |x|, |y| of the
//    rectangle; u = 2^-24).  Why that is exact (K3's derivation,
//    raster_depth.cu): a pixel's value v = fl(fl(a x + fl(b y)) + c)
//    differs from the exact E = a x + b y + c by at most u B + u (A + B
//    (1 + u)) + u (A + B + C)(1 + 3u) <= (3u + 4u^2) S, with A = |a||x|,
//    B = |b||y|, C = |c| and S = |a| mx + |b| my + |c|, and so does the
//    corner's.  E is largest on the rectangle at the chosen corner, so at
//    every pixel v_p <= E_p + (3u + 4u^2) S <= E_c + (3u + 4u^2) S <= v_c
//    + (6u + 8u^2) S.  The computed margin is at least 8u fl(S) >= 8u S
//    (1 - 3u) >= (6u + 8u^2) S (the 8u scaling is exact; the 1e-36 covers
//    gradual underflow, < 2^-150 an operation).  fl(v_c + m) < 0 implies
//    v_c + m < 0, so v_p < 0 at every pixel: the entry fails e >= 0
//    there, and skipping it changes nothing.  A NaN or infinite
//    coefficient makes m NaN or infinite, and the entry is never skipped.
//    Entries with valid <= 0 (the zero rows of id -1 among them) are
//    skipped block-wide before the test: they never pass.
//    ops/raster_depth_cuda.py holds the plain twin (`warp_rect_reject`
//    with scissor=True, form="plane"), which the CPU tests hold against
//    the plain raster.
//  * The scissor's other side: where the warp's rows lie inside it, y0 >=
//    ylo and y1 < yhi, every pixel passes ylo <= yn < yhi (monotone
//    again), so the 16-pixel loop drops the per-pixel compare (walk16
//    without SCISSOR); the main view's rows carry the open scissor, so
//    that is the loop nearly every entry takes.  Measured on an H100
//    80GB HBM3 at 700 W: with the per-pixel compare always taken, the
//    scissor reject cost 2.2% on the bench inputs against an edges-only
//    reject (0.0693 against 0.0678 ms); with the skip it gains 1-5%
//    (0.0670 bench, 0.2411 stress against 0.0678 and 0.2529).
//  * __launch_bounds__(256, 2): at most 128 registers, two blocks an SM.
//    yn is recomputed from the row index (the same exact integer sum, the
//    same bits) instead of being carried for 16 rows.
//  * Rounding.  XLA compiles the JAX kernel's a*xn + b*yn + c as
//    fma(a, xn, b*yn) + c; every plane here is written so with
//    __fmaf_rn, and the file is built with -fmad=false so nvcc contracts
//    nothing else.  The plain PyTorch version computes the same fused
//    products, so edge pixels pick the same winner on the card as on
//    the CPU.  The Pallas kernel carries l0 and l1 through the walk; the
//    carried values are the winner's, computed by the same operations
//    after the walk here: the same bits.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = TILE_H * TILE_W / THREADS;   // 16
constexpr int CHUNK = 64;          // entries staged per round
constexpr int ROW = 16;            // floats per triangle row
constexpr int WARP_W = 32;         // a warp's rectangle: 32 columns x 16 rows
constexpr int NO_SLOT = INT_MAX;   // no entry passed at the pixel
constexpr float REJECT_REL = 8.0f / 16777216.0f;   // 8u, u = 2^-24
constexpr float REJECT_ABS = 1e-36f;

// a*xn + b*yn + c as XLA compiles it: fma(a, xn, b*yn) + c
__device__ __forceinline__ float plane(float a, float b, float c, float xn, float yn) {
    return __fmaf_rn(a, xn, b * yn) + c;
}

// True when the edge a*x + b*y + c is below 0 at every pixel of the
// rectangle [x0, x1] x [y0, y1] (the header derives the margin)
__device__ __forceinline__ bool edge_outside(float a, float b, float c, float x0,
                                             float x1, float y0, float y1) {
    const float mx = fmaxf(fabsf(x0), fabsf(x1));
    const float my = fmaxf(fabsf(y0), fabsf(y1));
    const float margin = (fabsf(a) * mx + fabsf(b) * my + fabsf(c)) * REJECT_REL
                         + REJECT_ABS;
    return plane(a, b, c, a > 0.0f ? x1 : x0, b > 0.0f ? y1 : y0) + margin < 0.0f;
}

// the pixel-centre NDC coordinate of tile row / column `pix`: (origin +
// pix + 0.5) * scale - 1, the sum of the two integers exact in f32
__device__ __forceinline__ float ndc(int origin, int pix, float scale) {
    return ((float)origin + (float)pix + 0.5f) * scale - 1.0f;
}

__device__ __forceinline__ int entry_id(const int* big_ids, const int* bins, int tile,
                                        int bin_capacity, int n_big, int g) {
    return g < n_big ? big_ids[g] : bins[(size_t)tile * bin_capacity + (g - n_big)];
}

// one entry at a thread's 16 pixels (one column, rows y_origin..+15):
// the inside test, the row scissor where SCISSOR, the strict depth test;
// a pixel that passes takes d and the walk slot g
template <bool SCISSOR>
__device__ __forceinline__ void walk16(float (&depth)[ROWS_PER_THREAD],
                                       int (&slot)[ROWS_PER_THREAD], float a0, float b0,
                                       float c0, float a1, float b1, float c1, float a2,
                                       float b2, float c2, float az, float bz, float cz,
                                       float ylo, float yhi, float xn, int y_origin,
                                       float cy, int g) {
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        const float yn = ndc(y_origin, p, cy);
        const float e0 = plane(a0, b0, c0, xn, yn);
        const float e1 = plane(a1, b1, c1, xn, yn);
        const float e2 = plane(a2, b2, c2, xn, yn);
        const float s = (e0 + e1) + e2;
        const float d = plane(az, bz, cz, xn, yn);
        bool pass = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f) & (s > 0.0f)
                    & (d > depth[p]) & (d <= 1.0f);
        if (SCISSOR) pass = pass & (yn >= ylo) & (yn < yhi);
        depth[p] = pass ? d : depth[p];
        slot[p] = pass ? g : slot[p];
    }
}

template <int SPLIT>                // blocks of a cluster: one tile's walk
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS, 2)
raster_v1_kernel(const float* __restrict__ tri_rows,
                 const int* __restrict__ bins,
                 const int* __restrict__ counts,
                 const int* __restrict__ big_ids,
                 int n_big, int bin_capacity, int tiles_x,
                 float cx, float cy, int out_w, size_t plane_size,
                 float* __restrict__ out)
{
    constexpr int ROWS_PER_RANK = TILE_H / SPLIT;
    constexpr int RANK_PIXELS = ROWS_PER_RANK * TILE_W;
    __shared__ float s_row[CHUNK][ROW];
    __shared__ float s_depth[SPLIT][RANK_PIXELS];   // the rows this block combines
    __shared__ int s_slot[SPLIT][RANK_PIXELS];

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    // this block runs: its peers may write into s_depth / s_slot once all have arrived
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    const int tile = blockIdx.x / SPLIT;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int col = threadIdx.x % TILE_W;
    const int row0 = (threadIdx.x / TILE_W) * ROWS_PER_THREAD;
    const int x = tx * TILE_W + col;
    const float xn = ndc(tx * TILE_W, col, cx);

    float depth[ROWS_PER_THREAD];
    int slot[ROWS_PER_THREAD];
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        depth[p] = 0.0f;
        slot[p] = NO_SLOT;
    }
    // the warp's rectangle: its first and last column's xn, its rows' yn
    const int wcol = col - col % WARP_W;
    const float x0 = ndc(tx * TILE_W, wcol, cx);
    const float x1 = ndc(tx * TILE_W, wcol + WARP_W - 1, cx);
    const float y0 = ndc(ty * TILE_H, row0, cy);
    const float y1 = ndc(ty * TILE_H, row0 + ROWS_PER_THREAD - 1, cy);

    // the big slots first (compacted: the empty ones hold -1), then the
    // tile's bin range; this block's share of them
    const int n_entries = n_big + counts[tile];
    const int n_mine = n_entries > rank ? (n_entries - rank + SPLIT - 1) / SPLIT : 0;
    for (int base = 0; base < n_mine; base += CHUNK) {
        const int n_here = min(CHUNK, n_mine - base);
        for (int i = threadIdx.x; i < n_here * ROW; i += THREADS) {
            const int e = i / ROW;
            const int k = i - e * ROW;
            const int id = entry_id(big_ids, bins, tile, bin_capacity, n_big,
                                    (base + e) * SPLIT + rank);
            // empty slots are zero rows: slot 12 (valid) = 0 never passes
            s_row[e][k] = id >= 0 ? tri_rows[(size_t)id * ROW + k] : 0.0f;
        }
        __syncthreads();
        for (int e = 0; e < n_here; ++e) {
            const float* r = s_row[e];
            if (!(r[12] > 0.0f)) continue;
            const float ylo = r[14], yhi = r[15];
            if (y1 < ylo || y0 >= yhi) continue;         // the scissor misses the warp
            const float a0 = r[0], b0 = r[1], c0 = r[2];
            const float a1 = r[3], b1 = r[4], c1 = r[5];
            const float a2 = r[6], b2 = r[7], c2 = r[8];
            if (edge_outside(a0, b0, c0, x0, x1, y0, y1)
                || edge_outside(a1, b1, c1, x0, x1, y0, y1)
                || edge_outside(a2, b2, c2, x0, x1, y0, y1)) continue;
            const float az = r[9], bz = r[10], cz = r[11];
            const int g = (base + e) * SPLIT + rank;
            // every row of the warp inside the scissor: no per-pixel compare
            if (y0 >= ylo && y1 < yhi)
                walk16<false>(depth, slot, a0, b0, c0, a1, b1, c1, a2, b2, c2, az, bz, cz,
                              ylo, yhi, xn, ty * TILE_H + row0, cy, g);
            else
                walk16<true>(depth, slot, a0, b0, c0, a1, b1, c1, a2, b2, c2, az, bz, cz,
                             ylo, yhi, xn, ty * TILE_H + row0, cy, g);
        }
        __syncthreads();
    }

    // combine: each block sends rank q its partial rows of q's slice
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        const int row = row0 + p;
        const int q = row / ROWS_PER_RANK;
        const int o = (row % ROWS_PER_RANK) * TILE_W + col;
        cluster.map_shared_rank(&s_depth[rank][0], q)[o] = depth[p];
        cluster.map_shared_rank(&s_slot[rank][0], q)[o] = slot[p];
    }
    cluster.sync();

    // epilogue over this block's rows: the largest depth, the smallest
    // slot among equal depths; then the winner's barycentrics from its
    // row, one reciprocal a pixel
    for (int i = threadIdx.x; i < RANK_PIXELS; i += THREADS) {
        float best = 0.0f;
        int g = NO_SLOT;
#pragma unroll
        for (int q = 0; q < SPLIT; ++q) {
            const float dq = s_depth[q][i];
            const int gq = s_slot[q][i];
            if (dq > best || (dq == best && gq < g)) { best = dq; g = gq; }
        }
        const int row = rank * ROWS_PER_RANK + i / TILE_W;     // i % TILE_W == col
        float vis = -1.0f, l0 = 0.0f, l1 = 0.0f;
        if (g != NO_SLOT) {
            const int id = entry_id(big_ids, bins, tile, bin_capacity, n_big, g);
            const float* r = tri_rows + (size_t)id * ROW;
            const float yn = ndc(ty * TILE_H, row, cy);
            const float e0 = plane(r[0], r[1], r[2], xn, yn);
            const float e1 = plane(r[3], r[4], r[5], xn, yn);
            const float e2 = plane(r[6], r[7], r[8], xn, yn);
            const float s = (e0 + e1) + e2;
            const float inv_s = 1.0f / (s == 0.0f ? 1.0f : s);
            vis = (float)id;
            l0 = e0 * inv_s;
            l1 = e1 * inv_s;
        }
        const size_t o = (size_t)(ty * TILE_H + row) * out_w + x;
        out[o] = best;
        out[plane_size + o] = vis;
        out[2 * plane_size + o] = l0;
        out[3 * plane_size + o] = l1;
    }
}

template <int SPLIT>
void launch(const float* tri_rows, const int* bins, const int* counts,
            const int* big_ids, int n_big, int bin_capacity, int tiles_x, int n_tiles,
            float cx, float cy, int out_w, size_t plane_size, float* out,
            cudaStream_t stream)
{
    raster_v1_kernel<SPLIT><<<n_tiles * SPLIT, THREADS, 0, stream>>>(
        tri_rows, bins, counts, big_ids, n_big, bin_capacity, tiles_x, cx, cy, out_w,
        plane_size, out);
}

}  // namespace

// tri_rows (T, 16) f32 (the setup's row16); bins (n_tiles, bin_capacity)
// i32; counts (n_tiles,) i32; big_ids (n_big,) i32; out (4, out_h, out_w)
// f32 = depth, visf, l0, l1 with out_h = tiles_y * 32 and out_w =
// tiles_x * 128.  cx, cy are 2/width and 2/height, rounded to f32 by the
// caller.  split: the blocks a tile, 2, 4 or 8, or 0 for the launcher's
// rule (2 on at least two tiles an SM and n_big + bin_capacity <= 512,
// else 4); any other value launches nothing and returns
// cudaErrorInvalidValue.
extern "C" int raster_v1_launch(const float* tri_rows, const int* bins,
                                const int* counts, const int* big_ids,
                                int n_big, int bin_capacity, int tiles_x,
                                int n_tiles, float cx, float cy, int out_w,
                                int split, float* out, void* stream)
{
    const size_t plane_size = (size_t)(n_tiles / tiles_x) * TILE_H * out_w;
    if (split == 0) {
        int dev = 0, n_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
        split = n_tiles >= 2 * n_sm && n_big + bin_capacity <= 512 ? 2 : 4;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    if (split == 2)
        launch<2>(tri_rows, bins, counts, big_ids, n_big, bin_capacity, tiles_x, n_tiles,
                  cx, cy, out_w, plane_size, out, s);
    else if (split == 4)
        launch<4>(tri_rows, bins, counts, big_ids, n_big, bin_capacity, tiles_x, n_tiles,
                  cx, cy, out_w, plane_size, out, s);
    else if (split == 8)
        launch<8>(tri_rows, bins, counts, big_ids, n_big, bin_capacity, tiles_x, n_tiles,
                  cx, cy, out_w, plane_size, out, s);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
