// K7: the matmul raster with attribute interpolation.
//
// Replaces the Pallas kernel datum_tpu/ops/raster_pallas.py `_v3_kernel`
// (its per-half body `_v3_half`, launched by `raster_shade_mxu`).
//
// What it computes.  The TPU kernel walks a tile's entries in chunks of
// 128: one (24 x 128)^T x (24 x 6*2048) product gives, for every (entry,
// pixel) pair, three edges e0..e2, the depth d and two scissor planes
// e3 = yn - ylo, e4 = yhi - yn; an entry is inside where e0, e1, e2 >= 0,
// s = e0 + e1 + e2 > 0, e3 >= 0 and e4 > 0 (no valid flag: empty slots
// are zero rows and fail s > 0); the chunk's largest d with d > depth and
// d <= 1 wins, ties to the lowest row, and a one-hot product fetches the
// winner's attributes.  A later chunk must beat the depth strictly, so
// the winner is the first entry in walk order (big slots, then the bin)
// that reaches the largest passing depth: a sequential walk with a
// strict test gives the same winner.  After the walk: l0 = e0 * inv_s,
// l1 = e1 * inv_s, l2 = (1 - l0) - l1 with inv_s = 1 / (s == 0 ? 1 : s),
// uv and normal as a*l0 + b*l1 + c*l2 of the winner's vertex values,
// and its material values and id.
//
// What bounds it on the H100.  The work the function must do is each
// walked entry x each pixel x six planes (~26 f32 operations a pair);
// the TPU's padded product (24 x 128 x 12288 a chunk-half, 21 of every
// 24 terms zero) is a TPU layout, not work.  At the 1920x1088 bench
// inputs the least time is set by the 15 output planes' bytes; the walk
// itself is limited by instruction throughput, like K1's, and the
// busiest tiles' walks set the time of a kernel that gives each tile to
// one block.
//
// What the design does about it (K1's design, csrc/raster_shade.cu, in
// K7's arithmetic):
//  * No product at all: each pixel evaluates the six planes of an entry
//    directly from its 14 staged coefficients (no tensor core, no
//    library call); the one-hot attribute fetch becomes one gather of
//    the winner's row after the walk.
//  * One tile's walk is split over a thread-block cluster of SPLIT blocks
//    (grid n_tiles * SPLIT).  Block r walks the slots g = r (mod SPLIT)
//    of the tile's sequence, with K1's launcher rule: SPLIT 2 where there
//    are at least twice as many tiles as SMs and n_big + bin_capacity <=
//    512, else 4.  256 threads a block, 16 pixels a thread (one column,
//    16 rows); each block stages its own entries' 14 walk slots in
//    shared memory, 64 at a time, so every coefficient load is a
//    broadcast that feeds 16 pixels.
//  * A block carries, per pixel, its partial (depth, walk slot g): the
//    slot, not the id, since the same id can stand twice in a tile's
//    sequence and the id order is not the walk order.  The combine is
//    exact, by the argument above: every condition but d > depth (the
//    inside test, the scissor, d <= 1) is independent of the walk's
//    state, so the sequential walk's depth at a pixel is the largest d
//    among the entries that pass them, and its winner the first slot
//    that reaches it; a block's partial walk gives the same over its own
//    slots.  So the full walk's (depth, slot) is the largest partial
//    depth and, among the blocks that reach it, the smallest partial
//    slot; a pixel nothing passes keeps depth 0 and NO_SLOT.  Only after
//    the combine is the slot mapped to its id.
//  * The combine goes through distributed shared memory: block r reduces
//    rows r*32/SPLIT.. of the tile; after its walk each block stores its
//    partial rows into their reducer's shared memory, then one full
//    cluster barrier, after which no block touches another's memory.
//    Each block then gathers the winner's 40-float row of each of its
//    pixels from global memory (K1's way) and writes the 15 planes,
//    coalesced, each texel once.
//  * A warp-uniform rectangle reject, edges only.  Warp w covers 32
//    columns x 16 rows.  It skips an entry one of whose edges is below 0
//    on the whole rectangle: its value at the corner where the exact
//    affine function is largest (x1 where a > 0 else x0, y1 where b > 0
//    else y0), computed in K7's form fma(b, y, a*x) + c, plus the margin
//    m = fl(fl(|a| mx + |b| my + |c|) * 8u + 1e-36), is < 0 (mx, my: the
//    largest |x|, |y| of the rectangle; u = 2^-24).  Why that is exact:
//    with E = a x + b y + c the exact edge, K7's value at a point in the
//    rectangle is v = fl(fl(b y + fl(a x)) + c) = ((b y + a x (1 + d1))
//    (1 + d2) + c)(1 + d3) with |di| <= u, so v - E = a x ((1 + d1)(1 +
//    d2)(1 + d3) - 1) + b y ((1 + d2)(1 + d3) - 1) + c d3 and |v - E| <=
//    ((1 + u)^3 - 1) S < 3.0001 u S, S = |a| mx + |b| my + |c|: the same
//    bound as K1's form fma(a, x, b*y) + c, where the a- and b-terms swap
//    roles.  The corner's and each pixel's values both lie within it.  E is
//    largest on the rectangle at the chosen corner, so at every pixel v_p
//    <= E_p + 3.0001uS <= E_c + 3.0001uS <= v_c + 6.0002uS.  The computed
//    margin is at least (8uS(1 - 3.0001u) + 1e-36)(1 - u) > 6.0002uS
//    (the 8u scaling is exact; underflowed products err by at most
//    2^-150 each, far below the 1e-36).  fl(v_c + m) < 0 implies v_c + m <
//    0, so v_p < 0 at every pixel: the entry fails e >= 0 there, and
//    skipping it changes nothing.  A NaN or infinite coefficient makes m
//    NaN or infinite, and the entry is never skipped.  Zero rows (id -1)
//    are skipped block-wide before the test; their edges would never be
//    rejected (0 + 1e-36 > 0) and their s = 0 fails anyway.  No scissor
//    reject: pack_v3's default ylim (-8, 8) never rejects a frame row.
//    ops/raster_depth_cuda.py holds the plain twin (`warp_rect_reject`
//    with scissor=False, form="dot"), which the CPU tests hold against
//    the plain raster and the exact edge.
//  * __launch_bounds__(256, 2): at most 128 registers, two blocks an SM.
//    yn is recomputed from the row index (the same bits) instead of
//    being carried for 16 rows.
//  * Rounding, as XLA:CPU computes the TPU kernel: its dot accumulates
//    the 24 terms in order with fused multiply-adds from 0 (the zero
//    terms add exact zeros), so a plane is fma(b, yn, a*xn) + c — not
//    K1's fma(a, xn, b*yn) + c — and each attribute is
//    fma(c, l2, fma(a, l0, b*l1)).  The file is built with -fmad=false
//    and writes every fused product with __fmaf_rn; the plain PyTorch
//    version computes the same ones, so winners and planes agree bit
//    for bit.

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
constexpr int WALK_SLOTS = 14;     // row slots the walk reads (0..13)
constexpr int ROW = 40;            // floats per triangle row
constexpr int N_PLANES = 15;
constexpr int WARP_W = 32;         // a warp's rectangle: 32 columns x 16 rows
constexpr int NO_SLOT = INT_MAX;   // no entry passed at the pixel
constexpr float REJECT_REL = 8.0f / 16777216.0f;   // 8u, u = 2^-24
constexpr float REJECT_ABS = 1e-36f;

// one column of the coefficient product as XLA:CPU's dot accumulates
// it: ((0 + a*xn) + b*yn) + c*1 with fused multiply-adds
__device__ __forceinline__ float dplane(float a, float b, float c, float xn, float yn) {
    return __fmaf_rn(b, yn, a * xn) + c;
}

// a*l0 + b*l1 + c*l2 as XLA contracts it
__device__ __forceinline__ float lerp3(float a, float b, float c, float l0, float l1,
                                       float l2) {
    return __fmaf_rn(c, l2, __fmaf_rn(a, l0, b * l1));
}

// True when the edge a*x + b*y + c, evaluated as dplane, is below 0 at
// every pixel of the rectangle [x0, x1] x [y0, y1] (the header derives
// the margin)
__device__ __forceinline__ bool edge_outside(float a, float b, float c, float x0,
                                             float x1, float y0, float y1) {
    const float mx = fmaxf(fabsf(x0), fabsf(x1));
    const float my = fmaxf(fabsf(y0), fabsf(y1));
    const float margin = (fabsf(a) * mx + fabsf(b) * my + fabsf(c)) * REJECT_REL
                         + REJECT_ABS;
    return dplane(a, b, c, a > 0.0f ? x1 : x0, b > 0.0f ? y1 : y0) + margin < 0.0f;
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

template <int SPLIT>                // blocks of a cluster: one tile's walk
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS, 2)
raster_mxu_kernel(const float* __restrict__ tri_rows,
                  const int* __restrict__ bins,
                  const int* __restrict__ counts,
                  const int* __restrict__ big_ids,
                  int n_big, int bin_capacity, int tiles_x,
                  float cx, float cy, int out_w, size_t plane_size,
                  float* __restrict__ out)
{
    constexpr int ROWS_PER_RANK = TILE_H / SPLIT;
    constexpr int RANK_PIXELS = ROWS_PER_RANK * TILE_W;
    __shared__ float s_row[CHUNK][WALK_SLOTS];
    __shared__ int s_id[CHUNK];
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

    // every big slot, then the tile's bin range (the TPU kernel's
    // active = idx < B + count); this block's share of them
    const int n_entries = n_big + counts[tile];
    const int n_mine = n_entries > rank ? (n_entries - rank + SPLIT - 1) / SPLIT : 0;
    for (int base = 0; base < n_mine; base += CHUNK) {
        const int n_here = min(CHUNK, n_mine - base);
        for (int i = threadIdx.x; i < n_here * WALK_SLOTS; i += THREADS) {
            const int e = i / WALK_SLOTS;
            const int k = i - e * WALK_SLOTS;
            const int id = entry_id(big_ids, bins, tile, bin_capacity, n_big,
                                    (base + e) * SPLIT + rank);
            s_row[e][k] = id >= 0 ? tri_rows[(size_t)id * ROW + k] : 0.0f;
            if (k == 0) s_id[e] = id;
        }
        __syncthreads();
        for (int e = 0; e < n_here; ++e) {
            if (s_id[e] < 0) continue;     // a zero row: s = 0 never passes
            const float* r = s_row[e];
            const float a0 = r[0], b0 = r[1], c0 = r[2];
            const float a1 = r[3], b1 = r[4], c1 = r[5];
            const float a2 = r[6], b2 = r[7], c2 = r[8];
            if (edge_outside(a0, b0, c0, x0, x1, y0, y1)
                || edge_outside(a1, b1, c1, x0, x1, y0, y1)
                || edge_outside(a2, b2, c2, x0, x1, y0, y1)) continue;
            const float az = r[9], bz = r[10], cz = r[11];
            const float ylo = r[12], yhi = r[13];
            const int g = (base + e) * SPLIT + rank;
#pragma unroll
            for (int p = 0; p < ROWS_PER_THREAD; ++p) {
                const float yn = ndc(ty * TILE_H, row0 + p, cy);
                const float e0 = dplane(a0, b0, c0, xn, yn);
                const float e1 = dplane(a1, b1, c1, xn, yn);
                const float e2 = dplane(a2, b2, c2, xn, yn);
                const float d = dplane(az, bz, cz, xn, yn);
                const float s = (e0 + e1) + e2;
                const bool pass = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f)
                                  & (s > 0.0f) & (yn - ylo >= 0.0f) & (yhi - yn > 0.0f)
                                  & (d > depth[p]) & (d <= 1.0f);
                depth[p] = pass ? d : depth[p];
                slot[p] = pass ? g : slot[p];
            }
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
    // slot among equal depths; then the winner's barycentrics and
    // attributes from its row
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
        float v[N_PLANES];
#pragma unroll
        for (int j = 0; j < N_PLANES; ++j) v[j] = 0.0f;
        v[1] = -1.0f;
        if (g != NO_SLOT) {
            const int id = entry_id(big_ids, bins, tile, bin_capacity, n_big, g);
            const float* r = tri_rows + (size_t)id * ROW;
            const float yn = ndc(ty * TILE_H, row, cy);
            const float e0 = dplane(r[0], r[1], r[2], xn, yn);
            const float e1 = dplane(r[3], r[4], r[5], xn, yn);
            const float e2 = dplane(r[6], r[7], r[8], xn, yn);
            const float s = (e0 + e1) + e2;
            const float inv_s = 1.0f / (s == 0.0f ? 1.0f : s);
            const float l0 = e0 * inv_s;
            const float l1 = e1 * inv_s;
            const float l2 = (1.0f - l0) - l1;
            v[0] = best;
            v[1] = (float)id;
            v[2] = lerp3(r[16], r[18], r[20], l0, l1, l2);     // u
            v[3] = lerp3(r[17], r[19], r[21], l0, l1, l2);     // v
#pragma unroll
            for (int c = 0; c < 3; ++c)                        // normal xyz
                v[4 + c] = lerp3(r[22 + c], r[25 + c], r[28 + c], l0, l1, l2);
#pragma unroll
            for (int j = 0; j < 8; ++j) v[7 + j] = r[32 + j];  // material, albedo id
        }
        const size_t o = (size_t)(ty * TILE_H + row) * out_w + x;
#pragma unroll
        for (int j = 0; j < N_PLANES; ++j) out[j * plane_size + o] = v[j];
    }
}

}  // namespace

// tri_rows (T, 40) f32 (ops/raster_mxu_cuda.py::mxu_rows); bins (n_tiles,
// bin_capacity) i32; counts (n_tiles,) i32; big_ids (n_big,) i32; out
// (15, out_h, out_w) f32 = depth, visf, u, v, nx, ny, nz, cr, cg, cb, em,
// met, rgh, rfl, alb with out_h = tiles_y * 32 and out_w = tiles_x * 128.
// cx, cy are 2/width and 2/height, rounded to f32 by the caller.
extern "C" int raster_mxu_launch(const float* tri_rows, const int* bins,
                                 const int* counts, const int* big_ids,
                                 int n_big, int bin_capacity, int tiles_x,
                                 int n_tiles, float cx, float cy, int out_w,
                                 float* out, void* stream)
{
    const size_t plane_size = (size_t)(n_tiles / tiles_x) * TILE_H * out_w;
    int dev = 0, n_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_tiles >= 2 * n_sm && n_big + bin_capacity <= 512)
        raster_mxu_kernel<2><<<n_tiles * 2, THREADS, 0, (cudaStream_t)stream>>>(
            tri_rows, bins, counts, big_ids, n_big, bin_capacity, tiles_x, cx, cy,
            out_w, plane_size, out);
    else
        raster_mxu_kernel<4><<<n_tiles * 4, THREADS, 0, (cudaStream_t)stream>>>(
            tri_rows, bins, counts, big_ids, n_big, bin_capacity, tiles_x, cx, cy,
            out_w, plane_size, out);
    return (int)cudaGetLastError();
}
