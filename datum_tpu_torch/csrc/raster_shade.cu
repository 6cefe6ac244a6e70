// K1: fused visibility raster with attribute/material interpolation.
//
// Replaces the Pallas kernel datum_tpu/ops/raster_pallas.py
// `_raster_shade_kernel` (launched by `raster_shade_pallas`), in its
// extended form (tangent + material-map planes), with the optional peel
// plane of the lit translucent layers and the optional early-z exit.
// (alpha_in_alb is host work: the row builder puts the material alpha in
// slot 41.)
//
// What it computes.  For every pixel of a 32 x 128 tile, depth starts at
// 0 and the walk goes through the frame's big-triangle list, then the
// tile's bin entries, in order.  Per entry: three edge functions e_k =
// a_k*xn + b_k*yn + c_k from the sign-fixed adjugate rows, the inside
// test (all e >= 0, s = e0+e1+e2 > 0, valid slot > 0), the depth plane
// d, and the strict reverse-Z test d > depth && d <= 1 (and d < peel
// when a peel plane is given: the fragment must lie strictly behind the
// previous lit layer).  The last entry that passes wins (ties keep the
// earlier entry: the test is strict).  After the walk the winner's
// numerator planes are evaluated once and divided by its s.  No y
// scissor: row slots 14-15 are not read.
//
// What bounds it on the H100.  The walk is ~20 f32 operations per
// (pixel, entry) with coefficients that are uniform across the tile, so
// it is bound by issue rate where bins are deep (the stress frame), and
// by the 22 f32 planes it writes (~190 MB at 1920x1088) where they are
// shallow.  The work is uneven: the busiest tiles' walks set the time of
// a kernel that gives each tile to one block.
//
// What the design does about it.
//  * One tile's walk is split over a thread-block cluster of SPLIT blocks
//    (grid n_tiles * SPLIT), as K3 (raster_depth.cu) does.  Block r walks
//    the slots g = r (mod SPLIT) of the tile's sequence (the big list,
//    then the bin).  SPLIT is 4, or 2 where there are at least twice as
//    many tiles as the card has SMs and the bins are shallow (n_big +
//    bin_capacity <= 512): there the fixed costs a block (staging,
//    barriers, the epilogue's share) outweigh the walk.  Measured on an
//    H100 80GB HBM3 at 700 W: the bench opaque layer (510 tiles, 224
//    entries a tile) 0.115 ms at 2, 0.126 at 4, 0.167 at 8; the stress
//    frame (510 tiles, 1152) 0.420, 0.338, 0.376; the lit layers (136
//    tiles) 0.032-0.038 at 2, 4 and 8.
//    256 threads a block, 16 pixels a
//    thread (one column, 16 rows); each block stages only its own
//    entries' 13 walk slots in shared memory, in chunks of 64, so every
//    coefficient load is a broadcast that feeds 16 pixels.
//  * A block carries, per pixel, its partial (depth, walk slot g) in
//    registers: the slot, not the triangle id, since the id order is not
//    the walk order.
//  * The combine is exact.  With depth starting at 0 and the strict test
//    d > depth, the sequential walk's depth at a pixel is the largest d
//    among the entries that pass every other condition (inside, d <= 1,
//    d < peel: none depends on the walk's state), and its winner is the
//    FIRST entry in walk order that reaches that d: the depth is below
//    it until then, and no later entry passes a strict test against it.
//    A block's partial walk gives the same over its own slots.  So the
//    full walk's (depth, slot) is the largest partial depth and, among
//    the blocks that reach it, the smallest partial slot.  A pixel no
//    entry passes keeps depth 0 and the slot NO_SLOT, which every winner
//    (d > 0) beats.  Only after the combine is the slot mapped to its id.
//  * The combine goes through distributed shared memory: block r reduces
//    rows r*32/SPLIT.. of the tile.  After its walk each block stores its
//    partial rows into the shared memory of the block that reduces them;
//    after cluster.sync() each block combines the SPLIT slices it holds
//    and evaluates the 22 planes of its rows, so the plane writes spread
//    over the cluster too (coalesced, each texel written once, no
//    atomics).  Stores to a peer need no reply and after the barrier no
//    block reads another's memory, so one full cluster barrier does (the
//    split arrive/wait at the start only makes sure every peer runs
//    before its memory is written).
//  * A warp-uniform rectangle reject.  Warp w covers 32 columns x 16
//    rows.  Before the 16-pixel loop the warp skips an entry one of whose
//    edge functions is below 0 on the whole rectangle: its value at the
//    corner where the exact affine function is largest, plus a margin
//    that bounds the rounding of the pixels' and the corner's values, is
//    < 0 (K3's test and margin: raster_depth.cu derives it).  Such an
//    entry fails e >= 0 at every pixel of the rectangle, so skipping it
//    changes nothing; a NaN or infinite coefficient makes the margin NaN
//    or infinite and never rejects.  Edges only: K1 applies no y scissor.
//    ops/raster_depth_cuda.py holds the plain twin (`warp_rect_reject`
//    with scissor=False), which the CPU tests hold against the plain
//    raster.
//  * Early-z (szb given: per tile and walk slot, the suffix max of the
//    entries' depth upper bounds over the whole sequence) stays exact per
//    block: a thread stops at its slot g once the min of its partial
//    depths, refreshed once a chunk, reaches szb[g].  Every later entry
//    of its walk has d <= szb[g] <= its partial depth at each of its
//    pixels: none passes the strict test there, and where one reaches the
//    full walk's depth the block has already reached it at a smaller
//    slot, so the combine picks the same (depth, slot).  The block stops
//    when all its threads have (__syncthreads_and), so no thread leaves a
//    barrier behind.
//  * __launch_bounds__(256, 2): at most 128 registers, two blocks an SM.
//    yn is recomputed from the row index (the same exact integer sum, the
//    same bits) instead of being carried for 16 rows.
//  * Invalid entries (id -1: unused big-list slots) are zero rows and are
//    skipped uniformly by the whole block.
//  * Rounding.  The JAX kernel writes each plane as a*xn + b*yn + c and
//    XLA contracts that into fma(a, xn, b*yn) + c.  K1 evaluates every
//    plane (edges, depth, numerator planes) exactly so, with an explicit
//    __fmaf_rn, as K3 does; the file is built with -fmad=false, so nvcc
//    contracts nothing else, and the plain PyTorch version computes the
//    same fused products, so the two pick the same winner at every pixel
//    and write the same planes.

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
constexpr int WALK_SLOTS = 13;     // row slots the walk reads (0..12)
constexpr int ROW = 64;            // floats per triangle row
constexpr int N_PLANES = 22;
constexpr int WARP_W = 32;         // a warp's rectangle: 32 columns x 16 rows
constexpr int NO_SLOT = INT_MAX;   // no entry passed at the pixel
constexpr float REJECT_REL = 8.0f / 16777216.0f;   // 8u, u = 2^-24
constexpr float REJECT_ABS = 1e-36f;

// a*xn + b*yn + c as XLA compiles it: fma(a, xn, b*yn) + c
__device__ __forceinline__ float plane(float a, float b, float c, float xn, float yn) {
    return __fmaf_rn(a, xn, b * yn) + c;
}

// True when the edge a*x + b*y + c is below 0 at every pixel of the
// rectangle [x0, x1] x [y0, y1] (raster_depth.cu derives the margin).
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

template <int SPLIT>                // blocks of a cluster: one tile's walk
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS, 2)
raster_shade_kernel(const float* __restrict__ tri_rows,
                    const int* __restrict__ bins,
                    const int* __restrict__ counts,
                    const int* __restrict__ big_ids,
                    const float* __restrict__ peel,     // (out_h, out_w) or null
                    const float* __restrict__ szb,      // (n_tiles, n_big + bin_capacity) or null
                    int n_big, int bin_capacity, int tiles_x, int ty0,
                    float cx, float cy, int out_h, int out_w,
                    float* __restrict__ out)
{
    constexpr int ROWS_PER_RANK = TILE_H / SPLIT;
    constexpr int RANK_PIXELS = ROWS_PER_RANK * TILE_W;
    __shared__ float s_row[CHUNK][WALK_SLOTS];
    __shared__ float s_zb[CHUNK];
    __shared__ float s_depth[SPLIT][RANK_PIXELS];   // the rows this block combines
    __shared__ int s_slot[SPLIT][RANK_PIXELS];

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    // this block runs: its peers may write into s_depth / s_slot once all have arrived
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    const int tile = blockIdx.x / SPLIT;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int gy = (ty0 + ty) * TILE_H;     // the tile's first row in the NDC viewport
    const int col = threadIdx.x % TILE_W;
    const int row0 = (threadIdx.x / TILE_W) * ROWS_PER_THREAD;
    const int x = tx * TILE_W + col;
    const float xn = ndc(tx * TILE_W, col, cx);

    float depth[ROWS_PER_THREAD];
    float pl[ROWS_PER_THREAD];         // peel depth (2 = no peel: d <= 1 < 2)
    int slot[ROWS_PER_THREAD];
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        depth[p] = 0.0f;
        pl[p] = peel != nullptr ? peel[(size_t)(ty * TILE_H + row0 + p) * out_w + x] : 2.0f;
        slot[p] = NO_SLOT;
    }
    // the warp's rectangle: its first and last column's xn, its rows' yn
    const int wcol = col - col % WARP_W;
    const float x0 = ndc(tx * TILE_W, wcol, cx);
    const float x1 = ndc(tx * TILE_W, wcol + WARP_W - 1, cx);
    const float y0 = ndc(gy, row0, cy);
    const float y1 = ndc(gy, row0 + ROWS_PER_THREAD - 1, cy);

    const int n_entries = n_big + counts[tile];
    const int n_mine = n_entries > rank ? (n_entries - rank + SPLIT - 1) / SPLIT : 0;
    const float* zb = szb != nullptr ? szb + (size_t)tile * (n_big + bin_capacity) : nullptr;
    float tmin = 0.0f;                 // min of this thread's depths (early-z)
    bool done = false;                 // this thread's walk has ended (early-z)
    for (int base = 0; base < n_mine; base += CHUNK) {
        const int n_here = min(CHUNK, n_mine - base);
        for (int i = threadIdx.x; i < n_here * WALK_SLOTS; i += THREADS) {
            const int e = i / WALK_SLOTS;
            const int k = i - e * WALK_SLOTS;
            const int g = (base + e) * SPLIT + rank;     // slot in the tile's sequence
            const int id = g < n_big ? big_ids[g]
                                     : bins[(size_t)tile * bin_capacity + (g - n_big)];
            // invalid entries are zero rows: slot 12 (valid) = 0 never passes
            s_row[e][k] = id >= 0 ? tri_rows[(size_t)id * ROW + k] : 0.0f;
            if (k == 0) s_zb[e] = zb != nullptr ? zb[g] : 2.0f;   // 2: never reached
        }
        __syncthreads();
        for (int e = 0; e < n_here && !done; ++e) {
            if (tmin >= s_zb[e]) { done = true; break; }
            const float* r = s_row[e];
            if (!(r[12] > 0.0f)) continue;
            const float a0 = r[0], b0 = r[1], c0 = r[2];
            const float a1 = r[3], b1 = r[4], c1 = r[5];
            const float a2 = r[6], b2 = r[7], c2 = r[8];
            if (edge_outside(a0, b0, c0, x0, x1, y0, y1)
                || edge_outside(a1, b1, c1, x0, x1, y0, y1)
                || edge_outside(a2, b2, c2, x0, x1, y0, y1)) continue;
            const float az = r[9], bz = r[10], cz = r[11];
            const int g = (base + e) * SPLIT + rank;
#pragma unroll
            for (int p = 0; p < ROWS_PER_THREAD; ++p) {
                const float yn = ndc(gy, row0 + p, cy);
                const float e0 = plane(a0, b0, c0, xn, yn);
                const float e1 = plane(a1, b1, c1, xn, yn);
                const float e2 = plane(a2, b2, c2, xn, yn);
                const float s = (e0 + e1) + e2;
                const float d = plane(az, bz, cz, xn, yn);
                const bool pass = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f)
                                  & (s > 0.0f) & (d > depth[p]) & (d <= 1.0f)
                                  & (d < pl[p]);
                depth[p] = pass ? d : depth[p];
                slot[p] = pass ? g : slot[p];
            }
        }
        if (zb != nullptr) {           // depths only grow: refresh the min
            tmin = depth[0];
#pragma unroll
            for (int p = 1; p < ROWS_PER_THREAD; ++p) tmin = fminf(tmin, depth[p]);
        }
        if (__syncthreads_and(done)) break;
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
    // slot among equal depths; then the winner's planes, ONE perspective
    // divide per pixel
    const size_t plane_size = (size_t)out_h * out_w;
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
        if (g == NO_SLOT) {
#pragma unroll
            for (int j = 0; j < N_PLANES; ++j) v[j] = 0.0f;
            v[1] = -1.0f;
        } else {
            const int id = g < n_big ? big_ids[g]
                                     : bins[(size_t)tile * bin_capacity + (g - n_big)];
            const float* r = tri_rows + (size_t)id * ROW;
            const float yv = ndc(gy, row, cy);
            auto lin = [&](int o) { return plane(r[o], r[o + 1], r[o + 2], xn, yv); };
            const float s = (lin(0) + lin(3)) + lin(6);
            const float rcp = 1.0f / (s == 0.0f ? 1.0f : s);
            v[0] = best;
            v[1] = (float)id;
            v[2] = lin(16) * rcp;            // u
            v[3] = lin(19) * rcp;            // v
            v[4] = lin(22) * rcp;            // normal xyz
            v[5] = lin(25) * rcp;
            v[6] = lin(28) * rcp;
#pragma unroll
            for (int j = 0; j < 10; ++j) v[7 + j] = r[34 + j];   // material, mbase, msize
            v[17] = lin(44) * rcp;           // tangent xyz
            v[18] = lin(47) * rcp;
            v[19] = lin(50) * rcp;
            v[20] = r[53];                   // tangent w
            v[21] = r[56];                   // absorb
        }
        const size_t o = (size_t)(ty * TILE_H + row) * out_w + x;
#pragma unroll
        for (int j = 0; j < N_PLANES; ++j) out[j * plane_size + o] = v[j];
    }
}

}  // namespace

// tri_rows (T, 64) f32; bins (n_tiles, bin_capacity) i32; counts
// (n_tiles,) i32; big_ids (n_big,) i32; peel (out_h, out_w) f32 or null;
// szb (n_tiles, n_big + bin_capacity) f32 early-z bounds or null;
// out (22, out_h, out_w) f32 with out_h = tiles_y * 32 and out_w =
// tiles_x * 128.  cx, cy are 2/width and 2/height of the NDC viewport,
// rounded to f32 by the caller.  A band of tile rows (the tile-sharded
// frame): bins, counts, szb, peel and out hold its tiles only, and ty0 is
// the tile row of the viewport its first row is (0 for the whole frame).
extern "C" int raster_shade_launch(const float* tri_rows, const int* bins,
                                   const int* counts, const int* big_ids,
                                   const float* peel, const float* szb,
                                   int n_big, int bin_capacity, int tiles_x,
                                   int n_tiles, int ty0, float cx, float cy, int out_h,
                                   int out_w, float* out, void* stream)
{
    int dev = 0, n_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_tiles >= 2 * n_sm && n_big + bin_capacity <= 512)
        raster_shade_kernel<2><<<n_tiles * 2, THREADS, 0, (cudaStream_t)stream>>>(
            tri_rows, bins, counts, big_ids, peel, szb, n_big, bin_capacity, tiles_x, ty0,
            cx, cy, out_h, out_w, out);
    else
        raster_shade_kernel<4><<<n_tiles * 4, THREADS, 0, (cudaStream_t)stream>>>(
            tri_rows, bins, counts, big_ids, peel, szb, n_big, bin_capacity, tiles_x, ty0,
            cx, cy, out_h, out_w, out);
    return (int)cudaGetLastError();
}
