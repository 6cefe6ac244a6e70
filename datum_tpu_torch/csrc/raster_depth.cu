// K3: depth-only raster with a per-triangle y scissor (shadow maps).
//
// Replaces the Pallas kernel datum_tpu/ops/raster_pallas.py
// `_depth_kernel` (launched by `raster_depth_pallas`), with its
// optional early-z exit.  It renders the stacked sun-cascade atlases and
// the stacked parabolic spot maps.
//
// What it computes.  For every pixel of a 32 x 128 tile, depth starts at
// 0 and the walk goes through the frame's big-triangle list, then the
// tile's counts[tile] bin entries.  Per entry: three edge functions
// e_k = a_k*xn + b_k*yn + c_k from the sign-fixed adjugate rows (slots
// 0-8), the depth plane d (slots 9-11), and the test
//   e0, e1, e2 >= 0, s = e0+e1+e2 > 0, valid (slot 12) > 0,
//   ylo (slot 14) <= yn < yhi (slot 15), d > depth, d <= 1,
// which keeps d.  The result is the max passing depth, so it does not
// depend on the walk order, nor on how the walk is split.
//
// What bounds it on the H100.  ~18 f32 operations per (pixel, entry)
// on coefficients that are uniform across the tile: bound by instruction
// throughput, not memory (a map is 4 bytes a texel, a few MB a frame).
// The work is uneven: most shadow tiles are empty, and a few hold full
// bins (128 entries) beside the big list that every tile walks.  With
// one block a tile, that block's walk set the kernel's time while most
// SMs sat idle.
//
// What the design does about it.
//  * One tile's walk is split over a thread-block cluster of SPLIT blocks
//    (grid n_tiles * SPLIT).  Block r walks the slots g = r (mod SPLIT)
//    of the tile's sequence (the big list, then the bin), which spreads
//    both evenly.  SPLIT is 8, or 4 where the stack has at least twice as
//    many tiles as the card has SMs (the near cascades, the stress
//    stack): there 4 blocks a tile fill the card twice over, and halving
//    the blocks halves their fixed costs (measured on the bench stacks:
//    near cascades 0.052 ms at 4 vs 0.058 at 8, far cascades 0.030 vs
//    0.023, the spot map 0.026 vs 0.015).  Each block stages only its own entries (16-float rows, in
//    chunks of 64) in shared memory: every coefficient load is a
//    broadcast that feeds 16 pixels.  256 threads a block, 16 pixels a
//    thread (one column, 16 rows), one depth per pixel in registers.
//  * The partial maps are combined through distributed shared memory:
//    block r reduces rows r*32/SPLIT.. of the tile.  After its walk each
//    block stores each of its partial rows into the shared memory of the
//    block that reduces it (SPLIT slices of 32/SPLIT x 128 a block, 16
//    KB); after cluster.sync() each block takes the max over the slices
//    it holds
//    and stores its rows with coalesced plain stores.  Stores to a peer
//    need no reply, and after the barrier no block reads another's
//    memory, so one full cluster barrier does (the split arrive/wait at
//    the start only makes sure every peer runs before its memory is
//    written).  Each texel is written once, with no memset and no
//    atomics.  The max of the partial maxima is the max of the same
//    passing depths under the same strict test: bit-identical to one
//    block walking every entry.
//  * __launch_bounds__(256, 4): at most 64 registers, 4 blocks an SM (75
//    registers and 3 blocks without): most tiles are nearly empty, and
//    their blocks' fixed costs (the staging loads, the barriers) hide
//    behind each other.
//  * A warp-uniform rectangle reject.  Warp w covers 32 columns x 16
//    rows.  Before the 16-pixel loop the warp skips an entry whose y
//    scissor misses its rows (the same yn values, so exact), or one of
//    whose edge functions is below 0 on the whole rectangle: its value at
//    the rectangle's corner where the exact affine function is largest,
//    plus the margin below, is < 0.  ops/raster_depth_cuda.py holds a
//    plain twin (`warp_rect_reject`) with the same arithmetic, and the
//    CPU tests hold it against the plain raster: it only ever skips
//    entries that pass at no pixel of the rectangle.
//  * The margin.  A pixel's edge value is e = fl(fl(a*x + fl(b*y)) + c)
//    (one fma, then an add), u = 2^-24.  With A = |a||x|, B = |b||y|,
//    C = |c|, its error against the exact a*x + b*y + c is at most
//      u*B + u*(A + B(1+u)) + u*(A+B+C)(1+3u) <= (3u + 4u^2)(A+B+C).
//    Over the rectangle |x| <= mx and |y| <= my, so with S = |a|mx +
//    |b|my + |c| both the pixel's value and the corner's are within
//    E = (3u + 4u^2) S of exact, and the exact value at every pixel is at
//    most the exact corner value: e_pixel <= e_corner + 2E.  The margin
//    is fl(S) * 8u + 1e-36: fl(S) >= S(1 - 3u), so it is at least
//    8uS(1 - 3u) >= (6u + 8u^2) S = 2E, and the 1e-36 covers the
//    absolute error of gradual underflow (< 2^-150 an operation).  If
//    fl(e_corner + margin) < 0 then e_corner + margin < 0 exactly, so
//    e_pixel < 0 at every pixel: the entry fails e >= 0 there.  A NaN or
//    infinite coefficient makes the margin NaN or infinite and never
//    rejects.  (Rounding is monotone, so the corner chosen by the signs
//    of a and b also computes the largest value of any pixel of the
//    rectangle through the same fma and add: the test would hold with no
//    margin.  The margin keeps it sound where the two were computed
//    apart, for a cost of five operations an edge.)
//  * Early-z (szb given: per tile and walk slot, the suffix max of the
//    entries' depth upper bounds over the whole sequence) stays valid per
//    block: a thread stops at its slot g once the min of its partial
//    depths reaches szb[g].  Its partial depths are at most the full
//    ones, and szb[g] bounds every later entry of its own walk too, so no
//    later entry could pass d > depth at its pixels.  The block stops
//    when all its threads have (__syncthreads_and).
//  * Invalid entries (id -1: unused big-list slots) are zero rows and
//    are skipped uniformly by the whole block.
//  * The TPU kernel's lane packing (8 triangles per 128-lane row, 16
//    tiles per grid step) moves no value and is not carried over.
//  * Rounding.  The JAX kernel writes each plane as a*xn + b*yn + c,
//    and XLA contracts that into fma(a, xn, b*yn) + c (bit-equal on
//    every texel of the parity tests' cascade and spot stacks).  K3
//    evaluates exactly that with an explicit __fmaf_rn; the file is
//    built with -fmad=false, so nvcc contracts nothing else, and the
//    plain PyTorch version computes the same fused products (an exact
//    f64 product, one rounding), so the two agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = TILE_H * TILE_W / THREADS;   // 16
constexpr int CHUNK = 64;          // entries staged per round
constexpr int ROW = 16;            // floats per triangle row (row16)
constexpr int WARP_W = 32;         // a warp's rectangle: 32 columns x 16 rows
constexpr float REJECT_REL = 8.0f / 16777216.0f;   // 8u, u = 2^-24
constexpr float REJECT_ABS = 1e-36f;

__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
    return __fmaf_rn(a, x, b * y) + c;
}

// True when the edge a*x + b*y + c is below 0 at every pixel of the
// rectangle [x0, x1] x [y0, y1] (see the margin above).
__device__ __forceinline__ bool edge_outside(float a, float b, float c, float x0,
                                             float x1, float y0, float y1) {
    const float mx = fmaxf(fabsf(x0), fabsf(x1));
    const float my = fmaxf(fabsf(y0), fabsf(y1));
    const float margin = (fabsf(a) * mx + fabsf(b) * my + fabsf(c)) * REJECT_REL
                         + REJECT_ABS;
    return plane(a, b, c, a > 0.0f ? x1 : x0, b > 0.0f ? y1 : y0) + margin < 0.0f;
}

template <int SPLIT>                // blocks of a cluster: one tile's walk
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS, 4)
raster_depth_kernel(const float* __restrict__ rows,
                    const int* __restrict__ bins,
                    const int* __restrict__ counts,
                    const int* __restrict__ big_ids,
                    const float* __restrict__ szb,      // (n_tiles, n_big + bin_capacity) or null
                    int n_big, int bin_capacity, int tiles_x,
                    float cx, float cy, int out_w,
                    float* __restrict__ out)
{
    constexpr int ROWS_PER_RANK = TILE_H / SPLIT;
    __shared__ float s_row[CHUNK][ROW];
    __shared__ float s_zb[CHUNK];
    __shared__ float s_recv[SPLIT][ROWS_PER_RANK * TILE_W];   // the rows this block reduces

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    // this block runs: its peers may write into s_recv once all have arrived
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    const int tile = blockIdx.x / SPLIT;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int col = threadIdx.x % TILE_W;
    const int row0 = (threadIdx.x / TILE_W) * ROWS_PER_THREAD;

    const float xn = ((float)(tx * TILE_W) + (float)col + 0.5f) * cx - 1.0f;
    float yn[ROWS_PER_THREAD];
    float depth[ROWS_PER_THREAD];
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        yn[p] = ((float)(ty * TILE_H) + (float)(row0 + p) + 0.5f) * cy - 1.0f;
        depth[p] = 0.0f;
    }
    // the warp's rectangle: its first and last column's xn, its rows' yn
    const int wcol = col - col % WARP_W;
    const float x0 = ((float)(tx * TILE_W) + (float)wcol + 0.5f) * cx - 1.0f;
    const float x1 = ((float)(tx * TILE_W) + (float)(wcol + WARP_W - 1) + 0.5f) * cx
                     - 1.0f;
    const float y0 = yn[0], y1 = yn[ROWS_PER_THREAD - 1];

    const int n_entries = n_big + counts[tile];
    const int n_mine = n_entries > rank ? (n_entries - rank + SPLIT - 1) / SPLIT : 0;
    const float* zb = szb != nullptr ? szb + (size_t)tile * (n_big + bin_capacity) : nullptr;
    float tmin = 0.0f;                 // min of this thread's depths (early-z)
    bool done = false;                 // this thread's walk has ended (early-z)
    for (int base = 0; base < n_mine; base += CHUNK) {
        const int n_here = min(CHUNK, n_mine - base);
        for (int i = threadIdx.x; i < n_here * ROW; i += THREADS) {
            const int e = i / ROW;
            const int k = i - e * ROW;
            const int g = (base + e) * SPLIT + rank;     // slot in the tile's sequence
            const int id = g < n_big ? big_ids[g]
                                     : bins[(size_t)tile * bin_capacity + (g - n_big)];
            // invalid entries are zero rows: slot 12 (valid) = 0 never passes
            s_row[e][k] = id >= 0 ? rows[(size_t)id * ROW + k] : 0.0f;
            if (k == 0) s_zb[e] = zb != nullptr ? zb[g] : 2.0f;   // 2: never reached
        }
        __syncthreads();
        for (int e = 0; e < n_here && !done; ++e) {
            if (tmin >= s_zb[e]) { done = true; break; }
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
#pragma unroll
            for (int p = 0; p < ROWS_PER_THREAD; ++p) {
                const float e0 = plane(a0, b0, c0, xn, yn[p]);
                const float e1 = plane(a1, b1, c1, xn, yn[p]);
                const float e2 = plane(a2, b2, c2, xn, yn[p]);
                const float s = (e0 + e1) + e2;
                const float d = plane(az, bz, cz, xn, yn[p]);
                const bool pass = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f)
                                  & (s > 0.0f) & (yn[p] >= ylo) & (yn[p] < yhi)
                                  & (d > depth[p]) & (d <= 1.0f);
                depth[p] = pass ? d : depth[p];
            }
        }
        if (zb != nullptr) {           // depths only grow: refresh the min
            tmin = depth[0];
#pragma unroll
            for (int p = 1; p < ROWS_PER_THREAD; ++p) tmin = fminf(tmin, depth[p]);
        }
        if (__syncthreads_and(done)) break;
    }

    // combine: each block sends rank q its rows of q's slice; after the
    // barrier each block takes the max over the 8 slices it received
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        const int row = row0 + p;
        float* dst = cluster.map_shared_rank(&s_recv[rank][0], row / ROWS_PER_RANK);
        dst[(row % ROWS_PER_RANK) * TILE_W + col] = depth[p];
    }
    cluster.sync();
    for (int i = threadIdx.x; i < ROWS_PER_RANK * TILE_W; i += THREADS) {
        float m = 0.0f;
#pragma unroll
        for (int q = 0; q < SPLIT; ++q) m = fmaxf(m, s_recv[q][i]);
        const int y = ty * TILE_H + rank * ROWS_PER_RANK + i / TILE_W;
        out[(size_t)y * out_w + tx * TILE_W + i % TILE_W] = m;
    }
}

}  // namespace

// rows (T, 16) f32 (the setup's row16); bins (n_tiles, bin_capacity) i32;
// counts (n_tiles,) i32; big_ids (n_big,) i32; szb (n_tiles, n_big +
// bin_capacity) f32 early-z bounds or null; out (out_h, out_w) f32
// with out_h = tiles_y * 32 and out_w = tiles_x * 128.  cx, cy are
// 2/width and 2/height of the NDC viewport, rounded to f32 by the caller.
extern "C" int raster_depth_launch(const float* rows, const int* bins,
                                   const int* counts, const int* big_ids,
                                   const float* szb, int n_big, int bin_capacity,
                                   int tiles_x, int n_tiles, float cx, float cy,
                                   int out_w, float* out, void* stream)
{
    int dev = 0, n_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_tiles >= 2 * n_sm)
        raster_depth_kernel<4><<<n_tiles * 4, THREADS, 0, (cudaStream_t)stream>>>(
            rows, bins, counts, big_ids, szb, n_big, bin_capacity, tiles_x, cx, cy,
            out_w, out);
    else
        raster_depth_kernel<8><<<n_tiles * 8, THREADS, 0, (cudaStream_t)stream>>>(
            rows, bins, counts, big_ids, szb, n_big, bin_capacity, tiles_x, cx, cy,
            out_w, out);
    return (int)cudaGetLastError();
}
