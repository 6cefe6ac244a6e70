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
// depend on the walk order.
//
// What bounds it on the H100.  ~20 f32 operations per (pixel, entry)
// on coefficients that are uniform across the tile: bound by instruction
// throughput, not memory.  The shadow stacks are small (656 tiles of
// 32 x 128 in the bench frame) and one map is 4 bytes a texel, so memory
// traffic is a few MB a frame.
//
// What the design does about it.
//  * One block per tile, 256 threads, 16 pixels per thread (one column,
//    16 rows), as K1.  Entry rows (16 floats) are staged in shared
//    memory in chunks of 64 entries, so each coefficient load is a
//    broadcast that feeds 16 pixels.  The carry is one depth per pixel,
//    in registers.
//  * Invalid entries (id -1: unused big-list slots) are zero rows and
//    are skipped uniformly by the whole block.
//  * Early-z (szb given: per tile and walk slot, the suffix max of the
//    entries' depth upper bounds, from the binning's depth bands): as in
//    K1 (raster_shade.cu), a thread stops at the first slot whose bound
//    its min depth reaches (no later entry can pass the strict d > depth
//    test, so the map is the same bit for bit), the block when all its
//    threads have (__syncthreads_and).
//  * The TPU kernel's lane packing (8 triangles per 128-lane row, 16
//    tiles per grid step) moves no value and is not carried over.
//  * Rounding.  The JAX kernel writes each plane as a*xn + b*yn + c,
//    and XLA contracts that into fma(a, xn, b*yn) + c (bit-equal on
//    every texel of the parity tests' cascade and spot stacks).  K3
//    evaluates exactly that with an explicit __fmaf_rn; the file is
//    built with -fmad=false, so nvcc contracts nothing else, and the
//    plain PyTorch version computes the same fused products (an exact
//    f64 product, one rounding), so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = TILE_H * TILE_W / THREADS;   // 16
constexpr int CHUNK = 64;          // entries staged per round
constexpr int ROW = 16;            // floats per triangle row (row16)

__global__ void __launch_bounds__(THREADS)
raster_depth_kernel(const float* __restrict__ rows,
                    const int* __restrict__ bins,
                    const int* __restrict__ counts,
                    const int* __restrict__ big_ids,
                    const float* __restrict__ szb,      // (n_tiles, n_big + bin_capacity) or null
                    int n_big, int bin_capacity, int tiles_x,
                    float cx, float cy, int out_w,
                    float* __restrict__ out)
{
    __shared__ float s_row[CHUNK][ROW];
    __shared__ float s_zb[CHUNK];

    const int tile = blockIdx.x;
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

    const int n_entries = n_big + counts[tile];
    const float* zb = szb != nullptr ? szb + (size_t)tile * (n_big + bin_capacity) : nullptr;
    float tmin = 0.0f;                 // min of this thread's depths (early-z)
    bool done = false;                 // this thread's walk has ended (early-z)
    for (int base = 0; base < n_entries; base += CHUNK) {
        const int n_here = min(CHUNK, n_entries - base);
        for (int i = threadIdx.x; i < n_here * ROW; i += THREADS) {
            const int e = i / ROW;
            const int k = i - e * ROW;
            const int g = base + e;
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
            const float a0 = r[0], b0 = r[1], c0 = r[2];
            const float a1 = r[3], b1 = r[4], c1 = r[5];
            const float a2 = r[6], b2 = r[7], c2 = r[8];
            const float az = r[9], bz = r[10], cz = r[11];
            const float ylo = r[14], yhi = r[15];
#pragma unroll
            for (int p = 0; p < ROWS_PER_THREAD; ++p) {
                const float e0 = __fmaf_rn(a0, xn, b0 * yn[p]) + c0;
                const float e1 = __fmaf_rn(a1, xn, b1 * yn[p]) + c1;
                const float e2 = __fmaf_rn(a2, xn, b2 * yn[p]) + c2;
                const float s = (e0 + e1) + e2;
                const float d = __fmaf_rn(az, xn, bz * yn[p]) + cz;
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

    const int x = tx * TILE_W + col;
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        const int y = ty * TILE_H + row0 + p;
        out[(size_t)y * out_w + x] = depth[p];
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
    raster_depth_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        rows, bins, counts, big_ids, szb, n_big, bin_capacity, tiles_x, cx, cy,
        out_w, out);
    return (int)cudaGetLastError();
}
