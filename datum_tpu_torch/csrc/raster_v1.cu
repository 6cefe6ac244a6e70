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
// planes).
//
// What the design does about it.
//  * One block per tile, 256 threads, 16 pixels per thread (one column,
//    16 rows).  Entry rows are staged in shared memory 64 at a time, so
//    each coefficient load is a broadcast that feeds 16 pixels.
//  * The carry is (depth, winning id) in registers; l0 and l1 are
//    evaluated once after the walk from the winner's row.  The Pallas
//    kernel carries them through the walk, but the carried values are
//    the winner's, computed by the same operations: the same bits.
//  * Entries are walked in order per pixel (never atomics): the JAX
//    package's tie order.
//  * Rounding.  XLA compiles the JAX kernel's a*xn + b*yn + c as
//    fma(a, xn, b*yn) + c; every plane here is written so with
//    __fmaf_rn, and the file is built with -fmad=false so nvcc contracts
//    nothing else.  The plain PyTorch version computes the same fused
//    products, so edge pixels pick the same winner on the card as on
//    the CPU.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = TILE_H * TILE_W / THREADS;   // 16
constexpr int CHUNK = 64;          // entries staged per round
constexpr int ROW = 16;            // floats per triangle row

// a*xn + b*yn + c as XLA compiles it: fma(a, xn, b*yn) + c
__device__ __forceinline__ float plane(float a, float b, float c, float xn, float yn) {
    return __fmaf_rn(a, xn, b * yn) + c;
}

__global__ void __launch_bounds__(THREADS)
raster_v1_kernel(const float* __restrict__ tri_rows,
                 const int* __restrict__ bins,
                 const int* __restrict__ counts,
                 const int* __restrict__ big_ids,
                 int n_big, int bin_capacity, int tiles_x,
                 float cx, float cy, int out_w, size_t plane_size,
                 float* __restrict__ out)
{
    __shared__ float s_row[CHUNK][ROW];
    __shared__ int s_id[CHUNK];

    const int tile = blockIdx.x;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int col = threadIdx.x % TILE_W;
    const int row0 = (threadIdx.x / TILE_W) * ROWS_PER_THREAD;

    const float xn = ((float)(tx * TILE_W) + (float)col + 0.5f) * cx - 1.0f;
    const int x = tx * TILE_W + col;
    float yn[ROWS_PER_THREAD];
    float depth[ROWS_PER_THREAD];
    int win[ROWS_PER_THREAD];
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        yn[p] = ((float)(ty * TILE_H) + (float)(row0 + p) + 0.5f) * cy - 1.0f;
        depth[p] = 0.0f;
        win[p] = -1;
    }

    // the big slots first (compacted: the empty ones hold -1), then the
    // tile's bin range
    const int n_entries = n_big + counts[tile];
    for (int base = 0; base < n_entries; base += CHUNK) {
        const int n_here = min(CHUNK, n_entries - base);
        for (int i = threadIdx.x; i < n_here * ROW; i += THREADS) {
            const int e = i / ROW;
            const int k = i - e * ROW;
            const int g = base + e;
            const int id = g < n_big ? big_ids[g]
                                     : bins[(size_t)tile * bin_capacity + (g - n_big)];
            // empty slots are zero rows: slot 12 (valid) = 0 never passes
            s_row[e][k] = id >= 0 ? tri_rows[(size_t)id * ROW + k] : 0.0f;
            if (k == 0) s_id[e] = id;
        }
        __syncthreads();
        for (int e = 0; e < n_here; ++e) {
            const float* r = s_row[e];
            if (!(r[12] > 0.0f)) continue;
            const float a0 = r[0], b0 = r[1], c0 = r[2];
            const float a1 = r[3], b1 = r[4], c1 = r[5];
            const float a2 = r[6], b2 = r[7], c2 = r[8];
            const float az = r[9], bz = r[10], cz = r[11];
            const float ylo = r[14], yhi = r[15];
            const int id = s_id[e];
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
                win[p] = pass ? id : win[p];
            }
        }
        __syncthreads();
    }

    // epilogue: the winner's barycentrics, one reciprocal per pixel
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        const int y = ty * TILE_H + row0 + p;
        const int id = win[p];
        float vis = -1.0f, l0 = 0.0f, l1 = 0.0f;
        if (id >= 0) {
            const float* r = tri_rows + (size_t)id * ROW;
            const float e0 = plane(r[0], r[1], r[2], xn, yn[p]);
            const float e1 = plane(r[3], r[4], r[5], xn, yn[p]);
            const float e2 = plane(r[6], r[7], r[8], xn, yn[p]);
            const float s = (e0 + e1) + e2;
            const float inv_s = 1.0f / (s == 0.0f ? 1.0f : s);
            vis = (float)id;
            l0 = e0 * inv_s;
            l1 = e1 * inv_s;
        }
        const size_t o = (size_t)y * out_w + x;
        out[o] = depth[p];
        out[plane_size + o] = vis;
        out[2 * plane_size + o] = l0;
        out[3 * plane_size + o] = l1;
    }
}

}  // namespace

// tri_rows (T, 16) f32 (the setup's row16); bins (n_tiles, bin_capacity)
// i32; counts (n_tiles,) i32; big_ids (n_big,) i32; out (4, out_h, out_w)
// f32 = depth, visf, l0, l1 with out_h = tiles_y * 32 and out_w =
// tiles_x * 128.  cx, cy are 2/width and 2/height, rounded to f32 by the
// caller.
extern "C" int raster_v1_launch(const float* tri_rows, const int* bins,
                                const int* counts, const int* big_ids,
                                int n_big, int bin_capacity, int tiles_x,
                                int n_tiles, float cx, float cy, int out_w,
                                float* out, void* stream)
{
    const size_t plane_size = (size_t)(n_tiles / tiles_x) * TILE_H * out_w;
    raster_v1_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        tri_rows, bins, counts, big_ids, n_big, bin_capacity, tiles_x, cx, cy,
        out_w, plane_size, out);
    return (int)cudaGetLastError();
}
