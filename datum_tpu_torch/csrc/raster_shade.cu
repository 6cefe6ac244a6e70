// K1: fused visibility raster with attribute/material interpolation.
//
// Replaces the Pallas kernel datum_tpu/ops/raster_pallas.py
// `_raster_shade_kernel` (launched by `raster_shade_pallas`), in its
// extended form (tangent + material-map planes), with the optional peel
// plane of the lit translucent layers and the optional early-z exit.
// (alpha_in_alb is host work: the row builder puts the material alpha in
// slot 41.)
//
// What it computes.  For every pixel of a 32 x 128 tile it walks the
// frame's big-triangle list, then the tile's bin entries, in order.  Per
// entry: three edge functions e_k = a_k*xn + b_k*yn + c_k from the
// sign-fixed adjugate rows, the inside test (all e >= 0, s = e0+e1+e2 > 0,
// valid slot > 0), the depth plane d, and the strict reverse-Z test
// d > depth && d <= 1 (and d < peel when a peel plane is given: the
// fragment must lie strictly behind the previous lit layer).  The last
// entry that passes wins (ties keep the earlier entry: the test is
// strict).  After the walk the winner's numerator planes are evaluated
// once and divided by its s.
//
// What bounds it on the H100.  The walk is ~20 f32 operations per
// (pixel, entry) with coefficients that are uniform across the tile, so
// it is bound by issue rate, not memory: one frame reads ~E rows of 13
// floats per tile and writes 22 f32 planes (~190 MB at 1920x1088).
//
// What the design does about it.
//  * One block per tile, 256 threads, 16 pixels per thread (one column,
//    16 rows).  Entry rows are staged in shared memory in chunks of 64,
//    so each coefficient load is a broadcast and feeds 16 pixels.
//  * The per-pixel carry is only (depth, winning triangle id) in
//    registers, not the 23 planes the TPU kernel carries in VMEM: the
//    carried planes are, by construction, the winner's values at the
//    pixel, so evaluating them from the winner's row after the walk is
//    the same arithmetic on the same inputs (bit-identical), and the
//    walk does 5x less work per entry.
//  * The per-triangle 64-float attribute rows are gathered by id in the
//    epilogue instead of materialising (n_tiles, E, 64) rows.
//  * Entries are walked sequentially per pixel (never atomics), which
//    keeps the JAX package's tie order.
//  * Early-z (szb given: per tile and walk slot, the suffix max of the
//    entries' depth upper bounds).  The TPU kernel skips a group once
//    the tile's min depth reaches its bound, by a lax.cond per group.
//    Here each thread keeps the min of its 16 depths, refreshed once a
//    chunk, and stops walking at the first slot whose bound it reaches:
//    every later entry is bounded by that suffix max, and the test
//    d > depth is strict, so none of them could pass (the planes are bit
//    for bit those of the full walk).  The chunk loop ends when every
//    thread of the block has stopped (__syncthreads_and), so no thread
//    leaves a barrier behind.
//  * Rounding.  The JAX kernel writes each plane as a*xn + b*yn + c and
//    XLA contracts that into fma(a, xn, b*yn) + c.  K1 evaluates every
//    plane (edges, depth, numerator planes) exactly so, with an explicit
//    __fmaf_rn, as K3 does; the file is built with -fmad=false, so nvcc
//    contracts nothing else, and the plain PyTorch version computes the
//    same fused products, so edge pixels pick the same winner on the card
//    as on the CPU.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = TILE_H * TILE_W / THREADS;   // 16
constexpr int CHUNK = 64;          // entries staged per round
constexpr int WALK_SLOTS = 13;     // row slots the walk reads (0..12)
constexpr int ROW = 64;            // floats per triangle row
constexpr int N_PLANES = 22;

// a*xn + b*yn + c as XLA compiles it: fma(a, xn, b*yn) + c
__device__ __forceinline__ float plane(float a, float b, float c, float xn, float yn) {
    return __fmaf_rn(a, xn, b * yn) + c;
}

__global__ void __launch_bounds__(THREADS)
raster_shade_kernel(const float* __restrict__ tri_rows,
                    const int* __restrict__ bins,
                    const int* __restrict__ counts,
                    const int* __restrict__ big_ids,
                    const float* __restrict__ peel,     // (out_h, out_w) or null
                    const float* __restrict__ szb,      // (n_tiles, n_big + bin_capacity) or null
                    int n_big, int bin_capacity, int tiles_x,
                    float cx, float cy, int out_h, int out_w,
                    float* __restrict__ out)
{
    __shared__ float s_row[CHUNK][WALK_SLOTS];
    __shared__ int s_id[CHUNK];
    __shared__ float s_zb[CHUNK];

    const int tile = blockIdx.x;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int col = threadIdx.x % TILE_W;
    const int row0 = (threadIdx.x / TILE_W) * ROWS_PER_THREAD;

    const float xn = ((float)(tx * TILE_W) + (float)col + 0.5f) * cx - 1.0f;
    const int x = tx * TILE_W + col;
    float yn[ROWS_PER_THREAD];
    float depth[ROWS_PER_THREAD];
    float pl[ROWS_PER_THREAD];         // peel depth (2 = no peel: d <= 1 < 2)
    int win[ROWS_PER_THREAD];
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        const int y = ty * TILE_H + row0 + p;
        yn[p] = ((float)(ty * TILE_H) + (float)(row0 + p) + 0.5f) * cy - 1.0f;
        depth[p] = 0.0f;
        pl[p] = peel != nullptr ? peel[(size_t)y * out_w + x] : 2.0f;
        win[p] = -1;
    }

    const int n_entries = n_big + counts[tile];
    const float* zb = szb != nullptr ? szb + (size_t)tile * (n_big + bin_capacity) : nullptr;
    float tmin = 0.0f;                 // min of this thread's depths (early-z)
    bool done = false;                 // this thread's walk has ended (early-z)
    for (int base = 0; base < n_entries; base += CHUNK) {
        const int n_here = min(CHUNK, n_entries - base);
        for (int i = threadIdx.x; i < n_here * WALK_SLOTS; i += THREADS) {
            const int e = i / WALK_SLOTS;
            const int k = i - e * WALK_SLOTS;
            const int g = base + e;
            const int id = g < n_big ? big_ids[g]
                                     : bins[(size_t)tile * bin_capacity + (g - n_big)];
            // invalid entries are zero rows: slot 12 (valid) = 0 never passes
            s_row[e][k] = id >= 0 ? tri_rows[(size_t)id * ROW + k] : 0.0f;
            if (k == 0) {
                s_id[e] = id;
                s_zb[e] = zb != nullptr ? zb[g] : 2.0f;   // 2: never reached
            }
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
            const int id = s_id[e];
#pragma unroll
            for (int p = 0; p < ROWS_PER_THREAD; ++p) {
                const float e0 = plane(a0, b0, c0, xn, yn[p]);
                const float e1 = plane(a1, b1, c1, xn, yn[p]);
                const float e2 = plane(a2, b2, c2, xn, yn[p]);
                const float s = (e0 + e1) + e2;
                const float d = plane(az, bz, cz, xn, yn[p]);
                const bool pass = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f)
                                  & (s > 0.0f) & (d > depth[p]) & (d <= 1.0f)
                                  & (d < pl[p]);
                depth[p] = pass ? d : depth[p];
                win[p] = pass ? id : win[p];
            }
        }
        if (zb != nullptr) {           // depths only grow: refresh the min
            tmin = depth[0];
#pragma unroll
            for (int p = 1; p < ROWS_PER_THREAD; ++p) tmin = fminf(tmin, depth[p]);
        }
        if (__syncthreads_and(done)) break;
    }

    // epilogue: the winner's planes, ONE perspective divide per pixel
    const size_t plane_size = (size_t)out_h * out_w;
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        const int y = ty * TILE_H + row0 + p;
        float v[N_PLANES];
        const int id = win[p];
        if (id < 0) {
#pragma unroll
            for (int j = 0; j < N_PLANES; ++j) v[j] = 0.0f;
            v[1] = -1.0f;
        } else {
            const float* r = tri_rows + (size_t)id * ROW;
            const float yv = yn[p];
            auto lin = [&](int o) { return plane(r[o], r[o + 1], r[o + 2], xn, yv); };
            const float s = (lin(0) + lin(3)) + lin(6);
            const float rcp = 1.0f / (s == 0.0f ? 1.0f : s);
            v[0] = depth[p];
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
        const size_t o = (size_t)y * out_w + x;
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
// rounded to f32 by the caller.
extern "C" int raster_shade_launch(const float* tri_rows, const int* bins,
                                   const int* counts, const int* big_ids,
                                   const float* peel, const float* szb,
                                   int n_big, int bin_capacity, int tiles_x,
                                   int n_tiles, float cx, float cy, int out_h,
                                   int out_w, float* out, void* stream)
{
    raster_shade_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        tri_rows, bins, counts, big_ids, peel, szb, n_big, bin_capacity, tiles_x, cx,
        cy, out_h, out_w, out);
    return (int)cudaGetLastError();
}
