// K4: weighted-blend OIT raster (particles + translucent residual).
//
// Replaces the Pallas kernel datum_tpu/ops/raster_pallas.py
// `_blend_kernel` (launched by `raster_blend_pallas` with planes=True),
// in its three modes: soft = 0 (no falloff), 1 (every entry soft) and
// 2 ("per_tri": row slots 34/35 flag soft and peeled triangles of a
// merged stream).
//
// What it computes.  For every pixel of a 32 x 128 tile, the walk goes
// through the frame's big-triangle list, then the tile's counts[tile] bin
// entries, in that order, carrying ar, ag, ab, aw (start 0) and rv (start
// 1).  Per entry: edges e0..e2, s = e0+e1+e2 and depth d at the pixel
// centre; visible = inside & d > opaque depth & d <= 1, and with a peel
// plane d < peel (per_tri: (d < peel) | peel flag <= 0); barycentrics
// l0 = e0/s, l1 = e1/s, l2 = 1 - l0 - l1 (s == 0 guarded); rgba from row
// slots 22-33, alpha times the radial falloff clip(1 - |2uv - 1|^2, 0, 1)
// of slots 16-21 where soft; wgt = clip(10 / (1e-5 + b^3), 0.01, 300) *
// alpha with b = (1 - d) * 5; ar += r*wgt, ag, ab likewise, aw += wgt,
// rv *= 1 - alpha.  The five planes are written once at the end.
//
// What bounds it on the H100.  ~70 f32 operations and two divides per
// (pixel, entry) on coefficients that are uniform across the tile: bound
// by instruction issue, not memory.  The bench frame's merged stream
// (1,024 particle triangles + the residual translucents, bins of 128
// + 32 big entries) touches a few tens of entries per tile; the frame
// reads the opaque depth (and peel) plane and writes 5 planes, ~50 MB at
// 1920x1088.
//
// What the design does about it.
//  * One block per tile, 256 threads, 16 pixels per thread (one column,
//    16 rows), as K1 and K3: the five accumulators, the opaque depth and
//    the peel depth of a thread's 16 pixels stay in registers for the
//    whole walk.  Entry rows (36 floats) are staged in shared memory in
//    chunks of 64, so each coefficient load is a broadcast that feeds 16
//    pixels.
//  * Order is part of the result: the sums and the product are taken in
//    walk order, so each pixel walks its entries sequentially (never
//    atomics).  Invalid entries (id -1) are zero rows, whose terms are
//    exact zeros, so the block skips them uniformly.
//  * Rounding.  The file is built with -fmad=false and writes with
//    __fmaf_rn exactly the fused multiply-adds that XLA's contraction puts
//    into the JAX kernel (the planes, the interpolations, the squared
//    radius, 1e-5 + b^3, the four sums and 1 - ca*falloff), as the plain
//    PyTorch version does, so the two agree bit for bit.
//  * The TPU's 2-entries-per-128-lane packing moves no value and is not
//    carried over.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = TILE_H * TILE_W / THREADS;   // 16
constexpr int CHUNK = 64;          // entries staged per round
constexpr int ROW = 36;            // floats per triangle row

// a*xn + b*yn + c as XLA compiles it: fma(a, xn, b*yn) + c
__device__ __forceinline__ float plane(float a, float b, float c, float xn, float yn) {
    return __fmaf_rn(a, xn, b * yn) + c;
}

// a*l0 + b*l1 + c*l2 as XLA compiles it: fma(c, l2, fma(a, l0, b*l1))
__device__ __forceinline__ float lerp3(const float* r, int o, int step, float l0,
                                       float l1, float l2) {
    return __fmaf_rn(r[o + 2 * step], l2, __fmaf_rn(r[o], l0, r[o + step] * l1));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

__global__ void __launch_bounds__(THREADS)
raster_blend_kernel(const float* __restrict__ rows,
                    const int* __restrict__ bins,
                    const int* __restrict__ counts,
                    const int* __restrict__ big_ids,
                    const float* __restrict__ opaque_depth,   // (out_h, out_w)
                    const float* __restrict__ peel,           // (out_h, out_w) or null
                    int soft_mode, int n_big, int bin_capacity, int tiles_x,
                    float cx, float cy, int out_w,
                    float* __restrict__ out)                  // (5, out_h, out_w)
{
    __shared__ float s_row[CHUNK][ROW];

    const int tile = blockIdx.x;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int col = threadIdx.x % TILE_W;
    const int row0 = (threadIdx.x / TILE_W) * ROWS_PER_THREAD;
    const int x = tx * TILE_W + col;
    const float xn = ((float)(tx * TILE_W) + (float)col + 0.5f) * cx - 1.0f;
    const bool has_peel = peel != nullptr;

    float ar[ROWS_PER_THREAD], ag[ROWS_PER_THREAD], ab[ROWS_PER_THREAD];
    float aw[ROWS_PER_THREAD], rv[ROWS_PER_THREAD];
    float od[ROWS_PER_THREAD], pl[ROWS_PER_THREAD];
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        const size_t o = (size_t)(ty * TILE_H + row0 + p) * out_w + x;
        ar[p] = ag[p] = ab[p] = aw[p] = 0.0f;
        rv[p] = 1.0f;
        od[p] = opaque_depth[o];
        pl[p] = has_peel ? peel[o] : 0.0f;
    }

    const int n_entries = n_big + counts[tile];
    for (int base = 0; base < n_entries; base += CHUNK) {
        const int n_here = min(CHUNK, n_entries - base);
        for (int i = threadIdx.x; i < n_here * ROW; i += THREADS) {
            const int e = i / ROW;
            const int k = i - e * ROW;
            const int g = base + e;
            const int id = g < n_big ? big_ids[g]
                                     : bins[(size_t)tile * bin_capacity + (g - n_big)];
            // invalid entries are zero rows: slot 12 (valid) = 0, skipped below
            s_row[e][k] = id >= 0 ? rows[(size_t)id * ROW + k] : 0.0f;
        }
        __syncthreads();
        for (int e = 0; e < n_here; ++e) {
            const float* r = s_row[e];
            if (!(r[12] > 0.0f)) continue;
            // which tests this entry takes (uniform over the block)
            const bool peel_test = has_peel && (soft_mode != 2 || r[35] > 0.0f);
            const bool soft = soft_mode == 1 || (soft_mode == 2 && r[34] > 0.0f);
#pragma unroll
            for (int p = 0; p < ROWS_PER_THREAD; ++p) {
                const float yn = ((float)(ty * TILE_H) + (float)(row0 + p) + 0.5f) * cy - 1.0f;
                const float e0 = plane(r[0], r[1], r[2], xn, yn);
                const float e1 = plane(r[3], r[4], r[5], xn, yn);
                const float e2 = plane(r[6], r[7], r[8], xn, yn);
                const float s = (e0 + e1) + e2;
                const float d = plane(r[9], r[10], r[11], xn, yn);
                bool visible = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f) & (s > 0.0f)
                               & (d > od[p]) & (d <= 1.0f);
                if (peel_test) visible = visible & (d < pl[p]);
                const float inv = 1.0f / (s == 0.0f ? 1.0f : s);
                const float l0 = e0 * inv;
                const float l1 = e1 * inv;
                const float l2 = (1.0f - l0) - l1;
                const float cr = lerp3(r, 22, 4, l0, l1, l2);
                const float cg = lerp3(r, 23, 4, l0, l1, l2);
                const float cb = lerp3(r, 24, 4, l0, l1, l2);
                float ca = lerp3(r, 25, 4, l0, l1, l2);
                float one_m;                       // 1 - alpha where visible
                if (soft) {
                    const float du = 2.0f * lerp3(r, 16, 2, l0, l1, l2) - 1.0f;
                    const float dv = 2.0f * lerp3(r, 17, 2, l0, l1, l2) - 1.0f;
                    const float falloff = clampf(1.0f - __fmaf_rn(du, du, dv * dv), 0.0f, 1.0f);
                    one_m = __fmaf_rn(-ca, falloff, 1.0f);
                    ca = ca * falloff;
                } else {
                    one_m = 1.0f - ca;
                }
                const float alpha = visible ? ca : 0.0f;
                const float b = (1.0f - d) * 5.0f;
                const float wk = clampf(10.0f / __fmaf_rn(b * b, b, 1e-5f), 0.01f, 300.0f);
                const float wgt = wk * alpha;
                ar[p] = __fmaf_rn(cr, wgt, ar[p]);
                ag[p] = __fmaf_rn(cg, wgt, ag[p]);
                ab[p] = __fmaf_rn(cb, wgt, ab[p]);
                aw[p] = __fmaf_rn(wk, alpha, aw[p]);
                rv[p] = rv[p] * (visible ? one_m : 1.0f);
            }
        }
        __syncthreads();
    }

    const size_t plane_size = (size_t)gridDim.x / tiles_x * TILE_H * out_w;
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        const size_t o = (size_t)(ty * TILE_H + row0 + p) * out_w + x;
        out[o] = ar[p];
        out[plane_size + o] = ag[p];
        out[2 * plane_size + o] = ab[p];
        out[3 * plane_size + o] = aw[p];
        out[4 * plane_size + o] = rv[p];
    }
}

}  // namespace

// rows (T, 36) f32; bins (n_tiles, bin_capacity) i32; counts (n_tiles,)
// i32; big_ids (n_big,) i32; opaque_depth and peel (or null) (out_h,
// out_w) f32; out (5, out_h, out_w) f32 with out_h = (n_tiles / tiles_x)
// * 32 and out_w = tiles_x * 128.  cx, cy are 2/width and 2/height of the
// NDC viewport, rounded to f32 by the caller.
extern "C" int raster_blend_launch(const float* rows, const int* bins, const int* counts,
                                   const int* big_ids, const float* opaque_depth,
                                   const float* peel, int soft_mode, int n_big,
                                   int bin_capacity, int tiles_x, int n_tiles, float cx,
                                   float cy, int out_w, float* out, void* stream)
{
    raster_blend_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        rows, bins, counts, big_ids, opaque_depth, peel, soft_mode, n_big, bin_capacity,
        tiles_x, cx, cy, out_w, out);
    return (int)cudaGetLastError();
}
