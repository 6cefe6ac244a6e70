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
//  * Two blocks a tile, one over each 16-row half (grid n_tiles * 2), 256
//    threads a block, 8 pixels a thread (one column, 8 rows): the five
//    accumulators, the opaque depth and the peel depth of a thread's 8
//    pixels stay in registers for the whole walk, and at most 128
//    registers a thread (__launch_bounds__(256, 2)) let two blocks or
//    more share an SM (one block of 16 pixels a thread held 201).  Each
//    pixel still walks all of its entries in order.  Each block stages
//    the tile's entry rows (36 floats) in shared memory in chunks of 64,
//    so each coefficient load is a broadcast that feeds 8 pixels.  yn is
//    recomputed from the row index (the same bits) instead of carried.
//  * Order is part of the result: the sums and the product are taken in
//    walk order, so each pixel walks its entries sequentially (never
//    atomics, never a split walk, whose partial sums would round apart).
//    Invalid entries (id -1) are zero rows, whose terms are exact zeros,
//    so the block skips them uniformly.
//  * A warp-uniform rectangle reject that changes no bit.  Warp w covers
//    32 columns x 8 rows.  It skips an entry where (1) one of its edges is
//    below 0 on the whole rectangle, by K3's corner test and margin
//    (raster_depth.cu derives it), so that visible is false at every
//    pixel there, and (2) every term the entry adds there is finite.  A
//    skipped pixel's step is then an exact no-op: alpha = 0, wgt = wk * 0
//    = +0 with wk in [0.01, 300] (d is finite, see below, so 10 / (1e-5
//    + b^3) is not NaN), ar = fma(cr, +0, ar) = ar and aw alike
//    (ar never holds -0: it starts at +0 and an exact zero sum rounds to
//    +0), rv *= 1.  But the step multiplies cr * wgt at every pixel, as the
//    JAX kernel and the plain version do, and where s = e0+e1+e2 nears 0
//    off the triangle (its horizon line) l0 = e0/s overflows and an
//    invisible pixel's inf * 0 turns ar to NaN.  So (2) asks that s stays
//    well above 0 and the colour and depth coefficients bounded there:
//    with the summed plane (A, B, C) = fl((a0 + a1) + a2), ..., and T =
//    sum of the edges' |a|mx + |b|my + |c| (mx, my as in K3's margin), a
//    pixel's computed s is within ~10.1u T of A*x + B*y + C at the corner
//    that minimises it (the edges' and the corner plane's rounding, the
//    two adds of s and the rounding of A, B, C), so
//      s_lo = fl(corner plane - (fl(T) * 16u + 1e-36))
//    is below every pixel's s.  The reject asks s_lo >= 2^-100 (1/s is
//    finite), fl(T) <= 2^60 s_lo (|l0|, |l1| <= 2^60 (1 + 15u), |l2| <= 1 +
//    |l0| + |l1|, with some slack), the 9 colour coefficients of cr, cg,
//    cb and the 3 depth coefficients at most 2^60 in magnitude (so |cr|
//    <= ~2^122 and d is finite).
//    NaN coefficients fail these tests and are walked.  Otherwise the
//    entry is walked.  ops/raster_blend_cuda.py holds the plain twin
//    (`blend_reject`), which the CPU tests hold against the plain walk.
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
constexpr int HALVES = 2;          // blocks a tile, one over each row half
constexpr int ROWS_PER_THREAD = TILE_H / HALVES * TILE_W / THREADS;   // 8
constexpr int CHUNK = 64;          // entries staged per round
constexpr int ROW = 36;            // floats per triangle row
constexpr int WARP_W = 32;         // a warp's rectangle: 32 columns x 8 rows
constexpr float REJECT_REL = 0x1p-21f;   // 8u, u = 2^-24: K3's edge margin
constexpr float REJECT_ABS = 1e-36f;
constexpr float S_REL = 0x1p-20f;        // 16u: the margin of s's lower bound
constexpr float S_MIN = 0x1p-100f;       // s_lo at least this
constexpr float S_RATIO = 0x1p60f;       // fl(T) at most this times s_lo
constexpr float COEF_MAX = 0x1p60f;      // |colour|, |depth coefficient| at most

// a*xn + b*yn + c as XLA compiles it: fma(a, xn, b*yn) + c
__device__ __forceinline__ float plane(float a, float b, float c, float xn, float yn) {
    return __fmaf_rn(a, xn, b * yn) + c;
}

// a*l0 + b*l1 + c*l2 as XLA compiles it: fma(c, l2, fma(a, l0, b*l1))
__device__ __forceinline__ float lerp3(const float* r, int o, int step, float l0,
                                       float l1, float l2) {
    return __fmaf_rn(r[o + 2 * step], l2, __fmaf_rn(r[o], l0, r[o + step] * l1));
}

// clip(x, lo, hi) keeping a NaN, as jnp.clip and torch.clamp do (fminf
// and fmaxf alone would return lo)
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// the pixel-centre NDC coordinate of tile row / column `pix`: (origin +
// pix + 0.5) * scale - 1, the sum of the two integers exact in f32
__device__ __forceinline__ float ndc(int origin, int pix, float scale) {
    return ((float)origin + (float)pix + 0.5f) * scale - 1.0f;
}

// True when entry row r adds an exact no-op at every pixel of the
// rectangle [x0, x1] x [y0, y1] (see the header): an edge is below 0 on
// the whole rectangle, s is bounded away from 0 there and the colour and
// depth coefficients are bounded.
__device__ __forceinline__ bool blend_reject(const float* r, float x0, float x1,
                                             float y0, float y1) {
    const float mx = fmaxf(fabsf(x0), fabsf(x1));
    const float my = fmaxf(fabsf(y0), fabsf(y1));
    float t[3];
    bool outside = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float a = r[3 * k], b = r[3 * k + 1], c = r[3 * k + 2];
        t[k] = fabsf(a) * mx + fabsf(b) * my + fabsf(c);
        outside |= plane(a, b, c, a > 0.0f ? x1 : x0, b > 0.0f ? y1 : y0)
                   + (t[k] * REJECT_REL + REJECT_ABS) < 0.0f;
    }
    if (!outside) return false;
    const float A = (r[0] + r[3]) + r[6];
    const float B = (r[1] + r[4]) + r[7];
    const float C = (r[2] + r[5]) + r[8];
    const float T = (t[0] + t[1]) + t[2];
    const float s_lo = plane(A, B, C, A > 0.0f ? x0 : x1, B > 0.0f ? y0 : y1)
                       - (T * S_REL + REJECT_ABS);
    if (!(s_lo >= S_MIN) || !(T <= S_RATIO * s_lo)) return false;
    bool bounded = true;           // depth 9-11; each vertex's r, g, b (22 + 4k ..)
#pragma unroll
    for (int k = 0; k < 3; ++k)
        bounded &= (fabsf(r[9 + k]) <= COEF_MAX) & (fabsf(r[22 + 4 * k]) <= COEF_MAX)
                   & (fabsf(r[23 + 4 * k]) <= COEF_MAX) & (fabsf(r[24 + 4 * k]) <= COEF_MAX);
    return bounded;
}

__global__ void __launch_bounds__(THREADS, 2)
raster_blend_kernel(const float* __restrict__ rows,
                    const int* __restrict__ bins,
                    const int* __restrict__ counts,
                    const int* __restrict__ big_ids,
                    const float* __restrict__ opaque_depth,   // (out_h, out_w)
                    const float* __restrict__ peel,           // (out_h, out_w) or null
                    int soft_mode, int n_big, int bin_capacity, int tiles_x, int ty0,
                    float cx, float cy, int out_w,
                    float* __restrict__ out)                  // (5, out_h, out_w)
{
    __shared__ float s_row[CHUNK][ROW];

    const int tile = blockIdx.x / HALVES;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int gy = (ty0 + ty) * TILE_H;     // the tile's first row in the NDC viewport
    const int col = threadIdx.x % TILE_W;
    const int row0 = (blockIdx.x % HALVES) * (TILE_H / HALVES)
                     + (threadIdx.x / TILE_W) * ROWS_PER_THREAD;
    const int x = tx * TILE_W + col;
    const float xn = ndc(tx * TILE_W, col, cx);
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
    // the warp's rectangle: its first and last column's xn, its rows' yn
    const int wcol = col - col % WARP_W;
    const float x0 = ndc(tx * TILE_W, wcol, cx);
    const float x1 = ndc(tx * TILE_W, wcol + WARP_W - 1, cx);
    const float y0 = ndc(gy, row0, cy);
    const float y1 = ndc(gy, row0 + ROWS_PER_THREAD - 1, cy);

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
            if (blend_reject(r, x0, x1, y0, y1)) continue;
            // which tests this entry takes (uniform over the block)
            const bool peel_test = has_peel && (soft_mode != 2 || r[35] > 0.0f);
            const bool soft = soft_mode == 1 || (soft_mode == 2 && r[34] > 0.0f);
#pragma unroll
            for (int p = 0; p < ROWS_PER_THREAD; ++p) {
                const float yn = ndc(gy, row0 + p, cy);
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

    const size_t plane_size = (size_t)(gridDim.x / HALVES) / tiles_x * TILE_H * out_w;
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
// NDC viewport, rounded to f32 by the caller.  A band of tile rows: bins,
// counts, opaque_depth, peel and out hold its tiles only, and ty0 is the
// viewport's tile row of its first row (0 for the whole frame).
extern "C" int raster_blend_launch(const float* rows, const int* bins, const int* counts,
                                   const int* big_ids, const float* opaque_depth,
                                   const float* peel, int soft_mode, int n_big,
                                   int bin_capacity, int tiles_x, int n_tiles, int ty0, float cx,
                                   float cy, int out_w, float* out, void* stream)
{
    raster_blend_kernel<<<n_tiles * HALVES, THREADS, 0, (cudaStream_t)stream>>>(
        rows, bins, counts, big_ids, opaque_depth, peel, soft_mode, n_big, bin_capacity,
        tiles_x, ty0, cx, cy, out_w, out);
    return (int)cudaGetLastError();
}
