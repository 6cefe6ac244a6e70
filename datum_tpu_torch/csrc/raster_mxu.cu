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
// walked entry x each pixel x six planes (~25 f32 operations a pair);
// the TPU's padded product (24 x 128 x 12288 a chunk-half, 21 of every
// 24 terms zero) is a TPU layout, not work.  At the 1920x1088 bench
// inputs the least time is set by the 15 output planes' bytes; the walk
// itself is limited by instruction throughput, like K1's.
//
// What the design does about it.
//  * No product at all: each pixel evaluates the six planes of an entry
//    directly from its 14 staged coefficients (no tensor core, no
//    library call); the one-hot attribute fetch becomes one gather of
//    the winner's row after the walk.
//  * One block per tile, 256 threads, 16 pixels per thread; entries are
//    staged in shared memory 64 at a time (broadcast loads).
//  * Rounding, as XLA:CPU computes the TPU kernel: its dot accumulates
//    the 24 terms in order with fused multiply-adds from 0 (the zero
//    terms add exact zeros), so a plane is fma(b, yn, a*xn) + c — not
//    K1's fma(a, xn, b*yn) + c — and each attribute is
//    fma(c, l2, fma(a, l0, b*l1)).  The file is built with -fmad=false
//    and writes every fused product with __fmaf_rn; the plain PyTorch
//    version computes the same ones, so winners and planes agree bit
//    for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = TILE_H * TILE_W / THREADS;   // 16
constexpr int CHUNK = 64;          // entries staged per round
constexpr int WALK_SLOTS = 14;     // row slots the walk reads (0..13)
constexpr int ROW = 40;            // floats per triangle row
constexpr int N_PLANES = 15;

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

__global__ void __launch_bounds__(THREADS)
raster_mxu_kernel(const float* __restrict__ tri_rows,
                  const int* __restrict__ bins,
                  const int* __restrict__ counts,
                  const int* __restrict__ big_ids,
                  int n_big, int bin_capacity, int tiles_x,
                  float cx, float cy, int out_w, size_t plane_size,
                  float* __restrict__ out)
{
    __shared__ float s_row[CHUNK][WALK_SLOTS];
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

    // every big slot, then the tile's bin range (the TPU kernel's
    // active = idx < B + count)
    const int n_entries = n_big + counts[tile];
    for (int base = 0; base < n_entries; base += CHUNK) {
        const int n_here = min(CHUNK, n_entries - base);
        for (int i = threadIdx.x; i < n_here * WALK_SLOTS; i += THREADS) {
            const int e = i / WALK_SLOTS;
            const int k = i - e * WALK_SLOTS;
            const int g = base + e;
            const int id = g < n_big ? big_ids[g]
                                     : bins[(size_t)tile * bin_capacity + (g - n_big)];
            s_row[e][k] = id >= 0 ? tri_rows[(size_t)id * ROW + k] : 0.0f;
            if (k == 0) s_id[e] = id;
        }
        __syncthreads();
        for (int e = 0; e < n_here; ++e) {
            const int id = s_id[e];
            if (id < 0) continue;          // a zero row: s = 0 never passes
            const float* r = s_row[e];
            const float a0 = r[0], b0 = r[1], c0 = r[2];
            const float a1 = r[3], b1 = r[4], c1 = r[5];
            const float a2 = r[6], b2 = r[7], c2 = r[8];
            const float az = r[9], bz = r[10], cz = r[11];
            const float ylo = r[12], yhi = r[13];
#pragma unroll
            for (int p = 0; p < ROWS_PER_THREAD; ++p) {
                const float e0 = dplane(a0, b0, c0, xn, yn[p]);
                const float e1 = dplane(a1, b1, c1, xn, yn[p]);
                const float e2 = dplane(a2, b2, c2, xn, yn[p]);
                const float d = dplane(az, bz, cz, xn, yn[p]);
                const float s = (e0 + e1) + e2;
                const bool pass = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f)
                                  & (s > 0.0f) & (yn[p] - ylo >= 0.0f)
                                  & (yhi - yn[p] > 0.0f)
                                  & (d > depth[p]) & (d <= 1.0f);
                depth[p] = pass ? d : depth[p];
                win[p] = pass ? id : win[p];
            }
        }
        __syncthreads();
    }

    // epilogue: the winner's barycentrics and attributes
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        const int y = ty * TILE_H + row0 + p;
        float v[N_PLANES];
#pragma unroll
        for (int j = 0; j < N_PLANES; ++j) v[j] = 0.0f;
        v[1] = -1.0f;
        const int id = win[p];
        if (id >= 0) {
            const float* r = tri_rows + (size_t)id * ROW;
            const float e0 = dplane(r[0], r[1], r[2], xn, yn[p]);
            const float e1 = dplane(r[3], r[4], r[5], xn, yn[p]);
            const float e2 = dplane(r[6], r[7], r[8], xn, yn[p]);
            const float s = (e0 + e1) + e2;
            const float inv_s = 1.0f / (s == 0.0f ? 1.0f : s);
            const float l0 = e0 * inv_s;
            const float l1 = e1 * inv_s;
            const float l2 = (1.0f - l0) - l1;
            v[0] = depth[p];
            v[1] = (float)id;
            v[2] = lerp3(r[16], r[18], r[20], l0, l1, l2);     // u
            v[3] = lerp3(r[17], r[19], r[21], l0, l1, l2);     // v
#pragma unroll
            for (int c = 0; c < 3; ++c)                        // normal xyz
                v[4 + c] = lerp3(r[22 + c], r[25 + c], r[28 + c], l0, l1, l2);
#pragma unroll
            for (int j = 0; j < 8; ++j) v[7 + j] = r[32 + j];  // material, albedo id
        }
        const size_t o = (size_t)y * out_w + x;
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
    raster_mxu_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        tri_rows, bins, counts, big_ids, n_big, bin_capacity, tiles_x, cx, cy,
        out_w, plane_size, out);
    return (int)cudaGetLastError();
}
