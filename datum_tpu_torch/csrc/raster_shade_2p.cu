// K6: the two-phase fused raster (visibility, then attributes of the
// entries that won a pixel).
//
// Replaces the Pallas kernel datum_tpu/ops/raster_pallas.py
// `_raster_shade_kernel_2p` (launched by `raster_shade_pallas` with
// two_phase=True), in its extended form (tangent + material-map planes),
// with the optional peel plane of the lit translucent layers and the
// optional early-z exit of its first phase.  (alpha_in_alb is host work:
// the row builder puts the material alpha in slot 41.)  It writes the
// same 22 planes as K1 (csrc/raster_shade.cu), bit for bit.
//
// What it computes.  Phase 1 is K1's walk: for every pixel of a 32 x 128
// tile it walks the frame's big-triangle list, then the tile's bin
// entries, in order, with the three edge functions, the inside test, the
// depth plane and the strict reverse-Z test (d > depth && d <= 1, and d <
// peel with a peel plane); the carry is the depth and the winning SLOT,
// the entry's index in walk order (the TPU kernel keeps it as an f32,
// exact below 2^24).  Between the phases the tile marks the slots that
// won at least one pixel and compacts them.  Phase 2 evaluates each
// pixel's planes from its slot's attribute row, with one perspective
// divide, exactly as K1's epilogue does.
//
// What bounds it on the H100.  Phase 1 is ~18 f32 operations per (pixel,
// entry) on coefficients uniform across the tile: issue-bound, like K1.
// Phase 2 is ~110 operations a pixel and reads each won entry's 64-float
// row once per tile; the frame writes 22 f32 planes (~190 MB at
// 1920x1088), so the epilogue's stores are the bytes that count.
//
// What the design does about it.
//  * One block per tile, 256 threads, 16 pixels per thread (one column,
//    16 rows), entry rows (13 slots) staged in shared memory in chunks of
//    64 and walked in sequence (never atomics): K1's walk and tie order.
//  * The TPU kernel's second phase walks the groups again and skips those
//    that won no pixel; here a shared flag per entry marks the won slots,
//    a block prefix sum (warp shuffles) gives each its compacted index,
//    and the won entries' full rows are staged in shared memory with
//    coalesced loads (a warp reads 32 consecutive floats of a row), 64
//    rows (16 KB) a round.  A pixel reads its row from shared memory
//    instead of gathering it from global memory as K1 does, and an entry
//    that won many pixels is loaded once.  Chunking keeps the static
//    shared memory at ~20 KB whatever the bin depth: the bench's main
//    bins (160 + 64 = 224 entries) would need 57 KB to stage every row.
//  * The flags and the compaction live in dynamic shared memory (8 bytes
//    per entry of n_big + bin_capacity); above 48 KB in all the launch
//    opts in with cudaFuncAttributeMaxDynamicSharedMemorySize.
//  * Early-z (szb given): phase 1 ends as K1's walk does (see
//    raster_shade.cu): a thread stops at the first slot whose suffix
//    bound its min depth reaches, the block when all its threads have.
//  * Rounding: every plane a*xn + b*yn + c is fma(a, xn, b*yn) + c with
//    an explicit __fmaf_rn, the file is built with -fmad=false, as K1.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_THREAD = TILE_H * TILE_W / THREADS;   // 16
constexpr int CHUNK = 64;          // entries staged per walk round
constexpr int WALK_SLOTS = 13;     // row slots the walk reads (0..12)
constexpr int ROW = 64;            // floats per triangle row
constexpr int WON_CHUNK = 64;      // won rows staged per phase-2 round
constexpr int N_PLANES = 22;

// a*xn + b*yn + c as XLA compiles it: fma(a, xn, b*yn) + c
__device__ __forceinline__ float plane(float a, float b, float c, float xn, float yn) {
    return __fmaf_rn(a, xn, b * yn) + c;
}

__device__ __forceinline__ int entry_id(const int* big_ids, const int* bins, int tile,
                                        int bin_capacity, int n_big, int g) {
    return g < n_big ? big_ids[g] : bins[(size_t)tile * bin_capacity + (g - n_big)];
}

__global__ void __launch_bounds__(THREADS)
raster_shade_2p_kernel(const float* __restrict__ tri_rows,
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
    __shared__ float s_zb[CHUNK];
    __shared__ float s_won[WON_CHUNK][ROW];
    __shared__ int s_warp[WARPS];
    __shared__ int s_total;
    extern __shared__ int s_dyn[];
    int* s_pos = s_dyn;                          // per entry: flag, then compacted index or -1
    int* s_wid = s_dyn + n_big + bin_capacity;   // per compacted index: the entry's id

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
    int slot[ROWS_PER_THREAD];
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        const int y = ty * TILE_H + row0 + p;
        yn[p] = ((float)(ty * TILE_H) + (float)(row0 + p) + 0.5f) * cy - 1.0f;
        depth[p] = 0.0f;
        pl[p] = peel != nullptr ? peel[(size_t)y * out_w + x] : 2.0f;
        slot[p] = -1;
    }

    const int n_entries = n_big + counts[tile];
    for (int i = threadIdx.x; i < n_entries; i += THREADS) s_pos[i] = 0;

    // ---- phase 1: depth + winning slot
    const float* zb = szb != nullptr ? szb + (size_t)tile * (n_big + bin_capacity) : nullptr;
    float tmin = 0.0f;                 // min of this thread's depths (early-z)
    bool done = false;                 // this thread's walk has ended (early-z)
    for (int base = 0; base < n_entries; base += CHUNK) {
        const int n_here = min(CHUNK, n_entries - base);
        for (int i = threadIdx.x; i < n_here * WALK_SLOTS; i += THREADS) {
            const int e = i / WALK_SLOTS;
            const int k = i - e * WALK_SLOTS;
            const int id = entry_id(big_ids, bins, tile, bin_capacity, n_big, base + e);
            // invalid entries are zero rows: slot 12 (valid) = 0 never passes
            s_row[e][k] = id >= 0 ? tri_rows[(size_t)id * ROW + k] : 0.0f;
            if (k == 0) s_zb[e] = zb != nullptr ? zb[base + e] : 2.0f;   // 2: never reached
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
            const int k = base + e;
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
                slot[p] = pass ? k : slot[p];
            }
        }
        if (zb != nullptr) {           // depths only grow: refresh the min
            tmin = depth[0];
#pragma unroll
            for (int p = 1; p < ROWS_PER_THREAD; ++p) tmin = fminf(tmin, depth[p]);
        }
        if (__syncthreads_and(done)) break;
    }

    // ---- between the phases: flag the won slots, compact them
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p)
        if (slot[p] >= 0) s_pos[slot[p]] = 1;     // same value from every writer
    __syncthreads();
    const int per = (n_entries + THREADS - 1) / THREADS;
    const int lo = min((int)threadIdx.x * per, n_entries);
    const int hi = min(lo + per, n_entries);
    int local = 0;
    for (int e = lo; e < hi; ++e) local += s_pos[e];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = local;
    for (int d = 1; d < 32; d <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += n;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = lane < WARPS ? s_warp[lane] : 0;
        for (int d = 1; d < 32; d <<= 1) {
            const int n = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w += n;
        }
        if (lane < WARPS) s_warp[lane] = w;
    }
    __syncthreads();
    int next = incl - local + (warp > 0 ? s_warp[warp - 1] : 0);
    if (threadIdx.x == THREADS - 1) s_total = next + local;
    for (int e = lo; e < hi; ++e) {
        if (s_pos[e]) {
            s_wid[next] = entry_id(big_ids, bins, tile, bin_capacity, n_big, e);
            s_pos[e] = next++;
        } else {
            s_pos[e] = -1;
        }
    }
    __syncthreads();
    const int n_won = s_total;

    // ---- phase 2: the planes from the won rows, staged in shared memory
    const size_t plane_size = (size_t)out_h * out_w;
    int widx[ROWS_PER_THREAD];
#pragma unroll
    for (int p = 0; p < ROWS_PER_THREAD; ++p) {
        widx[p] = slot[p] >= 0 ? s_pos[slot[p]] : -1;
        if (widx[p] < 0) {
            const size_t o = (size_t)(ty * TILE_H + row0 + p) * out_w + x;
#pragma unroll
            for (int j = 0; j < N_PLANES; ++j) out[j * plane_size + o] = j == 1 ? -1.0f : 0.0f;
        }
    }
    for (int base = 0; base < n_won; base += WON_CHUNK) {
        const int n_here = min(WON_CHUNK, n_won - base);
        for (int i = threadIdx.x; i < n_here * ROW; i += THREADS) {
            const int r = i / ROW;
            s_won[r][i - r * ROW] = tri_rows[(size_t)s_wid[base + r] * ROW + (i - r * ROW)];
        }
        __syncthreads();
#pragma unroll
        for (int p = 0; p < ROWS_PER_THREAD; ++p) {
            const int k = widx[p] - base;
            if (k < 0 || k >= n_here) continue;
            const float* r = s_won[k];
            const float yv = yn[p];
            auto lin = [&](int o) { return plane(r[o], r[o + 1], r[o + 2], xn, yv); };
            const float s = (lin(0) + lin(3)) + lin(6);
            const float rcp = 1.0f / (s == 0.0f ? 1.0f : s);
            float v[N_PLANES];
            v[0] = depth[p];
            v[1] = (float)s_wid[base + k];
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
            const size_t o = (size_t)(ty * TILE_H + row0 + p) * out_w + x;
#pragma unroll
            for (int j = 0; j < N_PLANES; ++j) out[j * plane_size + o] = v[j];
        }
        __syncthreads();
    }
}

}  // namespace

// Dynamic shared memory (bytes) one launch needs: the flag/compaction
// array and the won ids, one int each per entry of n_big + bin_capacity.
extern "C" int raster_shade_2p_smem_bytes(int n_big, int bin_capacity)
{
    return 2 * (n_big + bin_capacity) * (int)sizeof(int);
}

// tri_rows (T, 64) f32; bins (n_tiles, bin_capacity) i32; counts
// (n_tiles,) i32; big_ids (n_big,) i32; peel (out_h, out_w) f32 or null;
// szb (n_tiles, n_big + bin_capacity) f32 early-z bounds or null;
// out (22, out_h, out_w) f32 with out_h = tiles_y * 32 and out_w =
// tiles_x * 128.  cx, cy are 2/width and 2/height of the NDC viewport,
// rounded to f32 by the caller.
extern "C" int raster_shade_2p_launch(const float* tri_rows, const int* bins,
                                      const int* counts, const int* big_ids,
                                      const float* peel, const float* szb,
                                      int n_big, int bin_capacity, int tiles_x,
                                      int n_tiles, float cx, float cy, int out_h,
                                      int out_w, float* out, void* stream)
{
    const int dyn = raster_shade_2p_smem_bytes(n_big, bin_capacity);
    cudaError_t err = cudaFuncSetAttribute(
        raster_shade_2p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return (int)err;
    raster_shade_2p_kernel<<<n_tiles, THREADS, dyn, (cudaStream_t)stream>>>(
        tri_rows, bins, counts, big_ids, peel, szb, n_big, bin_capacity, tiles_x, cx,
        cy, out_h, out_w, out);
    return (int)cudaGetLastError();
}
