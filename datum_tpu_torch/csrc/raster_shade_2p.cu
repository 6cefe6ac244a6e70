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
// exact below 2^24).  Between the phases the slots that won at least one
// pixel are marked and compacted.  Phase 2 evaluates each pixel's planes
// from its slot's attribute row, with one perspective divide, exactly as
// K1's epilogue does.
//
// What bounds it on the H100.  Phase 1 is ~18 f32 operations per (pixel,
// entry) on coefficients uniform across the tile: issue-bound where bins
// are deep (the stress frame), like K1.  Phase 2 is ~110 operations a
// pixel and reads each won entry's 64-float row; the frame writes 22 f32
// planes (~190 MB at 1920x1088), the bytes that bound shallow bins.  The
// busiest tiles' walks set the time of a kernel that gives each tile to
// one block.
//
// What the design does about it: K1's walk, as csrc/raster_shade.cu
// builds it (a copy: the two files share no header), then the two-phase
// epilogue per block.
//  * One tile's walk is split over a thread-block cluster of SPLIT blocks
//    (grid n_tiles * SPLIT).  Block r walks the slots g = r (mod SPLIT)
//    of the tile's sequence (the big list, then the bin), with K1's
//    launcher rule: SPLIT 2 where there are at least twice as many tiles
//    as SMs and n_big + bin_capacity <= 512, else 4.  256 threads a
//    block, 16 pixels a thread (one column, 16 rows); each block stages
//    only its own entries' 13 walk slots in shared memory, 64 at a time.
//  * A block carries, per pixel, its partial (depth, walk slot g).  The
//    combine is exact (raster_shade.cu argues it): the full walk's
//    (depth, slot) is the largest partial depth and, among the blocks
//    that reach it, the smallest slot; NO_SLOT where nothing passed.
//  * The combine goes through distributed shared memory: block r reduces
//    rows r*32/SPLIT.. of the tile; each block stores its partial rows
//    into the shared memory of their reducer, then one full cluster
//    barrier.  After it no block touches another's memory.
//  * A warp-uniform rectangle reject, edges only (K3's corner test and
//    margin, raster_depth.cu derives it): warp w skips an entry one of
//    whose edges is below 0 on its whole 32 x 16 rectangle.
//  * Early-z (szb given, per tile and GLOBAL walk slot g) stays exact per
//    block, as in K1: a thread stops at its slot g once the min of its
//    partial depths, refreshed once a chunk, reaches szb[g]; the block
//    when all its threads have (__syncthreads_and).
//  * Phase 2 runs per block on the rows it reduced.  The combine writes
//    the depth plane and keeps each pixel's slot in shared memory (not in
//    registers: held across the phase, they spilled).  The block flags
//    the slots won in its rows (dynamic shared flags, one int an entry of
//    n_big + bin_capacity), compacts them with a block prefix sum (warp
//    shuffles), and stages the won rows (64 floats each, a stride of 65
//    so that distinct rows fall in distinct banks) in shared memory, 128
//    a round, over the space the combine used.  Each pixel evaluates and
//    stores its planes from its staged row before the next pixel; stores
//    are coalesced (a warp writes 32 neighbouring texels of a plane) and
//    each texel is written once.  A slot that won rows of two blocks is
//    staged by both.
//  * __launch_bounds__(256, 2): at most 128 registers, two blocks an SM
//    (~45 KB of static shared memory a block at SPLIT 2, plus 8 bytes an
//    entry of dynamic: the flags and the compacted ids; the launch opts
//    in to the dynamic size).  yn is recomputed from the row index (the
//    same exact integer sum, the same bits) instead of being carried for
//    16 rows.
//  * Invalid entries (id -1: unused big-list slots) are zero rows and are
//    skipped uniformly by the whole block.
//  * Rounding: every plane a*xn + b*yn + c is fma(a, xn, b*yn) + c with
//    an explicit __fmaf_rn, the file is built with -fmad=false, as K1.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_THREAD = TILE_H * TILE_W / THREADS;   // 16
constexpr int CHUNK = 64;          // entries staged per walk round
constexpr int WALK_SLOTS = 13;     // row slots the walk reads (0..12)
constexpr int ROW = 64;            // floats per triangle row
constexpr int ROW_PAD = ROW + 1;   // a staged row's stride in shared memory
constexpr int WON_CHUNK = 128;     // won rows staged per phase-2 round
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

__device__ __forceinline__ int entry_id(const int* big_ids, const int* bins, int tile,
                                        int bin_capacity, int n_big, int g) {
    return g < n_big ? big_ids[g] : bins[(size_t)tile * bin_capacity + (g - n_big)];
}

// The shared memory of the combine, then of phase 2's staged rows.
template <int SPLIT>
union Exchange {
    struct {
        float depth[SPLIT][TILE_H / SPLIT * TILE_W];   // the partial rows a block combines
        int slot[SPLIT][TILE_H / SPLIT * TILE_W];
    } part;
    float won[WON_CHUNK][ROW_PAD];                      // then the won rows
};

template <int SPLIT>                // blocks of a cluster: one tile's walk
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS, 2)
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
    constexpr int ROWS_PER_RANK = TILE_H / SPLIT;
    constexpr int RANK_PIXELS = ROWS_PER_RANK * TILE_W;
    __shared__ float s_row[CHUNK][WALK_SLOTS];
    __shared__ float s_zb[CHUNK];
    __shared__ Exchange<SPLIT> s_x;
    __shared__ int s_pix[RANK_PIXELS];   // per combined pixel: slot, then compacted index
    __shared__ int s_warp[WARPS];
    __shared__ int s_total;
    extern __shared__ int s_dyn[];
    int* s_pos = s_dyn;                          // per entry: flag, then compacted index or -1
    int* s_wid = s_dyn + n_big + bin_capacity;   // per compacted index: the entry's id

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    // this block runs: its peers may write into s_x once all have arrived
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    const int tile = blockIdx.x / SPLIT;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
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
    const float y0 = ndc(ty * TILE_H, row0, cy);
    const float y1 = ndc(ty * TILE_H, row0 + ROWS_PER_THREAD - 1, cy);

    const int n_entries = n_big + counts[tile];
    for (int i = threadIdx.x; i < n_entries; i += THREADS) s_pos[i] = 0;

    // ---- phase 1: this block's share of the walk, (depth, slot) a pixel
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
            const int id = entry_id(big_ids, bins, tile, bin_capacity, n_big, g);
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
                const float yn = ndc(ty * TILE_H, row0 + p, cy);
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
        cluster.map_shared_rank(&s_x.part.depth[rank][0], q)[o] = depth[p];
        cluster.map_shared_rank(&s_x.part.slot[rank][0], q)[o] = slot[p];
    }
    cluster.sync();

    // ---- between the phases, over this block's rows: the largest depth,
    // the smallest slot among equal depths; the depth plane is written
    // here, the pixel's slot kept in s_pix, the won slots flagged
    const size_t plane_size = (size_t)out_h * out_w;
    for (int i = threadIdx.x; i < RANK_PIXELS; i += THREADS) {
        float best = 0.0f;
        int g = NO_SLOT;
#pragma unroll
        for (int q = 0; q < SPLIT; ++q) {
            const float dq = s_x.part.depth[q][i];
            const int gq = s_x.part.slot[q][i];
            if (dq > best || (dq == best && gq < g)) { best = dq; g = gq; }
        }
        const int row = rank * ROWS_PER_RANK + i / TILE_W;     // i % TILE_W == col
        out[(size_t)(ty * TILE_H + row) * out_w + x] = best;
        s_pix[i] = g;
        if (g != NO_SLOT) s_pos[g] = 1;   // same value from every writer
    }
    __syncthreads();
    // compact: a block prefix sum over the flags, each thread a run of entries
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

    // ---- phase 2: the planes from the won rows, staged in shared memory;
    // s_pix now holds each pixel's compacted index (-1: nothing passed)
    for (int i = threadIdx.x; i < RANK_PIXELS; i += THREADS) {
        const int g = s_pix[i];
        s_pix[i] = g != NO_SLOT ? s_pos[g] : -1;
        if (g == NO_SLOT) {
            const int row = rank * ROWS_PER_RANK + i / TILE_W;
            float* o = out + (size_t)(ty * TILE_H + row) * out_w + x;
#pragma unroll
            for (int j = 1; j < N_PLANES; ++j) o[j * plane_size] = j == 1 ? -1.0f : 0.0f;
        }
    }
    for (int base = 0; base < n_won; base += WON_CHUNK) {
        const int n_here = min(WON_CHUNK, n_won - base);
        for (int i = threadIdx.x; i < n_here * ROW; i += THREADS) {
            const int r = i / ROW;
            s_x.won[r][i - r * ROW] = tri_rows[(size_t)s_wid[base + r] * ROW + (i - r * ROW)];
        }
        __syncthreads();
        for (int i = threadIdx.x; i < RANK_PIXELS; i += THREADS) {
            const int w = s_pix[i] - base;
            if (w < 0 || w >= n_here) continue;
            const float* r = s_x.won[w];
            const int row = rank * ROWS_PER_RANK + i / TILE_W;
            const float yv = ndc(ty * TILE_H, row, cy);
            auto lin = [&](int o) { return plane(r[o], r[o + 1], r[o + 2], xn, yv); };
            const float s = (lin(0) + lin(3)) + lin(6);
            const float rcp = 1.0f / (s == 0.0f ? 1.0f : s);
            float* o = out + (size_t)(ty * TILE_H + row) * out_w + x;
            o[plane_size] = (float)s_wid[base + w];
            o[2 * plane_size] = lin(16) * rcp;           // u
            o[3 * plane_size] = lin(19) * rcp;           // v
            o[4 * plane_size] = lin(22) * rcp;           // normal xyz
            o[5 * plane_size] = lin(25) * rcp;
            o[6 * plane_size] = lin(28) * rcp;
#pragma unroll
            for (int j = 0; j < 10; ++j)                 // material, mbase, msize
                o[(7 + j) * plane_size] = r[34 + j];
            o[17 * plane_size] = lin(44) * rcp;          // tangent xyz
            o[18 * plane_size] = lin(47) * rcp;
            o[19 * plane_size] = lin(50) * rcp;
            o[20 * plane_size] = r[53];                  // tangent w
            o[21 * plane_size] = r[56];                  // absorb
        }
        __syncthreads();
    }
}

template <int SPLIT>
int launch(const float* tri_rows, const int* bins, const int* counts, const int* big_ids,
           const float* peel, const float* szb, int n_big, int bin_capacity, int tiles_x,
           int n_tiles, float cx, float cy, int out_h, int out_w, float* out, int dyn,
           cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        raster_shade_2p_kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return (int)err;
    raster_shade_2p_kernel<SPLIT><<<n_tiles * SPLIT, THREADS, dyn, stream>>>(
        tri_rows, bins, counts, big_ids, peel, szb, n_big, bin_capacity, tiles_x, cx, cy,
        out_h, out_w, out);
    return (int)cudaGetLastError();
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
    int dev = 0, n_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_tiles >= 2 * n_sm && n_big + bin_capacity <= 512)
        return launch<2>(tri_rows, bins, counts, big_ids, peel, szb, n_big, bin_capacity,
                         tiles_x, n_tiles, cx, cy, out_h, out_w, out, dyn,
                         (cudaStream_t)stream);
    return launch<4>(tri_rows, bins, counts, big_ids, peel, szb, n_big, bin_capacity,
                     tiles_x, n_tiles, cx, cy, out_h, out_w, out, dyn,
                     (cudaStream_t)stream);
}
