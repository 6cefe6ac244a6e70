// The sprite and text pass: the render list's overlay quads (icons,
// glyphs, region-sized chunks of larger panels) alpha-blended into the
// display image in draw order.
//
// Replaces datum_tpu/ops/sprite_pass.py `composite_sprites` (:53-126).
// There it is no Pallas kernel but one XLA fori_loop over the instance
// capacity S: each step dynamic_slices the R x R window around a sprite,
// maps its pixel centres into the sprite's atlas rect through the inverse
// of the rect's 2x2 edge basis, takes a 4-tap bilinear sample, blends
// reg * (1 - a) + src * a and writes the window back.  Eager PyTorch
// would launch ~35 ops a sprite; this is one launch for the whole pass.
//
// What bounds it on the H100.  The function reads the image and writes a
// new one (12 B a pixel each way: ~50 MB at 1920x1088, ~15 us at 3.35
// TB/s); the atlas and the instance rows are kilobytes.  Its arithmetic
// is ~60 FP32 operations a (window pixel, sprite): 256 sprites with
// 128^2 windows are ~0.25 GFLOP, ~4 us at 67 TFLOP/s.  Bytes bound it.
//
// What the design does about it.  One thread per pixel of a 16 x 16
// tile reads its pixel once, keeps it in registers through every sprite
// and writes it once.  The block tests up to 256 live sprites at a time
// (one a thread) against its tile and compacts the ones whose clamped
// window covers it, in draw order, into shared memory (a warp ballot and
// a prefix over the warps); then every thread walks that list.  A
// sprite's window, det and inv_det are computed once, by the thread that
// tested it.  Built with -fmad=false, every multiply and add rounds on
// its own as in ops/sprite_pass.py::composite_sprites_reference, so the
// two are bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int WARPS = THREADS / 32;

struct Sprite {
    float o0, o1, ax0, ax1, ay0, ay1;   // origin and the rect's edge vectors
    float u00, u01, u10, u11;           // atlas rect uv0, uv1 in pixels
    float t0, t1, t2, t3;               // tint
    float det, inv_det;
    int sx, sy;                         // the window's top-left
};

// torch.minimum / torch.maximum: NaN propagates
__device__ __forceinline__ float tmin(float a, float b)
{
    return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float tmax(float a, float b)
{
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float4 tap(const float4* __restrict__ atlas, int aw, int ah,
                                      float xi, float yi)
{
    const int xc = min(max((int)xi, 0), aw - 1);
    const int yc = min(max((int)yi, 0), ah - 1);
    return __ldg(atlas + (yc * aw + xc));
}

__device__ __forceinline__ float4 bilinear(const float4* __restrict__ atlas, int aw, int ah,
                                           float px, float py)
{
    const float x0 = floorf(px - 0.5f);
    const float y0 = floorf(py - 0.5f);
    const float fx = (px - 0.5f) - x0;
    const float fy = (py - 0.5f) - y0;
    const float4 t00 = tap(atlas, aw, ah, x0, y0);
    const float4 t10 = tap(atlas, aw, ah, x0 + 1.0f, y0);
    const float4 t01 = tap(atlas, aw, ah, x0, y0 + 1.0f);
    const float4 t11 = tap(atlas, aw, ah, x0 + 1.0f, y0 + 1.0f);
    const float gx = 1.0f - fx;
    const float gy = 1.0f - fy;
    float4 r;
    r.x = (t00.x * gx + t10.x * fx) * gy + (t01.x * gx + t11.x * fx) * fy;
    r.y = (t00.y * gx + t10.y * fx) * gy + (t01.y * gx + t11.y * fx) * fy;
    r.z = (t00.z * gx + t10.z * fx) * gy + (t01.z * gx + t11.z * fx) * fy;
    r.w = (t00.w * gx + t10.w * fx) * gy + (t01.w * gx + t11.w * fx) * fy;
    return r;
}

// sprite i's fields, its window (ops/sprite_pass.py::sprite_window) and
// the inverse basis determinant
__device__ __forceinline__ Sprite load_sprite(
    int i, const float* __restrict__ origin, const float* __restrict__ axis_x,
    const float* __restrict__ axis_y, const float* __restrict__ uv0,
    const float* __restrict__ uv1, const float* __restrict__ tint, int h, int w, int R)
{
    Sprite s;
    s.o0 = origin[2 * i];
    s.o1 = origin[2 * i + 1];
    s.ax0 = axis_x[2 * i];
    s.ax1 = axis_x[2 * i + 1];
    s.ay0 = axis_y[2 * i];
    s.ay1 = axis_y[2 * i + 1];
    s.u00 = uv0[2 * i];
    s.u01 = uv0[2 * i + 1];
    s.u10 = uv1[2 * i];
    s.u11 = uv1[2 * i + 1];
    s.t0 = tint[4 * i];
    s.t1 = tint[4 * i + 1];
    s.t2 = tint[4 * i + 2];
    s.t3 = tint[4 * i + 3];
    const float bx0 = tmin(tmin(0.0f, s.ax0), tmin(s.ay0, s.ax0 + s.ay0));
    const float bx1 = tmax(tmax(0.0f, s.ax0), tmax(s.ay0, s.ax0 + s.ay0));
    const float by0 = tmin(tmin(0.0f, s.ax1), tmin(s.ay1, s.ax1 + s.ay1));
    const float by1 = tmax(tmax(0.0f, s.ax1), tmax(s.ay1, s.ax1 + s.ay1));
    const float cx = s.o0 + 0.5f * (bx0 + bx1);
    const float cy = s.o1 + 0.5f * (by0 + by1);
    const float half = (float)R * 0.5f;
    s.sx = min(max((int)rintf(cx - half), 0), w - R);
    s.sy = min(max((int)rintf(cy - half), 0), h - R);
    s.det = s.ax0 * s.ay1 - s.ax1 * s.ay0;
    s.inv_det = fabsf(s.det) < 1e-8f ? 0.0f : 1.0f / s.det;
    return s;
}

__global__ void __launch_bounds__(THREADS)
sprite_pass_kernel(const float* __restrict__ rgb, float* __restrict__ out, int h, int w,
                   const float* __restrict__ origin, const float* __restrict__ axis_x,
                   const float* __restrict__ axis_y, const float* __restrict__ uv0,
                   const float* __restrict__ uv1, const float* __restrict__ tint,
                   const int* __restrict__ count, int S, const float4* __restrict__ atlas,
                   int ah, int aw, int R)
{
    __shared__ Sprite list[THREADS];
    __shared__ int warp_total[WARPS];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int tx0 = blockIdx.x * TILE;
    const int ty0 = blockIdx.y * TILE;
    const int x = tx0 + t % TILE;
    const int y = ty0 + t / TILE;
    const bool pix = x < w && y < h;
    const long long p = ((long long)y * w + x) * 3;
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (pix) {
        r = rgb[p];
        g = rgb[p + 1];
        b = rgb[p + 2];
    }
    const int n = max(min(__ldg(count), S), 0);
    for (int base = 0; base < n; base += THREADS) {
        // collect: the sprites of this chunk whose window meets the tile
        const int i = base + t;
        Sprite s;
        bool cover = false;
        if (i < n) {
            s = load_sprite(i, origin, axis_x, axis_y, uv0, uv1, tint, h, w, R);
            cover = s.sx < tx0 + TILE && s.sx + R > tx0 && s.sy < ty0 + TILE
                    && s.sy + R > ty0;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, cover);
        if (lane == 0) warp_total[warp] = __popc(mask);
        __syncthreads();
        int off = 0, total = 0;
        for (int k = 0; k < WARPS; ++k) {
            const int c = warp_total[k];
            off += k < warp ? c : 0;
            total += c;
        }
        if (cover) list[off + __popc(mask & ((1u << lane) - 1u))] = s;
        __syncthreads();

        // blend: each pixel through the list, in draw order
        if (pix) {
            for (int k = 0; k < total; ++k) {
                const Sprite& q = list[k];
                const int lx = x - q.sx;
                const int ly = y - q.sy;
                if (lx < 0 || lx >= R || ly < 0 || ly >= R) continue;
                // pixel-centre coordinates relative to the sprite origin
                const float dx = (float)lx + (((float)q.sx + 0.5f) - q.o0);
                const float dy = (float)ly + (((float)q.sy + 0.5f) - q.o1);
                const float u = (dx * q.ay1 - dy * q.ay0) * q.inv_det;
                const float v = (dy * q.ax0 - dx * q.ax1) * q.inv_det;
                const bool inside = u >= 0.0f && u < 1.0f && v >= 0.0f && v < 1.0f
                                    && fabsf(q.det) >= 1e-8f;
                const float px = q.u00 + u * (q.u10 - q.u00);
                const float py = q.u01 + v * (q.u11 - q.u01);
                const float4 tex = bilinear(atlas, aw, ah, px, py);
                const float a = (tex.w * q.t3) * (inside ? 1.0f : 0.0f);
                const float ia = 1.0f - a;
                r = r * ia + (tex.x * q.t0) * a;
                g = g * ia + (tex.y * q.t1) * a;
                b = b * ia + (tex.z * q.t2) * a;
            }
        }
        __syncthreads();       // the next chunk reuses list and warp_total
    }
    if (pix) {
        out[p] = r;
        out[p + 1] = g;
        out[p + 2] = b;
    }
}

}  // namespace

// rgb, out: (h, w, 3) f32; origin, axis_x, axis_y, uv0, uv1: (S, 2) f32;
// tint: (S, 4) f32; count: one int32 on the device (sprites past
// min(count, S) are not drawn); atlas: (ah, aw, 4) f32, 16-byte aligned;
// R: the window side, 1 <= R <= min(h, w).
extern "C" int sprite_pass_launch(const float* rgb, float* out, int h, int w,
                                  const float* origin, const float* axis_x,
                                  const float* axis_y, const float* uv0, const float* uv1,
                                  const float* tint, const int* count, int S,
                                  const void* atlas, int ah, int aw, int R, void* stream)
{
    if (h <= 0 || w <= 0) return 0;
    const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
    sprite_pass_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        rgb, out, h, w, origin, axis_x, axis_y, uv0, uv1, tint, count, S,
        (const float4*)atlas, ah, aw, R);
    return (int)cudaGetLastError();
}
