// K2 epilogue: refraction, the nearest lit translucent layer, the
// volumetric fog and the WBOIT resolve.
//
// Replaces the epilogue of the Pallas kernel datum_tpu/ops/shade_pallas.py
// `_shade_kernel` (its tr / tr_ox, tr_oy / fog_* / oit_* groups,
// shade_pallas.py:414-469), which runs there in the same pass as the
// lighting.  Here the
// K2 kernel (csrc/shade.cu) first writes the lit background: lighting,
// sky fill, and the deeper lit layers tr2..tr4.  This kernel then, per
// pixel:
//  * refraction (with the tr_ox / tr_oy planes): the x offset picks the
//    nearest step of (-8, -3, 0, 3, 8) and fetches from x + step, wrapping
//    over the full row; the y offset picks the nearest step of (-4, -2, 0,
//    2, 4) and fetches from y + step, wrapping inside the pixel's 16-row
//    band (the TPU kernel's SHADE_ROWS grid step).  The two are separable,
//    x then y: the pixel reads the x-shifted background of row y2 =
//    wrap(y + sy), whose x step is picked from tr_ox at (x, y2).  Only
//    where tr_a > 0; elsewhere the unshifted colour stays;
//  * the nearest lit layer: col = bg * (1 - tr_a) + tr * tr_a;
//  * the fog (with the fog_r, fog_g, fog_b, fog_t planes): col * fog_t +
//    fog_rgb, as one fma(col, fog_t, fog_rgb), the form XLA's contraction
//    gives the TPU kernel's expression;
//  * the WBOIT resolve: col * rev + oit * (1 / max(w, 1e-5)) * (1 - rev),
//    as one fma, in the form XLA's contraction gives the TPU kernel's
//    expression: fma(oit * inv_w, 1 - rev, col * rev) when the call
//    refracts (the refraction group is given), else fma(col, rev, oit *
//    inv_w * (1 - rev)).
// Nearest-step ties keep the earlier (more negative) step, as the TPU
// kernel's strict `<` does.  pltpu.roll(p, (-s) % n) is jnp.roll: it
// reads p[i + s], which is what the index arithmetic below does.
//
// What bounds it on the H100.  Per pixel it reads 3 f32 background
// values (one of them at the refracted position), up to 15 bf16 planes,
// and writes 3 f32 values: ~54 B/pixel, ~113 MB a 1920x1088 frame, ~34 us
// at 3.35 TB/s.  A few dozen operations per pixel: memory-bound.
//
// What the design does about it.  One thread per pixel over a 2-D grid
// of 32 x 8 blocks, so a warp reads 32 consecutive pixels of a row; the
// refracted reads land within +-8 columns and +-4 rows (the same band)
// of the warp's own and are served from L1/L2.  No shared memory: a
// 16 x 1920 band of three f32 planes (368 KB) would not fit in a block.
// Built with -fmad=false like K2, with the fog's and the resolve's fmas
// written out, so it rounds as the plain version does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BX = 32, BY = 8;
constexpr int BAND = 16;     // the TPU kernel's SHADE_ROWS: y wraps inside it

__device__ __forceinline__ float bf(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
}

// the ladder step nearest off (ties keep the earlier step)
__device__ __forceinline__ int pick(float off, const int (&steps)[5]) {
    float best = 1e9f;
    int s_best = 0;
    for (int k = 0; k < 5; ++k) {
        const float d = fabsf(off - (float)steps[k]);
        if (d < best) {
            best = d;
            s_best = steps[k];
        }
    }
    return s_best;
}

__global__ void __launch_bounds__(BX * BY)
shade_epilogue_kernel(const float* __restrict__ bg,               // (3, H, W)
                      const __nv_bfloat16* __restrict__ tr,       // (4, H, W) or null
                      const __nv_bfloat16* __restrict__ refr,     // (2, H, W) or null
                      const __nv_bfloat16* __restrict__ fog,      // (4, H, W) or null
                      const __nv_bfloat16* __restrict__ oit,      // (5, H, W) or null
                      int H, int W, float* __restrict__ out)      // (3, H, W)
{
    const int steps_x[5] = {-8, -3, 0, 3, 8};
    const int steps_y[5] = {-4, -2, 0, 2, 4};
    const int x = blockIdx.x * BX + threadIdx.x;
    const int y = blockIdx.y * BY + threadIdx.y;
    if (x >= W || y >= H) return;
    const size_t plane = (size_t)H * W;
    const size_t o = (size_t)y * W + x;

    float col[3] = {bg[o], bg[plane + o], bg[2 * plane + o]};
    if (tr != nullptr) {
        const float a = bf(tr, 3 * plane + o);
        float b[3] = {col[0], col[1], col[2]};
        if (refr != nullptr && a > 0.0f) {
            const int band0 = (y / BAND) * BAND;
            const int sy = pick(bf(refr, plane + o), steps_y);
            const int y2 = band0 + (((y - band0 + sy) % BAND) + BAND) % BAND;
            const int sx = pick(bf(refr, (size_t)y2 * W + x), steps_x);
            const int x2 = (((x + sx) % W) + W) % W;
            const size_t o2 = (size_t)y2 * W + x2;
            for (int c = 0; c < 3; ++c) b[c] = bg[c * plane + o2];
        }
        for (int c = 0; c < 3; ++c)
            col[c] = b[c] * (1.0f - a) + bf(tr, c * plane + o) * a;
    }
    if (fog != nullptr) {
        const float fog_t = bf(fog, 3 * plane + o);
        for (int c = 0; c < 3; ++c)
            col[c] = __fmaf_rn(col[c], fog_t, bf(fog, c * plane + o));
    }
    if (oit != nullptr) {
        const float rev = bf(oit, 4 * plane + o);
        const float inv_w = 1.0f / fmaxf(bf(oit, 3 * plane + o), 1e-5f);
        const float oit_alpha = 1.0f - rev;
        const bool refracted = tr != nullptr && refr != nullptr;   // per call, not per pixel
        for (int c = 0; c < 3; ++c)
            col[c] = refracted
                ? __fmaf_rn(bf(oit, c * plane + o) * inv_w, oit_alpha, col[c] * rev)
                : __fmaf_rn(col[c], rev, bf(oit, c * plane + o) * inv_w * oit_alpha);
    }
    for (int c = 0; c < 3; ++c) out[c * plane + o] = col[c];
}

}  // namespace

// bg (3, H, W) f32 (K2's output); tr (4, H, W), refr (2, H, W), fog
// (4, H, W) and oit (5, H, W) bf16, each or null (refr is read only with
// tr); H a multiple of 16; out (3, H, W) f32, not aliasing bg (refraction
// reads neighbours).
extern "C" int shade_epilogue_launch(const float* bg, const void* tr, const void* refr,
                                     const void* fog, const void* oit, int H, int W,
                                     float* out, void* stream)
{
    const dim3 block(BX, BY);
    const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY);
    shade_epilogue_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        bg, (const __nv_bfloat16*)tr, (const __nv_bfloat16*)refr,
        (const __nv_bfloat16*)fog, (const __nv_bfloat16*)oit, H, W, out);
    return (int)cudaGetLastError();
}
