// K2: deferred-shade megakernel, opaque branches.
//
// Replaces the Pallas kernel datum_tpu/ops/shade_pallas.py
// `_shade_kernel` (launched by `shade_deferred_pallas`) for the planes
// PLANE_NAMES (+ the optional sky fill): world position from reverse-Z
// depth, SH-9 ambient with the SH probe blend, split-sum env specular,
// the sun with its shadow-factor plane and bent light vector, the point
// lights (dense; or clustered: the list of the pixel's 16-row band and
// 128-column sub-tile), shadowed spot slots with factor planes then the
// unshadowed remainder, emissive, and the sky fill of uncovered pixels;
// with `envd`, the box env-probe diffuse override (the `edm` group,
// shade_pallas.py:229-234): where the bf16 edm plane is > 0.5,
// edr/edg/edb replace the SH-9 env diffuse before the SH probe blend.
// The nearest lit layer's blend, its refraction, the fog and the WBOIT
// resolve are the epilogue kernel's (shade_epilogue.cu).
//
// What bounds it on the H100.  Per pixel it reads 2 f32 + 18..25 bf16
// planes (+ ao and factor planes) and writes 3 f32 planes: ~56 B/pixel,
// ~120 MB a 1920x1088 frame, ~40 us at 3.35 TB/s.  The arithmetic is
// ~200 f32 operations a pixel and ~60 a light, with square roots and
// quotients: with 8 point lights, the sun and a spot the kernel is
// bound by the instructions it issues, not by memory; with clusters a
// pixel pays only for the lights of its sub-tile's list.
//
// What the design does about it.
//  * Two horizontally adjacent pixels a thread.  Where the width is even
//    each plane is read as __nv_bfloat162 (float2 for depth and visf, and
//    the output), so a warp reads 128 B of a bf16 plane at once; each
//    light, spot and probe row is read from shared memory once for both
//    pixels.  An odd width takes the same code with scalar loads.
//  * A persistent grid: a few blocks a SM (from the occupancy API), each
//    staging the 64 params and the light, spot and probe rows the loops
//    can read once in shared memory, then taking every gridDim.x-th unit
//    of 4 rows x 128 columns (256 threads x 2 pixels); unit u is sub-row
//    u % 4 of cluster cell u / 4 (16-row band, 128-column sub-tile).
//    With clusters a block stages a cell's light list (ascending light
//    ids) when its next unit lies in another cell, and every thread walks
//    it in list order, adding each light with no mask, as the TPU kernel
//    does.  With a grid of a few hundred blocks a block's next unit is
//    almost always in another cell, so the list is staged again, behind
//    two __syncthreads, for nearly every unit of 512 pixels: a copy of at
//    most cl_cap ids (128 on the stress frame), against 512 pixels x the list's lights.  Contiguous
//    ranges of units would stage each list once, but the cells of long
//    lists lie together and a few blocks then take all of them: that
//    form made the clustered input 1.5x slower (PERF.md).
//  * Light, spot and cluster ids are clamped to the staged rows: below
//    the live count and to the table's last row, as the plain version
//    reads them.
//  * Dense point lights and spots run to their live counts: the TPU
//    kernel's slots past a count add on * value with on = 0, which leaves
//    a finite sum as it is.
//  * Per-pixel terms that do not depend on the light (n.v, the view's
//    Schlick and Smith terms) are computed once a pixel.
//  * Arithmetic.  rsqrtf (MUFU.RSQ) wherever the TPU kernel calls
//    jax.lax.rsqrt and the plain version torch.rsqrt: every normalise and
//    the light distance.  __fdividef (a reciprocal times the dividend) in
//    place of the correctly rounded divide in: the Smith term 0.25 /
//    (gv*gl + 1e-5), the GGX a2 / (d*d), the light attenuation
//    1 / max(...), the range falloff d2 / max(range^2, 1e-12) and the
//    probe falloff pd / max(radius, 1e-6) (both as the dividend times a
//    reciprocal taken once a row), and the probe blend's 1 / total_w.
//    The world position's P[3] / denom stays a correctly rounded divide,
//    and the probe distance's square root sqrtf, as in the plain version.
//    The file is built with -fmad=true (ops/_kernels.py): nvcc contracts
//    the shading terms' multiply-adds, but the view and light geometry
//    (pixel centre, world position, eye, normal, light and half vectors,
//    n.h, the GGX denominator, the sun's bent vector and its threshold)
//    is written with __fmul_rn / __fadd_rn, which round as the plain
//    version's torch ops (see dot3_rn).  K2 is held to its plain version
//    within atol 1e-4 / rtol 1e-3, not bit for bit.
//  * Every array is indexed by constants after unrolling: nothing lives
//    in local memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float INV_PI = 0.3183098861837907f;
constexpr int PARAMS = 64;
constexpr int LROW = 16;      // light / spot table row
constexpr int PROW = 32;      // probe table row
constexpr int THREADS = 256;
constexpr int NPX = 2;        // pixels a thread, horizontally adjacent
constexpr int UNIT_W = 128;   // a unit: 4 rows x 128 columns
constexpr int UNIT_H = THREADS * NPX / UNIT_W;              // 4
constexpr int BAND = 16;      // rows of a cluster band
constexpr int UNITS_PER_CELL = BAND / UNIT_H;                // 4

struct V3 { float x, y, z; };

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale3(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 madd3(V3 a, V3 b, float s) {
    return {a.x + b.x * s, a.y + b.y * s, a.z + b.z * s};
}
__device__ __forceinline__ V3 normalize3(V3 a) {
    return scale3(a, rsqrtf(fmaxf(dot3(a, a), 1e-12f)));
}
// The view and light geometry rounds as the plain version's torch ops do
// (one rounding an operation, in their order): __fmul_rn and __fadd_rn
// are never contracted into FMAs, while the shading terms around them
// are.  The GGX term of a smooth surface near its highlight,
// a2 / (1 - ndh^2 (1 - a2))^2, turns an ulp of n.h into percents: with
// every product fused, K2 missed its plain version by 10.3 of ~830 on
// the bench's water (roughness 0.06) in the lit layer.
__device__ __forceinline__ float dot3_rn(V3 a, V3 b) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
}
__device__ __forceinline__ V3 add3_rn(V3 a, V3 b) {
    return {__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z)};
}
__device__ __forceinline__ V3 normalize3_rn(V3 a) {
    return scale3(a, rsqrtf(fmaxf(dot3_rn(a, a), 1e-12f)));
}
__device__ __forceinline__ float sat(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ float pow5(float x) { float x2 = x * x; return x2 * x2 * x; }

// SH-9 irradiance of direction d against 9 rgb coefficient rows c
// (c[3k + channel]), clamped at 0
__device__ __forceinline__ V3 sh9(V3 d, const float* c) {
    const float b[9] = {0.886227f, 1.023326f * d.y, 1.023326f * d.z, 1.023326f * d.x,
                        0.858086f * d.x * d.y, 0.858086f * d.y * d.z,
                        0.247708f * (3.0f * d.z * d.z - 1.0f), 0.858086f * d.z * d.x,
                        0.429043f * (d.x * d.x - d.y * d.y)};
    V3 acc = {b[0] * c[0], b[0] * c[1], b[0] * c[2]};
#pragma unroll
    for (int k = 1; k < 9; ++k) acc = madd3(acc, {c[3 * k], c[3 * k + 1], c[3 * k + 2]}, b[k]);
    return {fmaxf(acc.x, 0.0f), fmaxf(acc.y, 0.0f), fmaxf(acc.z, 0.0f)};
}

// One pixel's surface, with the light-independent terms of its BRDF.
struct Surf {
    V3 wp, nrm, eye, scol;
    float alpha, a2, k, factor;  // k = alpha / 2, also Burley's f90 bias
    float ndv, p5v, gv;          // max(n.v, 0), its Schlick power, Smith term
    V3 dif, spc;
};

// One light row held in registers: [pos xyz, intensity rgb, attenuation
// q l c range] (+ spot direction and cutoff), with the range's reciprocal.
struct LRow { V3 pos, col; float q, l, c, inv_r2; };

__device__ __forceinline__ LRow load_row(const float* r) {
    return {{r[0], r[1], r[2]}, {r[3], r[4], r[5]}, r[6], r[7], r[8],
            __fdividef(1.0f, fmaxf(r[9] * r[9], 1e-12f))};
}

// Adds one light of colour col from direction lv (unit) to s, its n.l
// weight scaled by w_on (the attenuation, the falloff, a spot's cone and
// shadow, the sun's factor plane).
__device__ __forceinline__ void add_brdf(Surf& s, V3 lv, V3 col, float w_on) {
    const V3 hv = normalize3_rn(add3_rn(lv, s.eye));
    const float ndl = fmaxf(dot3(s.nrm, lv), 0.0f);
    const float ndh = fmaxf(dot3_rn(s.nrm, hv), 0.0f);
    const float ldh = sat(dot3(lv, hv));
    const float f90 = s.k + 2.0f * ldh * ldh * s.alpha;
    const float fd = (1.0f + (f90 - 1.0f) * pow5(sat(1.0f - ndl)))
                     * (1.0f + (f90 - 1.0f) * s.p5v) * s.factor * INV_PI;
    const float fc = pow5(sat(1.0f - ldh));
    const float gl = ndl * (1.0f - s.k) + s.k;
    const float vis = __fdividef(0.25f, s.gv * gl + 1e-5f);
    const float d = __fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(ndh, s.a2), ndh), ndh), 1.0f);
    const float spec = vis * __fdividef(s.a2, __fmul_rn(d, d)) * INV_PI;
    const float w = ndl * w_on;
    s.dif = madd3(s.dif, col, w * fd);
    s.spc = {s.spc.x + w * spec * (s.scol.x + (1.0f - s.scol.x) * fc) * col.x,
             s.spc.y + w * spec * (s.scol.y + (1.0f - s.scol.y) * fc) * col.y,
             s.spc.z + w * spec * (s.scol.z + (1.0f - s.scol.z) * fc) * col.z};
}

// One point (or spot) light at s; on scales it (1 for a point light).
__device__ __forceinline__ void add_light(Surf& s, const LRow& r, float on) {
    const V3 tolight = sub3(r.pos, s.wp);
    const float d2 = fmaxf(dot3_rn(tolight, tolight), 1e-12f);
    const float inv_d = rsqrtf(d2);
    const float dist = d2 * inv_d;
    const float att = __fdividef(1.0f, fmaxf(r.c + r.l * dist + r.q * d2, 1e-9f));
    const float dr2 = d2 * r.inv_r2;
    const float fall = sat(1.0f - dr2 * dr2);
    add_brdf(s, scale3(tolight, inv_d), r.col, att * (fall * fall) * on);
}

// bf16 plane order (after depth, visf); the sky group, then the env
// override group (edr, edg, edb, edm), then the deeper lit layers follow
// the groups given
enum { NX, NY, NZ, DR, DG, DB, EM, SR, SG, SB, RGH, ESR, ESG, ESB, EB0, EB1, EB2, SF,
       SKY_R, SKY_G, SKY_B };

// The two pixels' offsets o and o + 1.  PAIRED (an even width, so o is
// even): one 4-byte load for both; else two loads (o + 1 clamped to the
// row by the caller).
template <bool PAIRED>
struct Pix {
    size_t o0, o1;
    __device__ __forceinline__ void bf(const __nv_bfloat16* p, float v[NPX]) const {
        if (PAIRED) {
            const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p + o0);
            v[0] = __low2float(t);
            v[1] = __high2float(t);
        } else {
            v[0] = __bfloat162float(p[o0]);
            v[1] = __bfloat162float(p[o1]);
        }
    }
    __device__ __forceinline__ void f32(const float* p, float v[NPX]) const {
        if (PAIRED) {
            const float2 t = *reinterpret_cast<const float2*>(p + o0);
            v[0] = t.x;
            v[1] = t.y;
        } else {
            v[0] = p[o0];
            v[1] = p[o1];
        }
    }
    __device__ __forceinline__ void store(float* p, const float v[NPX], bool second) const {
        if (PAIRED) {
            *reinterpret_cast<float2*>(p + o0) = make_float2(v[0], v[1]);
        } else {
            p[o0] = v[0];
            if (second) p[o1] = v[1];
        }
    }
};

struct Args {
    const float* f32_planes;          // (2, H, W): depth, visf
    const __nv_bfloat16* planes;      // (n_bf16, H, W)
    int has_sky, envd, n_trk;
    const __nv_bfloat16* ao;          // (H, W) or null
    const __nv_bfloat16* spotsf;      // (n_maps, H, W) or null
    int n_maps;
    const float* params;
    const float* lights; int n_lights_rows;
    const float* spots; int n_spot_rows;
    const float* probes; int n_probe_rows;
    const int* counts;
    const int* cl_lists;              // (H/16, W/128, cl_cap) or null
    const int* cl_counts;             // (H/16, W/128)
    int cl_cap, H, W;
    float cx, cy;
    float* out;                       // (3, H, W)
};

// Shades the pixels x, x + 1 of row y (x + 1 < W unless !PAIRED) into out.
template <bool PAIRED>
__device__ __forceinline__ void shade_pair(const Args& a, const float* P, const float* L,
                                           const float* S, const float* Q, const int* CL,
                                           int cl_n, int l_rows, int n_point, int s_rows,
                                           int n_spot, int n_probe, int x, int y) {
    const size_t plane = (size_t)a.H * a.W;
    const size_t row = (size_t)y * a.W;
    const Pix<PAIRED> px{row + x, row + min(x + 1, a.W - 1)};
    const auto plane_bf = [&](int k, float v[NPX]) { px.bf(a.planes + (size_t)k * plane, v); };

    float depth[NPX], visf[NPX], t0[NPX], t1[NPX], t2[NPX];
    px.f32(a.f32_planes, depth);
    px.f32(a.f32_planes + plane, visf);
    const float yn = __fsub_rn(__fmul_rn(__fadd_rn(P[26] + (float)y, 0.5f), a.cy), 1.0f);

    Surf s[NPX];
    float rough[NPX], eb0[NPX], eb1[NPX], eb2[NPX], amb[NPX], sf[NPX];
    V3 dcol[NPX], espec[NPX];
    plane_bf(NX, t0); plane_bf(NY, t1); plane_bf(NZ, t2);
#pragma unroll
    for (int i = 0; i < NPX; ++i) s[i].nrm = normalize3_rn({t0[i], t1[i], t2[i]});
    plane_bf(DR, t0); plane_bf(DG, t1); plane_bf(DB, t2);
#pragma unroll
    for (int i = 0; i < NPX; ++i) dcol[i] = {t0[i], t1[i], t2[i]};
    plane_bf(SR, t0); plane_bf(SG, t1); plane_bf(SB, t2);
#pragma unroll
    for (int i = 0; i < NPX; ++i) s[i].scol = {t0[i], t1[i], t2[i]};
    plane_bf(ESR, t0); plane_bf(ESG, t1); plane_bf(ESB, t2);
#pragma unroll
    for (int i = 0; i < NPX; ++i) espec[i] = {t0[i], t1[i], t2[i]};
    plane_bf(RGH, rough); plane_bf(EB0, eb0); plane_bf(EB1, eb1); plane_bf(EB2, eb2);
    plane_bf(SF, sf);
    if (a.ao != nullptr) px.bf(a.ao, amb);
#pragma unroll
    for (int i = 0; i < NPX; ++i) amb[i] = a.ao != nullptr ? P[23] * amb[i] : P[23];

    // world position from reverse-Z depth (background clamp included),
    // the eye vector, the surface's light-independent terms
    const V3 campos = {P[7], P[11], P[15]};
#pragma unroll
    for (int i = 0; i < NPX; ++i) {
        const float xn = __fsub_rn(__fmul_rn((float)(x + i) + 0.5f, a.cx), 1.0f);
        float denom = depth[i] + P[2];
        if (fabsf(denom) < 1e-7f) denom = denom < 0.0f ? -1e-7f : 1e-7f;
        const float dist = P[3] / denom;      // rounded as the plain version's
        const float vx = P[0] * xn * dist;
        const float vy = P[1] * yn * dist;
        const float vz = -dist;
        s[i].wp = {__fadd_rn(dot3_rn({P[4], P[5], P[6]}, {vx, vy, vz}), P[7]),
                   __fadd_rn(dot3_rn({P[8], P[9], P[10]}, {vx, vy, vz}), P[11]),
                   __fadd_rn(dot3_rn({P[12], P[13], P[14]}, {vx, vy, vz}), P[15])};
        s[i].eye = normalize3_rn(sub3(campos, s[i].wp));
        s[i].alpha = rough[i] * rough[i];
        s[i].a2 = s[i].alpha * s[i].alpha;
        s[i].k = s[i].alpha * 0.5f;
        s[i].factor = 1.0f + s[i].alpha * (float)(1.0 / 1.51 - 1.0);
        s[i].ndv = fmaxf(dot3(s[i].nrm, s[i].eye), 0.0f);
        s[i].p5v = pow5(sat(1.0f - s[i].ndv));
        s[i].gv = s[i].ndv * (1.0f - s[i].k) + s[i].k;
    }

    // ---- ambient / IBL: SH-9 along the rough-bent normal, the box
    // probes' diffuse on the bf16 edm (0.5 keeps the SH-9), the SH probes
    V3 env[NPX];
#pragma unroll
    for (int i = 0; i < NPX; ++i) {
        const float ndv_s = dot3(s[i].nrm, s[i].eye);
        const float r = rough[i];
        const float fdd = sat(((ndv_s * (1.02341f * r - 1.51174f))
                               + (-0.511705f * r + 0.755868f)) * r);
        env[i] = scale3(sh9(normalize3(madd3(s[i].nrm, sub3(s[i].eye, s[i].nrm), fdd)),
                            P + 27), INV_PI);
    }
    const int grp0 = a.has_sky ? SKY_B + 1 : SKY_R;     // the first plane after the sky
    if (a.envd) {
        float m[NPX];
        plane_bf(grp0 + 3, m);
        plane_bf(grp0, t0); plane_bf(grp0 + 1, t1); plane_bf(grp0 + 2, t2);
#pragma unroll
        for (int i = 0; i < NPX; ++i)
            if (m[i] > 0.5f) env[i] = {t0[i], t1[i], t2[i]};
    }
    if (n_probe > 0) {
        float total_w[NPX] = {1.0f, 1.0f};
        for (int pi = 0; pi < n_probe; ++pi) {
            const float* q = Q + pi * PROW;
            const V3 qp = {q[0], q[1], q[2]};
            const float inv_rad = __fdividef(1.0f, fmaxf(q[3], 1e-6f));
#pragma unroll
            for (int i = 0; i < NPX; ++i) {
                const V3 dd = sub3(qp, s[i].wp);
                const float drr = sqrtf(dot3(dd, dd)) * inv_rad;
                const float dr2 = drr * drr;
                float att = sat(1.0f - dr2 * dr2);
                att = att * att;
                env[i] = madd3(env[i], sh9(s[i].nrm, q + 4), att);
                total_w[i] = total_w[i] + att;
            }
        }
#pragma unroll
        for (int i = 0; i < NPX; ++i) env[i] = scale3(env[i], __fdividef(1.0f, total_w[i]));
    }

    // env split-sum apply (f90 = 0.8)
#pragma unroll
    for (int i = 0; i < NPX; ++i) {
        s[i].dif = scale3(env[i], eb2[i] * amb[i]);
        const float sa = amb[i] * P[25];
        s[i].spc = {espec[i].x * (s[i].scol.x * eb0[i] + 0.8f * eb1[i]) * sa,
                    espec[i].y * (s[i].scol.y * eb0[i] + 0.8f * eb1[i]) * sa,
                    espec[i].z * (s[i].scol.z * eb0[i] + 0.8f * eb1[i]) * sa};
    }

    // ---- sun with the shadow-factor plane and the bent light vector
    {
        const V3 ldir = {P[16], P[17], P[18]};
        const V3 scol_sun = {P[19], P[20], P[21]};
#pragma unroll
        for (int i = 0; i < NPX; ++i) {
            // the reflection, its cosine to the sun and the bent vector
            // pick the light vector by a threshold: rounded as the plain
            // version rounds them
            const float t = __fmul_rn(2.0f, dot3_rn(s[i].nrm, s[i].eye));
            const V3 r_ = add3_rn(scale3(s[i].nrm, t), scale3(s[i].eye, -1.0f));
            const float ldr = dot3_rn(ldir, r_);
            const V3 bent = add3_rn(ldir, scale3(sub3(r_, ldir), rough[i]));
            add_brdf(s[i], normalize3_rn(ldr >= P[22] ? bent : ldir), scol_sun, sf[i]);
        }
    }

    // ---- point lights: the cell's list (clustered), in list order; or
    // every live light
    const int n_walk = CL != nullptr ? cl_n : n_point;
    for (int j = 0; j < n_walk; ++j) {
        const int li = min(CL != nullptr ? max(CL[j], 0) : j, l_rows - 1);
        const LRow r = load_row(L + li * LROW);
#pragma unroll
        for (int i = 0; i < NPX; ++i) add_light(s[i], r, 1.0f);
    }

    // ---- spot lights: shadowed slots (factor planes), then the rest
    for (int m = 0; m < n_spot; ++m) {
        const float* row = S + min(m, s_rows - 1) * LROW;
        const LRow r = load_row(row);
        const V3 sd = {row[10], row[11], row[12]};
        const float cut = row[13];
        float shadow[NPX] = {1.0f, 1.0f};
        if (m < a.n_maps) px.bf(a.spotsf + (size_t)m * plane, shadow);
#pragma unroll
        for (int i = 0; i < NPX; ++i) {
            // the cone needs the light vector first: evaluate it, then
            // scale the light by cone * shadow
            const V3 tolight = sub3(r.pos, s[i].wp);
            const float d2 = fmaxf(dot3_rn(tolight, tolight), 1e-12f);
            const V3 lv = scale3(tolight, rsqrtf(d2));
            const float cone = sat((-dot3(sd, lv) - cut) * 20.0f);
            add_light(s[i], r, cone * shadow[i]);
        }
    }

    // ---- emissive, exposure, the sky fill, the deeper lit layers
    float em[NPX];
    plane_bf(EM, em);
    float col[3][NPX];
#pragma unroll
    for (int i = 0; i < NPX; ++i) {
        const bool mask = visf[i] >= 0.0f;
        const float em_term = 128.0f * em[i] * em[i] * em[i];
        col[0][i] = mask ? (dcol[i].x * (s[i].dif.x + em_term) + s[i].spc.x) * P[24] : 0.0f;
        col[1][i] = mask ? (dcol[i].y * (s[i].dif.y + em_term) + s[i].spc.y) * P[24] : 0.0f;
        col[2][i] = mask ? (dcol[i].z * (s[i].dif.z + em_term) + s[i].spc.z) * P[24] : 0.0f;
    }
    if (a.has_sky) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float sky[NPX];
            plane_bf(SKY_R + c, sky);
#pragma unroll
            for (int i = 0; i < NPX; ++i)
                if (!(visf[i] >= 0.0f)) col[c][i] = sky[i] * P[24];
        }
    }
    // deeper lit translucent layers (tr2, tr3, tr4 as r, g, b, a planes
    // after the sky and the env group), blended under the nearest one,
    // deepest first
    const int trk0 = grp0 + (a.envd ? 4 : 0);
    for (int k = a.n_trk - 1; k >= 0; --k) {
        const int b = trk0 + 4 * k;
        float al[NPX];
        plane_bf(b + 3, al);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float t[NPX];
            plane_bf(b + c, t);
#pragma unroll
            for (int i = 0; i < NPX; ++i) col[c][i] = col[c][i] * (1.0f - al[i]) + t[i] * al[i];
        }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) px.store(a.out + c * plane, col[c], x + 1 < a.W);
}

template <bool PAIRED>
__global__ void __launch_bounds__(THREADS, 2)
shade_kernel(Args a, int n_units)
{
    extern __shared__ float smem[];
    float* P = smem;                                     // PARAMS
    float* L = P + PARAMS;                               // n_lights_rows * LROW
    float* S = L + a.n_lights_rows * LROW;               // n_spot_rows * LROW
    float* Q = S + a.n_spot_rows * LROW;                 // n_probe_rows * PROW
    int* CL = (int*)(Q + a.n_probe_rows * PROW);         // cl_cap

    const bool clustered = a.cl_lists != nullptr;
    const int n_point = a.counts[0];
    const int n_spot = a.counts[1];
    const int n_probe = min(a.counts[3], a.n_probe_rows);
    // rows the loops can touch: light and spot ids are clamped to the
    // live rows and to the tables' last row, as the plain version reads
    // them (a count above a table's rows adds its last row again)
    const int l_rows = min(a.n_lights_rows, max(n_point, 1));
    const int s_rows = min(a.n_spot_rows, max(n_spot, 1));

    const int tid = threadIdx.x;
    for (int i = tid; i < PARAMS; i += THREADS) P[i] = a.params[i];
    for (int i = tid; i < l_rows * LROW; i += THREADS) L[i] = a.lights[i];
    for (int i = tid; i < s_rows * LROW; i += THREADS) S[i] = a.spots[i];
    for (int i = tid; i < n_probe * PROW; i += THREADS) Q[i] = a.probes[i];

    // unit u is sub-row u % 4 of cell u / 4 (a 16-row band and a
    // 128-column sub-tile); the block takes every gridDim.x-th unit, so
    // that the cells of long light lists, which lie together, spread
    // over the blocks
    const int n_sub = (a.W + UNIT_W - 1) / UNIT_W;
    int staged = -1;                                     // the cell CL holds
    int cl_n = 0;
    __syncthreads();
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int cell = u / UNITS_PER_CELL;
        const int band = cell / n_sub, sub = cell - band * n_sub;
        if (clustered && cell != staged) {               // uniform over the block
            __syncthreads();                             // the old list is done with
            cl_n = min(a.cl_counts[cell], a.cl_cap);
            for (int i = tid; i < cl_n; i += THREADS)
                CL[i] = a.cl_lists[(size_t)cell * a.cl_cap + i];
            staged = cell;
            __syncthreads();
        }
        const int y = band * BAND + (u % UNITS_PER_CELL) * UNIT_H + tid / (UNIT_W / NPX);
        const int x = sub * UNIT_W + (tid % (UNIT_W / NPX)) * NPX;
        if (y < a.H && x < a.W)
            shade_pair<PAIRED>(a, P, L, S, Q, clustered ? CL : nullptr, cl_n, l_rows,
                               n_point, s_rows, n_spot, n_probe, x, y);
    }
}

}  // namespace

// Dynamic shared memory the launch needs for its tables (cl_cap: the
// light lists' capacity, 0 without clusters).
extern "C" int shade_smem_bytes(int n_lights_rows, int n_spot_rows, int n_probe_rows,
                                int cl_cap)
{
    return (PARAMS + (n_lights_rows + n_spot_rows) * LROW + n_probe_rows * PROW)
           * (int)sizeof(float) + cl_cap * (int)sizeof(int);
}

template <bool PAIRED>
static int launch(const Args& a, int smem, cudaStream_t stream)
{
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shade_kernel<PAIRED>, THREADS,
                                                  smem);
    const int n_units = (a.H + BAND - 1) / BAND * UNITS_PER_CELL
                        * ((a.W + UNIT_W - 1) / UNIT_W);
    const int grid = max(1, min(n_units, n_sm * max(per_sm, 1)));
    shade_kernel<PAIRED><<<grid, THREADS, smem, stream>>>(a, n_units);
    return (int)cudaGetLastError();
}

extern "C" int shade_launch(const float* f32_planes, const void* planes, int has_sky,
                            int envd, int n_trk, const void* ao, const void* spotsf, int n_maps,
                            const float* params, const float* lights, int n_lights_rows,
                            const float* spots, int n_spot_rows, const float* probes,
                            int n_probe_rows, const int* counts,
                            const int* cl_lists, const int* cl_counts, int cl_cap,
                            int H, int W, float cx, float cy, float* out, void* stream)
{
    const Args a{f32_planes, (const __nv_bfloat16*)planes, has_sky, envd, n_trk,
                 (const __nv_bfloat16*)ao, (const __nv_bfloat16*)spotsf, n_maps, params,
                 lights, n_lights_rows, spots, n_spot_rows, probes, n_probe_rows, counts,
                 cl_lists, cl_counts, cl_cap, H, W, cx, cy, out};
    const int smem = shade_smem_bytes(n_lights_rows, n_spot_rows, n_probe_rows, cl_cap);
    return W % 2 == 0 ? launch<true>(a, smem, (cudaStream_t)stream)
                      : launch<false>(a, smem, (cudaStream_t)stream);
}
