// K2: deferred-shade megakernel, opaque branches.
//
// Replaces the Pallas kernel datum_tpu/ops/shade_pallas.py
// `_shade_kernel` (launched by `shade_deferred_pallas`) for the planes
// PLANE_NAMES (+ the optional sky fill): world position from reverse-Z
// depth, SH-9 ambient with the SH probe blend, split-sum env specular,
// the sun with its shadow-factor plane and bent light vector, the point
// lights (dense, in chunks of `point_chunk`; or clustered: the list of
// the pixel's 16-row band and 128-column sub-tile), shadowed spot slots
// with factor planes then the unshadowed remainder, emissive, and the
// sky fill of uncovered pixels; with `envd`, the box env-probe diffuse
// override (the `edm` group, shade_pallas.py:229-234): where the bf16
// edm plane is > 0.5, edr/edg/edb replace the SH-9 env diffuse before
// the SH probe blend.  The nearest lit layer's blend, its refraction,
// the fog and the WBOIT resolve are the epilogue kernel's
// (shade_epilogue.cu).
//
// What bounds it on the H100.  Per pixel it reads 2 f32 + 18..25 bf16
// planes (+ ao and factor planes) and writes 3 f32 planes: ~56 B/pixel,
// ~120 MB a 1920x1088 frame, ~40 us at 3.35 TB/s.  The arithmetic is
// ~150 f32 operations per light with several divides and square roots,
// so with 8 point lights plus the sun and a spot the kernel is bound by
// issue rate, not by memory; with clusters a pixel pays only for the
// lights of its sub-tile's list.
//
// What the design does about it.
//  * One thread per pixel over a 2-D grid: loads and stores of a warp
//    are 32 consecutive pixels of one row (coalesced, bf16 halves the
//    plane bytes as on the TPU).
//  * The 64 params and the light, spot and probe rows the loops can read
//    are staged once per block in shared memory; every read is a
//    broadcast.  Only the rows below the live counts are staged.
//  * The TPU kernel's clamped table reads and `on` masks are kept, so a
//    padded row never turns into NaN * 0.
//  * Clustered lights (the TPU kernel's per-sub-tile loop): a block of
//    32 x 8 pixels lies inside one 16-row band and one 128-column
//    sub-tile, so it stages that cell's list (ascending light ids) in
//    shared memory once and every thread walks it in list order, adding
//    each light with no mask, as the TPU kernel does.  Ids are clamped
//    to the staged rows (below the live count).
//  * Built with -fmad=false like K1, so the arithmetic rounds as the
//    plain PyTorch version's does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float INV_PI = 0.3183098861837907f;
constexpr int PARAMS = 64;
constexpr int LROW = 16;      // light / spot table row
constexpr int PROW = 32;      // probe table row
constexpr int BX = 32, BY = 8;

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 add3(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale3(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 madd3(V3 a, V3 b, float s) {
    return {a.x + b.x * s, a.y + b.y * s, a.z + b.z * s};
}
__device__ __forceinline__ float rsqrt_exact(float x) { return 1.0f / sqrtf(x); }
__device__ __forceinline__ V3 normalize3(V3 a) {
    return scale3(a, rsqrt_exact(fmaxf(dot3(a, a), 1e-12f)));
}
__device__ __forceinline__ float sat(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ float pow5(float x) { float x2 = x * x; return x2 * x2 * x; }

struct Angles { float ndv, ndl, ndh, ldh; };

__device__ __forceinline__ Angles angles(V3 nrm, V3 eye, V3 lv) {
    V3 hv = normalize3(add3(lv, eye));
    return {fmaxf(dot3(nrm, eye), 0.0f), fmaxf(dot3(nrm, lv), 0.0f),
            fmaxf(dot3(nrm, hv), 0.0f), sat(dot3(lv, hv))};
}

__device__ __forceinline__ float disney(float ndv, float ndl, float ldh, float alpha) {
    const float bias = 0.5f * alpha;
    const float factor = 1.0f + alpha * (float)(1.0 / 1.51 - 1.0);
    const float f90 = bias + 2.0f * ldh * ldh * alpha;
    const float ls = 1.0f + (f90 - 1.0f) * pow5(sat(1.0f - ndl));
    const float vs = 1.0f + (f90 - 1.0f) * pow5(sat(1.0f - ndv));
    return ls * vs * factor;
}

__device__ __forceinline__ V3 spec_ggx(V3 spec, Angles a, float alpha) {
    const float fc = pow5(sat(1.0f - a.ldh));
    const V3 f = {spec.x + (1.0f - spec.x) * fc, spec.y + (1.0f - spec.y) * fc,
                  spec.z + (1.0f - spec.z) * fc};
    const float k = alpha * 0.5f;
    const float gv = a.ndv * (1.0f - k) + k;
    const float gl = a.ndl * (1.0f - k) + k;
    const float vis = 0.25f / (gv * gl + 1e-5f);
    const float a2 = alpha * alpha;
    const float d = (a.ndh * a2 - a.ndh) * a.ndh + 1.0f;
    const float dist = a2 / (d * d);
    return scale3(f, vis * dist);
}

struct Light { V3 dif, spc, lv; };

// one point light: row = [pos xyz, intensity rgb, attenuation q l c range]
__device__ __forceinline__ Light eval_light(V3 wp, V3 nrm, V3 eye, V3 spec, float alpha,
                                            const float* row) {
    const V3 tolight = {row[0] - wp.x, row[1] - wp.y, row[2] - wp.z};
    const float d2 = fmaxf(dot3(tolight, tolight), 1e-12f);
    const float inv_d = rsqrt_exact(d2);
    const float dist = d2 * inv_d;
    const V3 lv = scale3(tolight, inv_d);
    const Angles a = angles(nrm, eye, lv);
    const float fd = disney(a.ndv, a.ndl, a.ldh, alpha) * INV_PI;
    const V3 fr = spec_ggx(spec, a, alpha);
    const float att = 1.0f / fmaxf(row[8] + row[7] * dist + row[6] * d2, 1e-9f);
    const float dr2 = d2 / fmaxf(row[9] * row[9], 1e-12f);
    const float fall = sat(1.0f - dr2 * dr2);
    const float w = a.ndl * att * (fall * fall);
    Light out;
    out.dif = {w * fd * row[3], w * fd * row[4], w * fd * row[5]};
    out.spc = {w * INV_PI * fr.x * row[3], w * INV_PI * fr.y * row[4],
               w * INV_PI * fr.z * row[5]};
    out.lv = lv;
    return out;
}

__device__ __forceinline__ float bf(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
}

// bf16 plane order (after depth, visf); the sky group, then the env
// override group (edr, edg, edb, edm), then the deeper lit layers follow
// the groups given
enum { NX, NY, NZ, DR, DG, DB, EM, SR, SG, SB, RGH, ESR, ESG, ESB, EB0, EB1, EB2, SF,
       SKY_R, SKY_G, SKY_B };

__global__ void __launch_bounds__(BX * BY)
shade_kernel(const float* __restrict__ f32_planes,          // (2, H, W): depth, visf
             const __nv_bfloat16* __restrict__ planes,      // (n_bf16, H, W)
             int has_sky, int envd, int n_trk,
             const __nv_bfloat16* __restrict__ ao,          // (H, W) or null
             const __nv_bfloat16* __restrict__ spotsf,      // (n_maps, H, W) or null
             int n_maps,
             const float* __restrict__ params,
             const float* __restrict__ lights, int n_lights_rows,
             const float* __restrict__ spots, int n_spot_rows,
             const float* __restrict__ probes, int n_probe_rows,
             const int* __restrict__ counts, int point_chunk,
             const int* __restrict__ cl_lists,  // (H/16, W/128, cl_cap) or null
             const int* __restrict__ cl_counts, // (H/16, W/128)
             int cl_cap, int H, int W, float cx, float cy,
             float* __restrict__ out)                       // (3, H, W)
{
    extern __shared__ float smem[];
    float* P = smem;                                   // PARAMS
    float* L = P + PARAMS;                             // n_lights_rows * LROW
    float* S = L + n_lights_rows * LROW;               // n_spot_rows * LROW
    float* Q = S + n_spot_rows * LROW;                 // n_probe_rows * PROW
    int* CL = (int*)(Q + n_probe_rows * PROW);         // cl_cap

    const bool clustered = cl_lists != nullptr;
    const int n_point = counts[0];
    const int n_spot = counts[1];
    const int n_probe = min(counts[3], n_probe_rows);
    const int nchunks = (n_point + point_chunk - 1) / point_chunk;
    // rows the loops can touch (dense reads past a table are clamped to
    // its last row; cluster ids to the live rows)
    const int l_rows = min(n_lights_rows, max(clustered ? n_point : nchunks * point_chunk, 1));
    const int s_rows = min(n_spot_rows, max(max(n_spot, n_maps), 1));

    const int tid = threadIdx.y * BX + threadIdx.x;
    const int nth = BX * BY;
    for (int i = tid; i < PARAMS; i += nth) P[i] = params[i];
    for (int i = tid; i < l_rows * LROW; i += nth) L[i] = lights[i];
    if (l_rows < n_lights_rows) {   // the clamp target: the table's last row
        for (int i = tid; i < LROW; i += nth)
            L[(n_lights_rows - 1) * LROW + i] = lights[(n_lights_rows - 1) * LROW + i];
    }
    for (int i = tid; i < s_rows * LROW; i += nth) S[i] = spots[i];
    if (s_rows < n_spot_rows) {
        for (int i = tid; i < LROW; i += nth)
            S[(n_spot_rows - 1) * LROW + i] = spots[(n_spot_rows - 1) * LROW + i];
    }
    for (int i = tid; i < n_probe * PROW; i += nth) Q[i] = probes[i];
    // the block's cell: one 16-row band and one 128-column sub-tile
    const int cell = ((blockIdx.y * BY) / 16) * (W / 128) + (blockIdx.x * BX) / 128;
    const int cl_n = clustered ? min(cl_counts[cell], cl_cap) : 0;
    for (int i = tid; i < cl_n; i += nth) CL[i] = cl_lists[(size_t)cell * cl_cap + i];
    __syncthreads();

    const int x = blockIdx.x * BX + threadIdx.x;
    const int y = blockIdx.y * BY + threadIdx.y;
    if (x >= W || y >= H) return;
    const size_t plane = (size_t)H * W;
    const size_t o = (size_t)y * W + x;

    const float yn = ((P[26] + (float)y) + 0.5f) * cy - 1.0f;
    const float xn = ((float)x + 0.5f) * cx - 1.0f;

    const float depth = f32_planes[o];
    const bool mask = f32_planes[plane + o] >= 0.0f;

    // world position from reverse-Z depth (background clamp included)
    float denom = depth + P[2];
    if (fabsf(denom) < 1e-7f) denom = denom < 0.0f ? -1e-7f : 1e-7f;
    const float dist = P[3] / denom;
    const float vx = P[0] * xn * dist;
    const float vy = P[1] * yn * dist;
    const float vz = -dist;
    const V3 wp = {P[4] * vx + P[5] * vy + P[6] * vz + P[7],
                   P[8] * vx + P[9] * vy + P[10] * vz + P[11],
                   P[12] * vx + P[13] * vy + P[14] * vz + P[15]};
    const V3 campos = {P[7], P[11], P[15]};
    const V3 eye = normalize3(sub3(campos, wp));

    const V3 nrm = normalize3(v3(bf(planes, NX * plane + o), bf(planes, NY * plane + o),
                                 bf(planes, NZ * plane + o)));
    const V3 dcol = v3(bf(planes, DR * plane + o), bf(planes, DG * plane + o),
                       bf(planes, DB * plane + o));
    const V3 scol = v3(bf(planes, SR * plane + o), bf(planes, SG * plane + o),
                       bf(planes, SB * plane + o));
    const float rough = bf(planes, RGH * plane + o);
    const float alpha = rough * rough;
    const V3 espec = v3(bf(planes, ESR * plane + o), bf(planes, ESG * plane + o),
                        bf(planes, ESB * plane + o));
    const float eb0 = bf(planes, EB0 * plane + o);
    const float eb1 = bf(planes, EB1 * plane + o);
    const float eb2 = bf(planes, EB2 * plane + o);

    // ---- ambient / IBL
    float ambient = P[23];
    if (ao != nullptr) ambient = ambient * bf(ao, o);
    const float ndv_s = dot3(nrm, eye);
    const float fdd = sat(((ndv_s * (1.02341f * rough - 1.51174f))
                           + (-0.511705f * rough + 0.755868f)) * rough);
    const V3 ddir = normalize3(madd3(nrm, sub3(eye, nrm), fdd));
    float env[3];
    {
        const float bx = ddir.x, by = ddir.y, bz = ddir.z;
        const float basis[9] = {0.886227f, 1.023326f * by, 1.023326f * bz, 1.023326f * bx,
                                0.858086f * bx * by, 0.858086f * by * bz,
                                0.247708f * (3.0f * bz * bz - 1.0f), 0.858086f * bz * bx,
                                0.429043f * (bx * bx - by * by)};
        for (int c = 0; c < 3; ++c) {
            float acc = basis[0] * P[27 + c];
            for (int k = 1; k < 9; ++k) acc = acc + basis[k] * P[27 + 3 * k + c];
            env[c] = fmaxf(acc, 0.0f) * INV_PI;
        }
    }
    // the box env probes' diffuse, on the bf16 edm (0.5 keeps the SH-9)
    const int grp0 = has_sky ? SKY_B + 1 : SKY_R;     // the first plane after the sky
    if (envd && bf(planes, (size_t)(grp0 + 3) * plane + o) > 0.5f) {
        for (int c = 0; c < 3; ++c) env[c] = bf(planes, (size_t)(grp0 + c) * plane + o);
    }
    // local SH probes blended by radial falloff
    if (n_probe_rows > 0) {
        const float bx = nrm.x, by = nrm.y, bz = nrm.z;
        const float pb[9] = {0.886227f, 1.023326f * by, 1.023326f * bz, 1.023326f * bx,
                             0.858086f * bx * by, 0.858086f * by * bz,
                             0.247708f * (3.0f * bz * bz - 1.0f), 0.858086f * bz * bx,
                             0.429043f * (bx * bx - by * by)};
        float total_w = 1.0f;
        for (int pi = 0; pi < n_probe; ++pi) {
            const float* q = Q + pi * PROW;
            const float dx = q[0] - wp.x, dy = q[1] - wp.y, dz = q[2] - wp.z;
            const float pd = sqrtf(dx * dx + dy * dy + dz * dz);
            const float drr = pd / fmaxf(q[3], 1e-6f);
            const float dr2 = drr * drr;
            float att = sat(1.0f - dr2 * dr2);
            att = att * att;
            for (int c = 0; c < 3; ++c) {
                float irr = pb[0] * q[4 + c];
                for (int k = 1; k < 9; ++k) irr = irr + pb[k] * q[4 + 3 * k + c];
                env[c] = env[c] + fmaxf(irr, 0.0f) * att;
            }
            total_w = total_w + att;
        }
        const float inv_tw = 1.0f / total_w;
        for (int c = 0; c < 3; ++c) env[c] = env[c] * inv_tw;
    }

    // env split-sum apply (f90 = 0.8)
    V3 dif = {env[0] * eb2 * ambient, env[1] * eb2 * ambient, env[2] * eb2 * ambient};
    const float specint = P[25];
    V3 spc = {espec.x * (scol.x * eb0 + 0.8f * eb1) * ambient * specint,
              espec.y * (scol.y * eb0 + 0.8f * eb1) * ambient * specint,
              espec.z * (scol.z * eb0 + 0.8f * eb1) * ambient * specint};

    // ---- sun with the shadow-factor plane and the bent light vector
    {
        const float sf = bf(planes, SF * plane + o);
        const V3 ldir = {P[16], P[17], P[18]};
        const V3 r_ = madd3(scale3(nrm, 2.0f * dot3(nrm, eye)), eye, -1.0f);
        const float ldr = dot3(ldir, r_);
        const V3 bent = madd3(ldir, sub3(r_, ldir), rough);
        const V3 lv = normalize3(ldr >= P[22] ? bent : ldir);
        const Angles a = angles(nrm, eye, lv);
        const float fd = disney(a.ndv, a.ndl, a.ldh, alpha) * INV_PI;
        const V3 fr = spec_ggx(scol, a, alpha);
        const float wsun = a.ndl * sf;
        dif = {dif.x + wsun * fd * P[19], dif.y + wsun * fd * P[20], dif.z + wsun * fd * P[21]};
        spc = {spc.x + wsun * INV_PI * fr.x * P[19], spc.y + wsun * INV_PI * fr.y * P[20],
               spc.z + wsun * INV_PI * fr.z * P[21]};
    }

    // ---- point lights: the cell's list (clustered), in list order
    for (int j = 0; j < cl_n; ++j) {
        const int li = min(max(CL[j], 0), l_rows - 1);
        const Light l = eval_light(wp, nrm, eye, scol, alpha, L + li * LROW);
        dif = {dif.x + l.dif.x, dif.y + l.dif.y, dif.z + l.dif.z};
        spc = {spc.x + l.spc.x, spc.y + l.spc.y, spc.z + l.spc.z};
    }
    // ---- or every light, dense chunks (clamped reads + on mask)
    for (int c = 0; c < (clustered ? 0 : nchunks); ++c) {
        for (int j = 0; j < point_chunk; ++j) {
            const int idx = c * point_chunk + j;
            const int ridx = min(idx, n_lights_rows - 1);
            const float on = idx < n_point ? 1.0f : 0.0f;
            const Light l = eval_light(wp, nrm, eye, scol, alpha, L + ridx * LROW);
            dif = {dif.x + on * l.dif.x, dif.y + on * l.dif.y, dif.z + on * l.dif.z};
            spc = {spc.x + on * l.spc.x, spc.y + on * l.spc.y, spc.z + on * l.spc.z};
        }
    }

    // ---- spot lights: shadowed slots (factor planes), then the rest
    const int nsp = max(n_spot - n_maps, 0);
    for (int m = 0; m < n_maps + nsp; ++m) {
        const float shadow = m < n_maps ? bf(spotsf, (size_t)m * plane + o) : 1.0f;
        const float* row = S + min(m, n_spot_rows - 1) * LROW;
        const Light l = eval_light(wp, nrm, eye, scol, alpha, row);
        const V3 sd = {row[10], row[11], row[12]};
        const float cone = sat((-dot3(sd, l.lv) - row[13]) * 20.0f);
        const float on = (m < n_spot ? 1.0f : 0.0f) * cone * shadow;
        dif = {dif.x + on * l.dif.x, dif.y + on * l.dif.y, dif.z + on * l.dif.z};
        spc = {spc.x + on * l.spc.x, spc.y + on * l.spc.y, spc.z + on * l.spc.z};
    }

    const float exposure = P[24];
    const float em = bf(planes, EM * plane + o);
    const float em_term = 128.0f * em * em * em;
    const float d3[3] = {dcol.x, dcol.y, dcol.z};
    const float da[3] = {dif.x, dif.y, dif.z};
    const float sa[3] = {spc.x, spc.y, spc.z};
    float col[3];
    for (int c = 0; c < 3; ++c) {
        col[c] = d3[c] * (da[c] + em_term) + sa[c];
        col[c] = mask ? col[c] * exposure : 0.0f;
        if (has_sky) col[c] = mask ? col[c] : bf(planes, (SKY_R + c) * plane + o) * exposure;
    }
    // deeper lit translucent layers (tr2, tr3, tr4 as r, g, b, a planes
    // after the sky), blended under the nearest one, deepest first
    const int trk0 = grp0 + (envd ? 4 : 0);
    for (int k = n_trk - 1; k >= 0; --k) {
        const int b = trk0 + 4 * k;
        const float a = bf(planes, (size_t)(b + 3) * plane + o);
        for (int c = 0; c < 3; ++c)
            col[c] = col[c] * (1.0f - a) + bf(planes, (size_t)(b + c) * plane + o) * a;
    }
    for (int c = 0; c < 3; ++c) out[c * plane + o] = col[c];
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

extern "C" int shade_launch(const float* f32_planes, const void* planes, int has_sky,
                            int envd, int n_trk, const void* ao, const void* spotsf, int n_maps,
                            const float* params, const float* lights, int n_lights_rows,
                            const float* spots, int n_spot_rows, const float* probes,
                            int n_probe_rows, const int* counts, int point_chunk,
                            const int* cl_lists, const int* cl_counts, int cl_cap,
                            int H, int W, float cx, float cy, float* out, void* stream)
{
    const dim3 block(BX, BY);
    const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY);
    const int smem = shade_smem_bytes(n_lights_rows, n_spot_rows, n_probe_rows, cl_cap);
    shade_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        f32_planes, (const __nv_bfloat16*)planes, has_sky, envd, n_trk,
        (const __nv_bfloat16*)ao,
        (const __nv_bfloat16*)spotsf, n_maps, params, lights, n_lights_rows, spots,
        n_spot_rows, probes, n_probe_rows, counts, point_chunk, cl_lists, cl_counts,
        cl_cap, H, W, cx, cy, out);
    return (int)cudaGetLastError();
}
