// The deferred branch's lighting pass: one thread a pixel, every light
// term summed in registers, one hdr write.
//
// It replaces no Pallas kernel: the JAX package runs this pass
// (datum_tpu/ops/lighting_pass.py::shade_deferred) in XLA, which fuses
// it.  Its plain version, ops/lighting_pass.py::shade_deferred, runs it
// as PyTorch operations, each a full-resolution pass over its operands:
// the SH probe term stacks 9 basis planes into an (H, W, 9, 3) product
// once a probe slot, and each point light writes a dozen temporaries.
// This kernel computes what that version computes per pixel at full
// resolution, from the same inputs: the gbuffer decode, the world
// position from reverse-Z depth (a band of rows: y0 and the frame's
// height), the eye vector, the ambient times ssao, the sky's SH-9
// diffuse (the fast environment path; otherwise env_diff is a plane),
// the SH probe blend over the live slots (the count read from device
// memory), the split-sum IBL apply or the constant-ambient fallback, the
// sun with its factor plane, the dense point lights or the pixel's
// cluster tile list, the spots (the first n_maps shadowed by the
// single-tap perspective test of ops/shadow.py::spot_shadow_factor),
// emissive and exposure, 0 off the mask.  The reduced-resolution
// environment and sun taps and their upsamples stay PyTorch
// operations; their planes are inputs here.
//
// What bounds it on the H100.  A covered pixel reads 21 f32 values on
// the fast environment path (depth, the normal, diffuse and specular
// float4s, ssao, the env specular and env BRDF planes, the sun factor;
// 3 more with an env diffuse plane) and its mask byte, and writes 3: 97 B;
// a background pixel reads its mask and writes 12 B.  A 1920x1088 frame
// covered whole moves ~203 MB, ~0.061 ms at 3.35 TB/s (chip_smoke.py's
// bound counts the frame's covered pixels).  The sun, 8 point lights, a
// spot and the IBL apply are ~1,000 FP32 operations a covered pixel,
// ~0.03 ms at 67 TFLOP/s: bytes bound it, with the correctly rounded
// divides and square roots (below) costing instruction throughput.
//
// What the design does about it.
//  * One thread a pixel, pixels in row-major order, so that a warp's
//    loads of a plane are one contiguous run (16 B a thread for the
//    gbuffer's float4 planes); nothing but the hdr is written.
//  * A block a run of 256 pixels; it stages the params, the live dense
//    point lights, the live spots and the live SH probes in shared
//    memory (768 B on the deferred cell's frame, read from L2), then
//    shades its pixels.  The clustered loop reads its light rows from
//    device memory (any light of the table can be in a list; a warp's 32
//    pixels share a tile, so its reads are uniform).
//  * Background pixels (mask false) write 0 and compute nothing.
//  * The probe loop runs to min(count, slots): the plain version adds 0
//    times each slot past the count, which leaves a finite sum as it is.
//
// Rounding.  Built with -fmad=false (ops/_kernels.py), unlike K2: the
// kernel is bound by bytes, so contracting multiply-adds buys nothing,
// and every operation then rounds as the plain version's PyTorch
// operation does, in its order, not only the view and light geometry
// that K2 pins with __fmul_rn / __fadd_rn: the GGX term of a smooth
// surface near its highlight turns an ulp of n.h into percents.  Divides
// and square roots are IEEE (nvcc's defaults), as torch's are.  Where
// PyTorch on the card divides by a host scalar it multiplies by the
// scalar's float reciprocal (the pixel grid's 1 / W and 1 / H, the
// spot cone's / 0.05, the SH diffuse's / pi), and so does this kernel.
// The 3x3 products (the world position, the sky rotation, the spot
// projection) are FMA chains in k order, as cuBLAS accumulates them;
// PyTorch's reductions and its matrix-vector product sum in the orders
// measured on the card (dot3, sh9, the spot's w; PERF.md).  With them the
// kernel matched the plain version bit for bit on every test case and on
// the deferred cell's frame, but it is held within atol 1e-4 / rtol 1e-3:
// those orders are PyTorch's and cuBLAS's to change (the matrix-vector
// product's already changes with the pixel count).

#include <cuda_runtime.h>

namespace {

constexpr int PARAMS = 64;    // see ops/lighting_cuda.py::PARAMS_LAYOUT
constexpr int LROW = 12;      // point light: position, intensity, attenuation (q l c range)
constexpr int SROW = 32;      // spot: those, direction, cutoff, shadowview (4x4 row-major)
constexpr int PROW = 32;      // SH probe: position, radius, 9x3 coefficients
constexpr int THREADS = 256;
constexpr int TILE_H = 32;    // the light clusters' tiles (ops/cluster.py)
constexpr int TILE_W = 128;
constexpr double PI_D = 3.14159265358979;     // ops/brdf.py::PI
constexpr float INV_PI = (float)(1.0 / PI_D);
constexpr float PI_F = (float)PI_D;

// params layout
enum { P_PROJ = 0, P_INVVIEW = 4, P_SUNDIR = 16, P_SUNCOL = 19, P_SUNCUT = 22,
       P_AMBIENT = 23, P_EXPOSURE = 24, P_SPECI = 25, P_SKYROT = 26, P_SKYSH = 35 };

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 add3(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul3(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
// (a * b).sum(-1) as torch's CUDA reduction sums 3 terms: two threads an
// output, the first adding terms 0 and 2, then the second's term 1
__device__ __forceinline__ float dot3(V3 a, V3 b) { return (a.x * b.x + a.z * b.z) + a.y * b.y; }
__device__ __forceinline__ float sat(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ float pow5(float x) { const float x2 = x * x; return x2 * x2 * x; }

// brdf.normalize: v / sqrt(max(v.v, 1e-12))
__device__ __forceinline__ V3 normalize3(V3 v) {
    const float s = sqrtf(fmaxf(dot3(v, v), 1e-12f));
    return {v.x / s, v.y / s, v.z / s};
}

// row . v of a 3-column product as cuBLAS accumulates it (k in order)
__device__ __forceinline__ float dot_k(const float* row, V3 v) {
    return fmaf(v.z, row[2], fmaf(v.y, row[1], v.x * row[0]));
}

__device__ __forceinline__ V3 load3(const float* p, size_t i) {
    return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

// brdf.probe_irradiance: SH-9 irradiance of (unnormalised) n against
// coefficient rows c[3k + channel], clamped at 0
__device__ __forceinline__ V3 sh9(V3 n, const float* c) {
    const float x = n.x, y = n.y, z = n.z;
    const float b[9] = {(float)(PI_D * 0.282095),
                        (float)(2.094395 * 0.488603) * y,
                        (float)(2.094395 * 0.488603) * z,
                        (float)(2.094395 * 0.488603) * x,
                        (float)(0.785398 * 1.092548) * x * y,
                        (float)(0.785398 * 1.092548) * y * z,
                        (float)(0.785398 * 0.315392) * (3.0f * z * z - 1.0f),
                        (float)(0.785398 * 1.092548) * z * x,
                        (float)(0.785398 * 0.546274) * (x * x - y * y)};
    // the sum over the 9 terms as torch's CUDA reduction takes it: four
    // accumulators (terms k, k + 4, k + 8), then added in order
    float v[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const auto t = [&](int k) { return b[k] * c[3 * k + ch]; };
        const float a0 = (t(0) + t(4)) + t(8), a1 = t(1) + t(5), a2 = t(2) + t(6),
                    a3 = t(3) + t(7);
        v[ch] = fmaxf(((a0 + a1) + a2) + a3, 0.0f);
    }
    return {v[0], v[1], v[2]};
}

struct Surf {
    V3 wp, n, e, scol;
    float alpha;
    V3 dif, spc;
};

// brdf._lobes: (n.l, Disney diffuse / pi, GGX specular / pi per channel)
struct Lobes { float ndl, fd; V3 fr; };

__device__ __forceinline__ Lobes lobes(const Surf& s, V3 l) {
    const V3 h = normalize3(add3(l, s.e));
    const float ndv = fmaxf(dot3(s.n, s.e), 0.0f);
    const float ndl = fmaxf(dot3(s.n, l), 0.0f);
    const float ndh = fmaxf(dot3(s.n, h), 0.0f);
    const float ldh = sat(dot3(l, h));
    const float a = s.alpha;
    const float energy = 1.0f + a * (float)(1.0 / 1.51 - 1.0);
    const float f90 = 0.5f * a + 2.0f * ldh * ldh * a;
    const float fl = 1.0f + (f90 - 1.0f) * pow5(sat(1.0f - ndl));
    const float fv = 1.0f + (f90 - 1.0f) * pow5(sat(1.0f - ndv));
    const float fd = fl * fv * energy * INV_PI;
    const float fc = pow5(sat(1.0f - ldh));
    const float a2 = a * a;
    const float f = (ndh * a2 - ndh) * ndh + 1.0f;
    const float d = a2 / (f * f);
    const float k = a * 0.5f;
    const float gl = ndl * (1.0f - k) + k;
    const float gv = ndv * (1.0f - k) + k;
    const float dv = d * (0.25f / (gv * gl + 1e-5f));
    const V3 fr = {dv * (s.scol.x + (1.0f - s.scol.x) * fc) * INV_PI,
                   dv * (s.scol.y + (1.0f - s.scol.y) * fc) * INV_PI,
                   dv * (s.scol.z + (1.0f - s.scol.z) * fc) * INV_PI};
    return {ndl, fd, fr};
}

// adds w * (fd, fr) * col to (dif, spc) as brdf's light evaluators do:
// (w * fd) * col and (w * fr) * col
__device__ __forceinline__ void add_lobes(V3& dif, V3& spc, const Lobes& lb, float w, V3 col) {
    const float wd = w * lb.fd;
    dif = add3(dif, {wd * col.x, wd * col.y, wd * col.z});
    spc = add3(spc, {(w * lb.fr.x) * col.x, (w * lb.fr.y) * col.y, (w * lb.fr.z) * col.z});
}

// brdf.point_light / spot_light: light row r at s, into (dif, spc); a
// spot (r holds its direction and cutoff) scales by its cone and shadow
template <bool SPOT>
__device__ __forceinline__ void add_light(const Surf& s, const float* r, float shadow,
                                          V3& dif, V3& spc) {
    const V3 tl = sub3({r[0], r[1], r[2]}, s.wp);
    const float dist = sqrtf(fmaxf(dot3(tl, tl), 1e-12f));
    float att = 1.0f / fmaxf(r[8] + r[7] * dist + r[6] * dist * dist, 1e-9f);
    const float dr = dist / fmaxf(r[9], 1e-6f);
    const float dr2 = dr * dr;
    const float fall = sat(1.0f - dr2 * dr2);
    const V3 l = {tl.x / dist, tl.y / dist, tl.z / dist};
    const Lobes lb = lobes(s, l);
    att = (lb.ndl > 0.0f ? att : 0.0f * att) * fall * fall;
    float w;
    if (SPOT) {
        const float cone = dot3({r[10], r[11], r[12]}, {-l.x, -l.y, -l.z});
        att = att * sat((cone - r[13]) * (1.0f / 0.05f));
        w = lb.ndl * att * shadow;
    } else {
        w = lb.ndl * att;
    }
    add_lobes(dif, spc, lb, w, {r[3], r[4], r[5]});
}

// shadow.py::spot_shadow_factor: 1 outside the map, else the single tap
// against the reference depth plus its bias
__device__ __forceinline__ float spot_shadow(V3 wp, const float* sv, const float* map, int res) {
    const float hx = dot_k(sv, wp) + sv[3];
    const float hy = dot_k(sv + 4, wp) + sv[7];
    const float hz = dot_k(sv + 8, wp) + sv[11];
    // worldpos @ shadowview[3, :3], a matrix-vector product, sums as torch
    // does on a frame's pixel count (the first and last products fused)
    const float ww = (fmaf(wp.z, sv[14], wp.x * sv[12]) + wp.y * sv[13]) + sv[15];
    const float ws = fabsf(ww) < 1e-8f ? 1e-8f : ww;
    const float u = hx / ws * 0.5f + 0.5f;
    const float v = hy / ws * 0.5f + 0.5f;
    const float ref = hz / ws;
    const bool inside = u > 0.0f && u < 1.0f && v > 0.0f && v < 1.0f && ref > 0.0f
                        && ref < 1.0f && ww > 0.0f;
    if (!inside) return 1.0f;
    const float fres = (float)res;
    const int xi = min(max((int)fminf(fmaxf(u * fres, -1.0f), fres), 0), res - 1);
    const int yi = min(max((int)fminf(fmaxf(v * fres, -1.0f), fres), 0), res - 1);
    return map[(size_t)yi * res + xi] <= ref + 2e-3f ? 1.0f : 0.0f;
}

struct Args {
    const float* depth;               // (H, W) reverse-Z
    const float4* normal;             // (H, W, 4): the gbuffer planes
    const float4* diffuse;
    const float4* specular;
    const unsigned char* mask;        // (H, W) bool
    const float* ssao;                // (H, W) or null
    const float* env_spec;            // (H, W, 3) or null: no environment
    const float* env_brdf;            // (H, W, 3)
    const float* env_diff;            // (H, W, 3) or null: the sky's SH-9
    const float* sf;                  // (H, W) or null: 1
    const float* spotmaps;            // (n_maps, res, res) or null
    int n_maps, map_res;
    const float* params;              // (PARAMS,)
    const float* lights;              // (n_light_rows, LROW)
    int n_light_rows, n_point;
    const float* spots;               // (>= n_spot, SROW)
    int n_spot;
    const float* probes;              // (n_probe_rows, PROW)
    int n_probe_rows;
    const int* probe_count;           // (1,)
    const int* cl_lists;              // (n_tiles, cl_cap) or null: dense
    const int* cl_counts;             // (n_tiles,)
    int cl_cap, tiles_x;
    int H, W, y0, full_h, full_w;
    float* out;                       // (H, W, 3)
};

__device__ __forceinline__ void shade_pixel(const Args& a, const float* P, const float* L,
                                            const float* S, const float* Q, int n_probe,
                                            int n_point, int n_spot, int p) {
    float* o = a.out + (size_t)p * 3;
    if (!a.mask[p]) {
        o[0] = 0.0f; o[1] = 0.0f; o[2] = 0.0f;
        return;
    }
    const int y = p / a.W, x = p - y * a.W;

    // the gbuffer: normal (not renormalised), material, emissive
    const float4 nr = a.normal[p], df = a.diffuse[p], sp = a.specular[p];
    Surf s;
    s.n = {nr.x * 2.0f - 1.0f, nr.y * 2.0f - 1.0f, nr.z * 2.0f - 1.0f};
    const V3 dcol = {df.x, df.y, df.z};
    s.scol = {sp.x, sp.y, sp.z};
    const float rough = sp.w;
    s.alpha = rough * rough;
    const float em = 128.0f * (df.w * df.w * df.w);

    // lighting_pass.reconstruct_positions: the pixel's view ray, the view
    // distance from reverse-Z depth (the denominator kept from 0), the
    // world position
    const float xn = ((float)x + 0.5f) * (1.0f / (float)a.full_w) * 2.0f - 1.0f;
    const float yn = ((float)y + (float)a.y0 + 0.5f) * (1.0f / (float)a.full_h) * 2.0f - 1.0f;
    const float denom = a.depth[p] + P[P_PROJ + 2];
    const float dist = P[P_PROJ + 3]
        / (fabsf(denom) < 1e-7f ? (denom < 0.0f ? -1e-7f : 1e-7f) : denom);
    const V3 vp = {(1.0f / P[P_PROJ]) * xn * dist, (1.0f / P[P_PROJ + 1]) * yn * dist, -dist};
    const float* iv = P + P_INVVIEW;
    s.wp = {dot_k(iv, vp) + iv[3], dot_k(iv + 4, vp) + iv[7], dot_k(iv + 8, vp) + iv[11]};
    s.e = normalize3(sub3({iv[3], iv[7], iv[11]}, s.wp));
    const float amb = a.ssao != nullptr ? P[P_AMBIENT] * a.ssao[p] : P[P_AMBIENT];

    // ---- the environment: its diffuse (the plane, or the sky's SH-9
    // along the rough-bent direction), the SH probe blend, the split-sum
    // apply; without one the constant ambient
    if (a.env_spec != nullptr) {
        V3 ed;
        if (a.env_diff != nullptr) {
            ed = load3(a.env_diff, p);
        } else {
            const float fa = 1.02341f * rough - 1.51174f;
            const float fb = -0.511705f * rough + 0.755868f;
            const float f = sat((dot3(s.n, s.e) * fa + fb) * rough);
            const V3 dd = normalize3(add3(s.n, mul3(sub3(s.e, s.n), f)));
            const float* R = P + P_SKYROT;
            ed = mul3(sh9({dot_k(R, dd), dot_k(R + 3, dd), dot_k(R + 6, dd)}, P + P_SKYSH),
                      1.0f / PI_F);
        }
        if (a.n_probe_rows > 0) {
            float tw = 1.0f;
            for (int i = 0; i < n_probe; ++i) {
                const float* q = Q + i * PROW;
                const V3 pd3 = sub3({q[0], q[1], q[2]}, s.wp);
                const float dr = sqrtf(dot3(pd3, pd3)) / fmaxf(q[3], 1e-6f);
                const float dr2 = dr * dr;
                float att = sat(1.0f - dr2 * dr2);
                att = att * att;
                ed = add3(ed, mul3(sh9(s.n, q + 4), att));
                tw = tw + att;
            }
            ed = {ed.x / tw, ed.y / tw, ed.z / tw};
        }
        const V3 es = load3(a.env_spec, p), eb = load3(a.env_brdf, p);
        s.dif = mul3(mul3(ed, eb.z), amb);
        s.spc = {es.x * (s.scol.x * eb.x + 0.8f * eb.y) * amb * P[P_SPECI],
                 es.y * (s.scol.y * eb.x + 0.8f * eb.y) * amb * P[P_SPECI],
                 es.z * (s.scol.z * eb.x + 0.8f * eb.y) * amb * P[P_SPECI]};
    } else {
        const float a02 = amb * 0.2f;
        s.dif = {a02, a02, a02};
        s.spc = {0.0f, 0.0f, 0.0f};
    }

    // ---- brdf.main_light: the sun with the roughness-bent light vector
    {
        const V3 ld = {-P[P_SUNDIR], -P[P_SUNDIR + 1], -P[P_SUNDIR + 2]};
        const float t = 2.0f * dot3(s.n, s.e);
        const V3 r = sub3(mul3(s.n, t), s.e);
        const float ldr = dot3(ld, r);
        const V3 bent = add3(ld, mul3(sub3(r, ld), rough));
        const V3 l = normalize3(ldr < P[P_SUNCUT] ? ld : bent);
        const Lobes lb = lobes(s, l);
        const float sf = a.sf != nullptr ? a.sf[p] : 1.0f;
        add_lobes(s.dif, s.spc, lb, lb.ndl * sf,
                  {P[P_SUNCOL], P[P_SUNCOL + 1], P[P_SUNCOL + 2]});
    }

    // ---- point lights: the tile's list (clustered: the tile's sum, then
    // added), or every live light
    if (a.cl_lists != nullptr) {
        const int tile = (y / TILE_H) * a.tiles_x + x / TILE_W;
        const int* list = a.cl_lists + (size_t)tile * a.cl_cap;
        const int n = min(a.cl_counts[tile], a.cl_cap);
        V3 cd = {0.0f, 0.0f, 0.0f}, cs = {0.0f, 0.0f, 0.0f};
        // bin_lights' ids lie in the table; clamped, a bad list reads no
        // memory past it
        for (int k = 0; k < n; ++k)
            add_light<false>(s, a.lights + (size_t)min(max(list[k], 0), a.n_light_rows - 1)
                                           * LROW, 1.0f, cd, cs);
        s.dif = add3(s.dif, cd);
        s.spc = add3(s.spc, cs);
    } else {
        for (int i = 0; i < n_point; ++i) add_light<false>(s, L + i * LROW, 1.0f, s.dif, s.spc);
    }

    // ---- spot lights: the first n_maps with their perspective test
    for (int i = 0; i < n_spot; ++i) {
        const float* r = S + i * SROW;
        const float shadow = i < a.n_maps
            ? spot_shadow(s.wp, r + 14,
                          a.spotmaps + (size_t)i * a.map_res * a.map_res, a.map_res)
            : 1.0f;
        add_light<true>(s, r, shadow, s.dif, s.spc);
    }

    // ---- emissive, exposure
    const float ex = P[P_EXPOSURE];
    o[0] = (dcol.x * s.dif.x + s.spc.x + em * dcol.x) * ex;
    o[1] = (dcol.y * s.dif.y + s.spc.y + em * dcol.y) * ex;
    o[2] = (dcol.z * s.dif.z + s.spc.z + em * dcol.z) * ex;
}

// two blocks an SM at least, which keeps ptxas from spilling (71
// registers, none spilled; without the bound it spilled 16 bytes)
__global__ void __launch_bounds__(THREADS, 2)
lighting_kernel(Args a)
{
    extern __shared__ float smem[];
    float* P = smem;                                  // PARAMS
    float* L = P + PARAMS;                            // n_point * LROW (dense)
    float* S = L + (a.cl_lists != nullptr ? 0 : a.n_point) * LROW;   // n_spot * SROW
    float* Q = S + a.n_spot * SROW;                   // n_probe_rows * PROW

    const int n_probe = min(max(a.probe_count[0], 0), a.n_probe_rows);
    const int n_dense = a.cl_lists != nullptr ? 0 : a.n_point;
    const int tid = threadIdx.x;
    for (int i = tid; i < PARAMS; i += THREADS) P[i] = a.params[i];
    for (int i = tid; i < n_dense * LROW; i += THREADS) L[i] = a.lights[i];
    for (int i = tid; i < a.n_spot * SROW; i += THREADS) S[i] = a.spots[i];
    for (int i = tid; i < n_probe * PROW; i += THREADS) Q[i] = a.probes[i];
    __syncthreads();

    const int p = blockIdx.x * THREADS + tid;
    if (p < a.H * a.W) shade_pixel(a, P, L, S, Q, n_probe, n_dense, a.n_spot, p);
}

}  // namespace

// Dynamic shared memory of a launch: the params, the dense lights (none
// when clustered), the live spots, every probe slot.
extern "C" int lighting_smem_bytes(int n_point, int n_spot, int n_probe_rows, int clustered)
{
    return (PARAMS + (clustered ? 0 : n_point) * LROW + n_spot * SROW + n_probe_rows * PROW)
           * (int)sizeof(float);
}

extern "C" int lighting_launch(const float* depth, const void* normal, const void* diffuse,
                               const void* specular, const void* mask, const float* ssao,
                               const float* env_spec, const float* env_brdf,
                               const float* env_diff, const float* sf, const float* spotmaps,
                               int n_maps, int map_res, const float* params,
                               const float* lights, int n_light_rows, int n_point,
                               const float* spots, int n_spot,
                               const float* probes, int n_probe_rows, const int* probe_count,
                               const int* cl_lists, const int* cl_counts, int cl_cap,
                               int tiles_x, int H, int W, int y0, int full_h, int full_w,
                               float* out, void* stream)
{
    const Args a{depth, (const float4*)normal, (const float4*)diffuse, (const float4*)specular,
                 (const unsigned char*)mask, ssao, env_spec, env_brdf, env_diff, sf, spotmaps,
                 n_maps, map_res, params, lights, n_light_rows, n_point, spots, n_spot,
                 probes, n_probe_rows, probe_count, cl_lists, cl_counts, cl_cap,
                 tiles_x, H, W, y0, full_h, full_w, out};
    const int smem = lighting_smem_bytes(n_point, n_spot, n_probe_rows, cl_lists != nullptr);
    lighting_kernel<<<(H * W + THREADS - 1) / THREADS, THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
