// K19: the Fourier BSDF's f, pdf and sample_f, one thread a lane.
//
// Replaces rustracer_tpu/ops/fourier.py fourier_f (:274), fourier_pdf
// (:322) and fourier_sample_f (:342), with _gather_ak (:209), _crw_rows
// (:286) and rustracer_tpu/core/interpolation.py fourier (:197),
// sample_fourier (:208) and sample_catmull_rom_2d (:248). The plain
// versions are rustracer_tpu_torch/ops/fourier.py f_plain, pdf_plain and
// sample_f_plain.
//
// What bounds it: operations. A lane reads a few hundred bytes of tables
// (its 4 x 4 Catmull-Rom neighbours' coefficient runs, shared with the
// lanes around it), sums them into its coefficients a_k and evaluates the
// cosine series; sample_f evaluates the luminance's series and its
// integral 31 times (30 Newton-bisection steps and the last one). The
// design spends each of those operations once:
//
// - A lane's a_k are summed once, in chunks (kCap 8 orders where the
//   table set's m_pad is at most kCap, else kChunk 32): a chunk walks the
//   lane's 16 neighbour pairs in the reference's order (j = 4 b + a),
//   reading each pair's run at immediate offsets, so each a_k is bit for
//   bit the reference's, and keeps no list of the runs (the chunk and the
//   two weight sets are the registers a lane holds). f and pdf take the
//   series chunk by chunk. sample_f keeps the luminance's a_k through its
//   31 evaluations in registers up to kCap orders, above it in a slice of
//   shared memory of the lane's own (k-major, so a warp's reads are
//   conflict-free; kSliceThreads lanes a block, up to kSliceMax orders,
//   any order beyond summed again where it is taken). A slice was chosen
//   over a warp-cooperative lane: it needs no shuffle in the 31
//   evaluations (ptxas: 230 registers, no spill, so 4 blocks of 64 lanes
//   an SM, which the slice's 16 KB a block at 64 orders leaves room for).
// - The series takes cos(k phi) and sin(k phi) from one sincosf(phi) an
//   evaluation by the angle-addition recurrence (pbrt-v3's Fourier() and
//   SampleFourier()), in float32 with fused multiply-adds; each chunk's
//   float32 sums (sample_f: each kChunk orders') are added in double.
//   The recurrence drifts by about k * 3e-8 from the rounding of cos(phi)
//   and sin(phi), within the plain version's own rounding of phi * k; a
//   float32 sum over hundreds of orders does not (tools/
//   fourier_precision.py: on a 1000-order table of glossy lobes one
//   float32 sum lies 5.6e-6 from the plain series, which lies 3.1e-6 from
//   the exact one; the chunks, 3.1e-6). The reference calls cos(phi * k)
//   and sin(phi * k) per term, so the series' last bits differ from it,
//   within tools/texture_work.py compare_with_plain's tolerances.
// - The Catmull-Rom weights find their knot interval by bisection (the
//   padded knots of make_table_set increase strictly: the same index as
//   the reference's count of knots <= x).
//
// The Newton-bisection loops keep the reference's fixed trip counts (30
// steps; ceil(log2 N) + 1 bisection steps); sample_fourier's Newton step
// divides with __fdividef (2 ulp), which moved no sampled direction
// beyond compare_with_plain's 1e-4 on the recorded steps and the wide
// table, and took 11% off sample_f. A table whose runs would read
// outside its flat coefficients (never, for a table read from a file)
// takes the reference's clamped reads, order by order.
// tools/texture_work.py k19_work counts a call's bytes and operations.
#include "common.cuh"

namespace {

constexpr int kNewton = 30;
constexpr float kPi = 3.14159274101257324f;       // float32(pi)
constexpr float k2Pi = 6.28318548202514648f;      // float32(2 pi)
constexpr float kHalfPi = 1.57079637050628662f;   // float32(pi / 2)
constexpr float kInv2Pi = 0.159154936671257019f;  // float32(1 / (2 pi))
constexpr float kThird = 0.333333343267440796f;   // float32(1 / 3)
// a lane's orders in registers up to kCap; above, chunks of kChunk and
// sample_f's shared-memory slice
constexpr int kCap = 8, kChunk = 32;
constexpr int kThreads = 128;
// f and pdf are compiled for kMinBlocks blocks of kThreads an SM (at most
// 128 registers a thread): on a recorded testball-fourier step f ran 11%
// faster so than with the 118 registers ptxas took unbounded
constexpr int kMinBlocks = 4;
constexpr int kSliceThreads = 64;
constexpr int kSliceMax = (227 * 1024) / (4 * kSliceThreads);

struct Tabs {
    const float* mu;       // (T, N)
    const float* a_flat;   // (T, NC)
    const int* a_offset;   // (T, N * N)
    const int* m;          // (T, N * N)
    const float* a0;       // (T, N, N)
    const float* cdf;      // (T, N, N)
    const float* eta;      // (T,)
    const int* n_channels; // (T,)
    int N, NC, m_pad;
};

struct CR {
    int off;
    float w[4];
    bool valid;
};

// catmull_rom_weights of x against one table's knots
__device__ CR crw(const float* nodes, int N, float x) {
    CR c;
    c.valid = x >= __ldg(nodes) && x <= __ldg(nodes + N - 1);
    // the count of knots <= x, by bisection over the increasing knots
    int cnt = 0, len = N;
    while (len > 0) {
        int half = len >> 1;
        bool le = __ldg(nodes + cnt + half) <= x;
        cnt = le ? cnt + half + 1 : cnt;
        len = le ? len - half - 1 : half;
    }
    int idx = min(max(cnt - 1, 0), N - 2);
    float x0 = __ldg(nodes + idx), x1 = __ldg(nodes + idx + 1);
    float t = (x - x0) / fmaxf(x1 - x0, 1e-20f);
    float t2 = t * t;
    float t3 = t2 * t;
    float w1 = 2.0f * t3 - 3.0f * t2 + 1.0f;
    float w2 = -2.0f * t3 + 3.0f * t2;
    float xm1 = __ldg(nodes + max(idx - 1, 0));
    float w0_in = (t3 - 2.0f * t2 + t) * (x1 - x0) / fmaxf(x1 - xm1, 1e-20f);
    float w0_edge = t3 - 2.0f * t2 + t;
    bool hp = idx > 0;
    float w0 = hp ? -w0_in : 0.0f;
    w1 = hp ? w1 : w1 - w0_edge;
    w2 = w2 + (hp ? w0_in : w0_edge);
    float xp2 = __ldg(nodes + min(idx + 2, N - 1));
    float w3_in = (t3 - t2) * (x1 - x0) / fmaxf(xp2 - x0, 1e-20f);
    float w3_edge = t3 - t2;
    bool hn = idx + 2 < N;
    w1 = w1 - (hn ? w3_in : w3_edge);
    w2 = w2 + (hn ? 0.0f : w3_edge);
    float w3 = hn ? w3_in : 0.0f;
    c.off = idx - 1;
    c.w[0] = c.valid ? w0 : 0.0f;
    c.w[1] = c.valid ? w1 : 0.0f;
    c.w[2] = c.valid ? w2 : 0.0f;
    c.w[3] = c.valid ? w3 : 0.0f;
    return c;
}

// a lane's 4 x 4 Catmull-Rom neighbourhood in its table: the pairs
// (co.off + b, ci.off + a), j = 4 b + a, weight ci.w[a] co.w[b]
struct Hood {
    const float* a;   // the table's flat coefficients
    const int* ao;    // its a_offset
    const int* mm;    // its m
    int N, NC, m_pad;
    CR ci, co;
};

__device__ __forceinline__ Hood hood_of(const Tabs& g, int t, const CR& ci, const CR& co) {
    long long pairs = (long long)t * g.N * g.N;
    return {g.a_flat + (long long)t * g.NC, g.a_offset + pairs, g.m + pairs, g.N, g.NC, g.m_pad,
            ci, co};
}

// one chunk of a lane's coefficients: a[c][k] = a_{k0 + k} of channel c <
// C for k < KCAP, the neighbours' weighted runs added in order (bit for
// bit the reference's a_k), each run's orders at immediate offsets (the
// reference's clamped reads where a run would leave the flat
// coefficients). -> the lane's order count: the largest order of a pair
// of nonzero weight, at most m_pad
template <int C, int KCAP>
__device__ __forceinline__ int chunk(const Hood& h, int k0, float (&a)[C][KCAP]) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < KCAP; ++k) a[c][k] = 0.0f;
    int kmax = 0;
    // a row's four pairs unrolled, the rows not: the loads of all 16 pairs
    // in flight took up to 168 registers, and f, pdf and sample_f ran
    // 1.2-1.4x longer so on a recorded step
#pragma unroll 1
    for (int b = 0; b < 4; ++b) {
        int row = min(max(h.co.off + b, 0), h.N - 1);
        float wb = b == 0 ? h.co.w[0] : b == 1 ? h.co.w[1] : b == 2 ? h.co.w[2] : h.co.w[3];
#pragma unroll
        for (int ia = 0; ia < 4; ++ia) {
            float w = h.ci.w[ia] * wb;
            if (w == 0.0f) continue;
            int pair = row * h.N + min(max(h.ci.off + ia, 0), h.N - 1);
            int off = __ldg(h.ao + pair), m = __ldg(h.mm + pair);
            kmax = max(kmax, m);
            if (m <= k0) continue;
            if (off >= 0 && off + C * m <= h.NC) {
                const float* p = h.a + off + k0;
#pragma unroll
                for (int k = 0; k < KCAP; ++k) {
                    if (k0 + k < m) {
#pragma unroll
                        for (int c = 0; c < C; ++c) a[c][k] = a[c][k] + w * __ldg(p + c * m + k);
                    }
                }
            } else {
                for (int k = 0; k < KCAP; ++k) {
                    if (k0 + k < m) {
#pragma unroll
                        for (int c = 0; c < C; ++c) {
                            int idx = min(max(off + c * m + k0 + k, 0), h.NC - 1);
                            a[c][k] = a[c][k] + w * __ldg(h.a + idx);
                        }
                    }
                }
            }
        }
    }
    return min(kmax, h.m_pad);
}

// a_k of channel c alone, summed as chunk() does (the reads clamped)
__device__ float ak_at(const Hood& h, int c, int k) {
    float s = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        int row = min(max(h.co.off + b, 0), h.N - 1);
#pragma unroll
        for (int ia = 0; ia < 4; ++ia) {
            float w = h.ci.w[ia] * h.co.w[b];
            if (w == 0.0f) continue;
            int pair = row * h.N + min(max(h.ci.off + ia, 0), h.N - 1);
            int off = __ldg(h.ao + pair), m = __ldg(h.mm + pair);
            if (k < m) s = s + w * __ldg(h.a + min(max(off + c * m + k, 0), h.NC - 1));
        }
    }
    return s;
}

// cos and sin of (k + 1) phi from those of k phi and of phi
__device__ __forceinline__ void rotate(float& ck, float& sk, float c1, float s1) {
    float cn = fmaf(ck, c1, -(sk * s1));
    sk = fmaf(sk, c1, ck * s1);
    ck = cn;
}

// fourier() of channels c < C at cos_phi: sum_k a_k cos(k phi), the
// orders in chunks of KCAP, each chunk's float32 sums added in double
template <int C, int KCAP>
__device__ void series(const Hood& h, float cos_phi, float (&out)[C]) {
    float phi = acosf(fminf(fmaxf(cos_phi, -1.0f), 1.0f));
    float s1, c1;
    sincosf(phi, &s1, &c1);
    float ck = 1.0f, sk = 0.0f;
    double tot[C];
#pragma unroll
    for (int c = 0; c < C; ++c) tot[c] = 0.0;
    int k0 = 0, kmax;
    do {
        float a[C][KCAP], part[C];
        kmax = chunk<C>(h, k0, a);
#pragma unroll
        for (int c = 0; c < C; ++c) part[c] = 0.0f;
#pragma unroll
        for (int k = 0; k < KCAP; ++k) {
            if (k0 + k >= kmax) break;
#pragma unroll
            for (int c = 0; c < C; ++c) part[c] = fmaf(a[c][k], ck, part[c]);
            rotate(ck, sk, c1, s1);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) tot[c] += part[c];
        k0 += KCAP;
    } while (k0 < kmax);
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = (float)tot[c];
}

// _rgb_from_ak
template <int KCAP>
__device__ rt::V3 rgb(const Tabs& g, int t, const Hood& h, float cos_phi, float mu_i, float mu_o) {
    float scale = fabsf(mu_i) > 1e-20f ? 1.0f / fabsf(mu_i) : 0.0f;
    float eta = __ldg(g.eta + t);
    float e = mu_i > 0.0f ? 1.0f / eta : eta;
    scale = scale * (mu_i * mu_o > 0.0f ? e * e : 1.0f);
    if (__ldg(g.n_channels + t) == 1) {
        float y1[1];
        series<1, KCAP>(h, cos_phi, y1);
        float y = fmaxf(y1[0], 0.0f);
        return {y * scale, y * scale, y * scale};
    }
    float s[3];
    series<3, KCAP>(h, cos_phi, s);
    float y = fmaxf(s[0], 0.0f);
    float gg = 1.39829f * y - 0.100913f * s[2] - 0.297375f * s[1];
    return {fmaxf(s[1], 0.0f) * scale, fmaxf(gg, 0.0f) * scale, fmaxf(s[2], 0.0f) * scale};
}

// _mu_angles
__device__ void angles(rt::V3 wo, rt::V3 wi, float* mu_i, float* mu_o, float* cos_phi) {
    *mu_i = -wi.z;
    *mu_o = wo.z;
    float num = (-wi.x) * wo.x + (-wi.y) * wo.y;
    float den = sqrtf((wi.x * wi.x + wi.y * wi.y) * (wo.x * wo.x + wo.y * wo.y));
    float c = fminf(fmaxf(num / fmaxf(den, 1e-20f), -1.0f), 1.0f);
    *cos_phi = den < 1e-20f ? 1.0f : c;
}

__device__ __forceinline__ float spline_int(float t, float f0, float f1, float d0, float d1) {
    return t * (f0 + t * (0.5f * d0 + t * (kThird * (-2.0f * d0 - d1) + f1 - f0 +
                                           t * (0.25f * (d0 + d1) + 0.5f * (f0 - f1)))));
}

__device__ __forceinline__ float spline_val(float t, float f0, float f1, float d0, float d1) {
    return f0 + t * (d0 + t * (-2.0f * d0 - d1 + 3.0f * (f1 - f0) + t * (d0 + d1 + 2.0f * (f0 - f1))));
}

// interp(): the table's column idx at the weighted rows of c
__device__ __forceinline__ float interp(const float* tab, int N, const CR& c, int idx) {
    float out = 0.0f;
    for (int i = 0; i < 4; ++i) {
        int row = min(max(c.off + i, 0), N - 1);
        out = out + c.w[i] * __ldg(tab + row * N + idx);
    }
    return out;
}

// sample_catmull_rom_2d over one table's knots, a0 and cdf: -> x, pdf
__device__ void sample_2d(const float* nodes, const float* vals, const float* cdf, int N, float alpha,
                          float u, float* x_out, float* pdf_out) {
    CR c = crw(nodes, N, alpha);
    float maximum = interp(cdf, N, c, N - 1);
    u = u * maximum;
    int lo = 0, hi = N - 1;
    int steps = 0;
    while ((1 << steps) < max(2, N)) ++steps;
    for (int s = 0; s <= steps; ++s) {
        int mid = (lo + hi) / 2;
        bool le = interp(cdf, N, c, mid) <= u;
        lo = le ? mid : lo;
        hi = le ? hi : mid;
    }
    int idx = min(max(lo, 0), N - 2);
    float f0 = interp(vals, N, c, idx), f1 = interp(vals, N, c, idx + 1);
    float x0 = __ldg(nodes + idx), x1 = __ldg(nodes + idx + 1);
    float width = x1 - x0;
    float u_seg = (u - interp(cdf, N, c, idx)) / fmaxf(width, 1e-20f);
    int im1 = max(idx - 1, 0), ip2 = min(idx + 2, N - 1);
    float f_m1 = interp(vals, N, c, im1), f_p2 = interp(vals, N, c, ip2);
    float xm1 = __ldg(nodes + im1), xp2 = __ldg(nodes + ip2);
    float d0 = idx > 0 ? width * (f1 - f_m1) / fmaxf(x1 - xm1, 1e-20f) : f1 - f0;
    float d1 = idx + 2 < N ? width * (f_p2 - f0) / fmaxf(xp2 - x0, 1e-20f) : f1 - f0;
    // invert_spline_segment
    bool lin = fabsf(f0 - f1) > 1e-12f;
    float t = lin ? (f0 - sqrtf(fmaxf(f0 * f0 + 2.0f * u_seg * (f1 - f0), 0.0f))) / (f0 - f1)
                  : u_seg / fmaxf(f0, 1e-20f);
    float a = 0.0f, b = 1.0f;
    for (int it = 0; it < kNewton; ++it) {
        t = (t >= a && t <= b) ? t : 0.5f * (a + b);
        float big_f = spline_int(t, f0, f1, d0, d1);
        float f = spline_val(t, f0, f1, d0, d1);
        bool low = big_f - u_seg < 0.0f;
        a = low ? t : a;
        b = low ? b : t;
        t = t - (big_f - u_seg) / (fabsf(f) > 1e-20f ? f : 1.0f);
    }
    t = fminf(fmaxf(t, a), b);
    float fhat = spline_val(t, f0, f1, d0, d1);
    bool bad = !c.valid || maximum <= 0.0f;
    *x_out = bad ? 0.0f : x0 + width * t;
    *pdf_out = bad ? 0.0f : fhat / fmaxf(maximum, 1e-20f);
}

// sample_fourier's eval_Ff at phi for the luminance, its coefficients in
// registers: F (less u times the total) and f
template <int KCAP>
__device__ __forceinline__ void eval_ff_regs(const float (&a)[KCAP], int kmax, float phi, float u,
                                             float a0, float* big_f, float* f) {
    float s1, c1;
    sincosf(phi, &s1, &c1);
    float ck = 1.0f, sk = 0.0f, s = 0.0f, c = 0.0f;
#pragma unroll
    for (int k = 0; k < KCAP; ++k) {
        if (k >= kmax) break;
        if (k > 0) s = fmaf(a[k] * (1.0f / (float)k), sk, s);
        c = fmaf(a[k], ck, c);
        rotate(ck, sk, c1, s1);
    }
    *big_f = a0 * phi + s - u * a0 * kPi;
    *f = c;
}

// the same with the first `held` orders in the lane's shared-memory slice
// (stride apart) and the rest summed where they are taken (ak_at); the
// float32 sums added in double every kChunk orders
__device__ void eval_ff_slice(const float* slice, int stride, int held, const Hood& h, int kmax,
                              float phi, float u, float a0, float* big_f, float* f) {
    float s1, c1;
    sincosf(phi, &s1, &c1);
    float ck = 1.0f, sk = 0.0f, s = 0.0f, c = 0.0f;
    double s_tot = 0.0, c_tot = 0.0;
    for (int k = 0; k < kmax; ++k) {
        float a = k < held ? slice[k * stride] : ak_at(h, 0, k);
        if (k > 0) s = fmaf(a * __fdividef(1.0f, (float)k), sk, s);
        c = fmaf(a, ck, c);
        rotate(ck, sk, c1, s1);
        if (k % kChunk == kChunk - 1) {
            s_tot += s;
            c_tot += c;
            s = 0.0f;
            c = 0.0f;
        }
    }
    *big_f = a0 * phi + (float)(s_tot + s) - u * a0 * kPi;
    *f = (float)(c_tot + c);
}

// sample_fourier's Newton-bisection on the half turn, flip-mapped u;
// EVAL(phi, &F, &f) evaluates the luminance's series -> phi, f at phi
template <class Eval>
__device__ __forceinline__ void newton_phi(Eval eval, float* phi_out, float* f_out) {
    float phi = kHalfPi, lo = 0.0f, hi = kPi, big_f, fv;
    for (int it = 0; it < kNewton; ++it) {
        eval(phi, &big_f, &fv);
        bool above = big_f > 0.0f;
        hi = above ? phi : hi;
        lo = above ? lo : phi;
        phi = phi - __fdividef(big_f, fabsf(fv) > 1e-20f ? fv : 1.0f);
        phi = (phi > lo && phi < hi) ? phi : 0.5f * (lo + hi);
    }
    eval(phi, &big_f, &fv);
    *phi_out = phi;
    *f_out = fv;
}

// modes 0 (f) and 1 (pdf), the orders in chunks of KCAP
template <int MODE, int KCAP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fourier_kernel_fpdf(Tabs g, const int* __restrict__ tid, const float* __restrict__ wo_p,
                    const float* __restrict__ wi_p, const bool* __restrict__ mask, int n,
                    float* __restrict__ f_out, float* __restrict__ pdf_out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    bool on = mask == nullptr || mask[i];
    int t = __ldg(tid + i);
    const float* nodes = g.mu + (long long)t * g.N;
    rt::V3 wo = rt::load3(wo_p + 3 * i);
    rt::V3 wi = rt::load3(wi_p + 3 * i);
    float mu_i, mu_o, cos_phi;
    angles(wo, wi, &mu_i, &mu_o, &cos_phi);
    CR ci, co;
    bool ok = false;
    if (on) {
        ci = crw(nodes, g.N, mu_i);
        co = crw(nodes, g.N, mu_o);
        ok = ci.valid && co.valid;
    }
    if (MODE == 0) {
        rt::V3 f = ok ? rgb<KCAP>(g, t, hood_of(g, t, ci, co), cos_phi, mu_i, mu_o)
                      : rt::V3{0.0f, 0.0f, 0.0f};
        rt::store3(f_out + 3 * i, f);
        return;
    }
    float pdf = 0.0f;
    if (ok) {
        const float* cdf = g.cdf + (long long)t * g.N * g.N;
        float rho = 0.0f;
        for (int b = 0; b < 4; ++b) {
            int row = min(max(co.off + b, 0), g.N - 1);
            rho = rho + co.w[b] * __ldg(cdf + row * g.N + g.N - 1) * k2Pi;
        }
        float y[1];
        series<1, KCAP>(hood_of(g, t, ci, co), cos_phi, y);
        pdf = (rho > 0.0f && y[0] > 0.0f) ? y[0] / fmaxf(rho, 1e-20f) : 0.0f;
    }
    pdf_out[i] = pdf;
}

// mode 2 (sample_f): the luminance's coefficients in registers up to KCAP
// orders, or (KCAP 0) in the lane's shared-memory slice of n_slice orders
template <int KCAP>
__global__ void __launch_bounds__(KCAP > 0 ? kThreads : kSliceThreads)
fourier_kernel_sample(Tabs g, const int* __restrict__ tid, const float* __restrict__ wo_p,
                      const float* __restrict__ u_p, const bool* __restrict__ mask, int n,
                      int n_slice, float* __restrict__ f_out, float* __restrict__ pdf_out,
                      float* __restrict__ wi_out) {
    extern __shared__ float slices[];
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    bool on = mask == nullptr || mask[i];
    int t = __ldg(tid + i);
    const float* nodes = g.mu + (long long)t * g.N;
    rt::V3 wo = rt::load3(wo_p + 3 * i);
    rt::V3 wi = {0.0f, 0.0f, 0.0f}, f = {0.0f, 0.0f, 0.0f};
    float pdf = 0.0f;
    if (on) {
        float u0 = __ldg(u_p + 2 * i), u1 = __ldg(u_p + 2 * i + 1);
        float mu_o = wo.z;
        long long tab = (long long)t * g.N * g.N;
        float mu_i, pdf_mu;
        sample_2d(nodes, g.a0 + tab, g.cdf + tab, g.N, mu_o, u1, &mu_i, &pdf_mu);
        CR ci = crw(nodes, g.N, mu_i);
        CR co = crw(nodes, g.N, mu_o);
        if (ci.valid && co.valid) {
            Hood h = hood_of(g, t, ci, co);
            bool flip = u0 >= 0.5f;
            float u = flip ? 1.0f - 2.0f * (u0 - 0.5f) : 2.0f * u0;
            float phi, fv, a0;
            if constexpr (KCAP > 0) {
                float a[1][KCAP];
                int kmax = chunk<1>(h, 0, a);
                a0 = a[0][0];
                newton_phi([&](float x, float* big_f, float* fx) {
                    eval_ff_regs(a[0], kmax, x, u, a0, big_f, fx);
                }, &phi, &fv);
            } else {
                float* slice = slices + threadIdx.x;
                int stride = blockDim.x;
                int k0 = 0, kmax, held;
                a0 = 0.0f;
                do {
                    float a[1][kChunk];
                    kmax = chunk<1>(h, k0, a);
                    held = min(kmax, n_slice);
                    if (k0 == 0) a0 = a[0][0];
#pragma unroll
                    for (int k = 0; k < kChunk; ++k)
                        if (k0 + k < held) slice[(k0 + k) * stride] = a[0][k];
                    k0 += kChunk;
                } while (k0 < held);
                newton_phi([&](float x, float* big_f, float* fx) {
                    eval_ff_slice(slice, stride, held, h, kmax, x, u, a0, big_f, fx);
                }, &phi, &fv);
            }
            phi = flip ? k2Pi - phi : phi;
            float pdf_phi = a0 > 0.0f ? kInv2Pi * fv / fmaxf(a0, 1e-20f) : 0.0f;
            pdf = fmaxf(pdf_phi * pdf_mu, 0.0f);
            float sin2_i = fmaxf(1.0f - mu_i * mu_i, 0.0f);
            float sin2_o = wo.x * wo.x + wo.y * wo.y;
            float norm = sqrtf(sin2_i / fmaxf(sin2_o, 1e-20f));
            norm = (isfinite(norm) && sin2_o > 1e-20f) ? norm : 0.0f;
            float sp = sinf(phi), cp = cosf(phi);
            wi = {-(norm * (cp * wo.x - sp * wo.y)), -(norm * (sp * wo.x + cp * wo.y)), -mu_i};
            float len = fmaxf(sqrtf(wi.x * wi.x + wi.y * wi.y + wi.z * wi.z), 1e-20f);
            wi = {wi.x / len, wi.y / len, wi.z / len};
            f = rgb<(KCAP > 0 ? KCAP : kChunk)>(g, t, h, fminf(fmaxf(cp, -1.0f), 1.0f), mu_i,
                                                mu_o);
        }
    }
    rt::store3(wi_out + 3 * i, wi);
    rt::store3(f_out + 3 * i, f);
    pdf_out[i] = pdf;
}

struct Launch {
    Tabs g;
    const int* tid;
    const float *wo, *second;
    const bool* mask;
    int n;
    float *f, *pdf, *wi;
    cudaStream_t s;
};

// REGS (m_pad at most kCap): every mode with a lane's orders in registers;
// else f and pdf in chunks of kChunk orders, sample_f the slice
template <bool REGS>
cudaError_t launch_modes(int mode, const Launch& L) {
    constexpr int kOrders = REGS ? kCap : kChunk;
    if (mode == 0) {
        fourier_kernel_fpdf<0, kOrders><<<rt::blocks_for(L.n, kThreads), kThreads, 0, L.s>>>(
            L.g, L.tid, L.wo, L.second, L.mask, L.n, L.f, L.pdf);
    } else if (mode == 1) {
        fourier_kernel_fpdf<1, kOrders><<<rt::blocks_for(L.n, kThreads), kThreads, 0, L.s>>>(
            L.g, L.tid, L.wo, L.second, L.mask, L.n, L.f, L.pdf);
    } else if constexpr (REGS) {
        fourier_kernel_sample<kCap><<<rt::blocks_for(L.n, kThreads), kThreads, 0, L.s>>>(
            L.g, L.tid, L.wo, L.second, L.mask, L.n, 0, L.f, L.pdf, L.wi);
    } else {
        int n_slice = min(L.g.m_pad, kSliceMax);
        size_t bytes = sizeof(float) * kSliceThreads * n_slice;
        if (bytes > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                fourier_kernel_sample<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
            if (e != cudaSuccess) return e;
        }
        fourier_kernel_sample<0><<<rt::blocks_for(L.n, kSliceThreads), kSliceThreads, bytes, L.s>>>(
            L.g, L.tid, L.wo, L.second, L.mask, L.n, n_slice, L.f, L.pdf, L.wi);
    }
    return cudaGetLastError();
}

}  // namespace

// mode 0 f (f_out), 1 pdf (pdf_out), 2 sample_f (wi_out, f_out, pdf_out);
// ``second`` is wi (n, 3) for modes 0-1 and u (n, 2) for mode 2; ``mask``
// (n,) bool or null. A table set of m_pad at most 8 holds a lane's orders
// in registers; above, f and pdf sum chunks of 32 orders and sample_f
// takes the shared-memory slice.
extern "C" int rt_fourier_bsdf(int mode, const void* mu, const void* a_flat, const void* a_offset,
                               const void* m, const void* a0, const void* cdf, const void* eta,
                               const void* n_channels, int n_mu, int nc, int m_pad,
                               const void* tid, const void* wo, const void* second,
                               const void* mask, int n, void* f_out, void* pdf_out, void* wi_out,
                               void* stream) {
    if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
    Launch L{{(const float*)mu, (const float*)a_flat, (const int*)a_offset, (const int*)m,
              (const float*)a0, (const float*)cdf, (const float*)eta, (const int*)n_channels,
              n_mu, nc, m_pad},
             (const int*)tid, (const float*)wo, (const float*)second, (const bool*)mask, n,
             (float*)f_out, (float*)pdf_out, (float*)wi_out, (cudaStream_t)stream};
    return (int)(m_pad <= kCap ? launch_modes<true>(mode, L) : launch_modes<false>(mode, L));
}
