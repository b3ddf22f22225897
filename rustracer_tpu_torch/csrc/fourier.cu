// K19: the Fourier BSDF's f, pdf and sample_f, one thread a lane.
//
// Replaces rustracer_tpu/ops/fourier.py fourier_f (:274), fourier_pdf
// (:322) and fourier_sample_f (:342), with _gather_ak (:209), _crw_rows
// (:286) and rustracer_tpu/core/interpolation.py fourier (:197),
// sample_fourier (:208) and sample_catmull_rom_2d (:248). The plain
// versions are rustracer_tpu_torch/ops/fourier.py f_plain, pdf_plain and
// sample_f_plain.
//
// A lane walks its 4 x 4 Catmull-Rom neighbours' coefficient runs and sums
// the series on the fly: the coefficient a_k of a channel is the
// neighbours' weighted sum in the reference's order (so it is bit for bit
// the reference's), then the series sums a_k cos(k phi) over k. No (B, 3,
// m_pad) array is formed. The Newton-bisection loops keep the reference's
// fixed trip counts (30 steps; ceil(log2 N) + 1 bisection steps).
// Differences against the plain version: the order of the sum over k,
// acosf, sinf and cosf against torch's, IEEE divides.
//
// Bound: operations. A lane reads a few hundred bytes of tables (the
// neighbours' runs, cached across lanes) and evaluates m_pad cosines a
// channel, sample_f 30 Newton steps of 2 m_pad sines and cosines each.
// tools/texture_work.py k19_work counts both on a call's data.
#include "common.cuh"

namespace {

constexpr int kNewton = 30;
constexpr float kPi = 3.14159274101257324f;       // float32(pi)
constexpr float k2Pi = 6.28318548202514648f;      // float32(2 pi)
constexpr float kHalfPi = 1.57079637050628662f;   // float32(pi / 2)
constexpr float kInv2Pi = 0.159154936671257019f;  // float32(1 / (2 pi))
constexpr float kThird = 0.333333343267440796f;   // float32(1 / 3)

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
    int cnt = 0;
    for (int j = 0; j < N; ++j) cnt += __ldg(nodes + j) <= x;
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

// the 16 neighbours' runs of one lane (_gather_ak's pairs, b outer)
struct Runs {
    const float* a;  // the table's flat coefficients
    int NC;
    int off[16], m[16];
    float w[16];
    int kmax;
};

__device__ void runs_of(const Tabs& g, int t, const CR& ci, const CR& co, Runs* r) {
    r->a = g.a_flat + (long long)t * g.NC;
    r->NC = g.NC;
    r->kmax = 0;
    const int* ao = g.a_offset + (long long)t * g.N * g.N;
    const int* mm = g.m + (long long)t * g.N * g.N;
    for (int b = 0; b < 4; ++b) {
        int row = min(max(co.off + b, 0), g.N - 1);
        for (int a = 0; a < 4; ++a) {
            int col = min(max(ci.off + a, 0), g.N - 1);
            int j = 4 * b + a;
            int pair = row * g.N + col;
            r->w[j] = ci.w[a] * co.w[b];
            r->off[j] = __ldg(ao + pair);
            r->m[j] = __ldg(mm + pair);
            if (r->w[j] != 0.0f) r->kmax = max(r->kmax, r->m[j]);
        }
    }
    r->kmax = min(r->kmax, g.m_pad);
}

// a_k of channel c: the neighbours' weighted terms added in order
__device__ __forceinline__ float ak(const Runs& r, int c, int k) {
    float s = 0.0f;
    for (int j = 0; j < 16; ++j) {
        if (k < r.m[j] && r.w[j] != 0.0f) {
            int idx = min(max(r.off[j] + c * r.m[j] + k, 0), r.NC - 1);
            s = s + r.w[j] * __ldg(r.a + idx);
        }
    }
    return s;
}

// fourier(): sum_k a_k cos(k phi), phi = acos(cos_phi)
__device__ float series(const Runs& r, int c, float cos_phi) {
    float phi = acosf(fminf(fmaxf(cos_phi, -1.0f), 1.0f));
    float s = 0.0f;
    for (int k = 0; k < r.kmax; ++k) s = s + ak(r, c, k) * cosf(phi * (float)k);
    return s;
}

// _rgb_from_ak
__device__ rt::V3 rgb(const Tabs& g, int t, const Runs& r, float cos_phi, float mu_i, float mu_o) {
    float y = fmaxf(series(r, 0, cos_phi), 0.0f);
    float scale = fabsf(mu_i) > 1e-20f ? 1.0f / fabsf(mu_i) : 0.0f;
    float eta = __ldg(g.eta + t);
    float e = mu_i > 0.0f ? 1.0f / eta : eta;
    scale = scale * (mu_i * mu_o > 0.0f ? e * e : 1.0f);
    if (__ldg(g.n_channels + t) == 1) return {y * scale, y * scale, y * scale};
    float rr = series(r, 1, cos_phi);
    float bb = series(r, 2, cos_phi);
    float gg = 1.39829f * y - 0.100913f * bb - 0.297375f * rr;
    return {fmaxf(rr, 0.0f) * scale, fmaxf(gg, 0.0f) * scale, fmaxf(bb, 0.0f) * scale};
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

// sample_fourier's eval_Ff at phi for the luminance
__device__ void eval_ff(const Runs& r, float phi, float u, float a0, float* big_f, float* f) {
    float s = 0.0f, c = 0.0f;
    for (int k = 0; k < r.kmax; ++k) {
        float a = ak(r, 0, k);
        float kphi = phi * (float)k;
        float k_recip = k > 0 ? 1.0f / (float)k : 0.0f;
        s = s + a * k_recip * sinf(kphi);
        c = c + a * cosf(kphi);
    }
    *big_f = a0 * phi + s - u * a0 * kPi;
    *f = c;
}

__global__ void __launch_bounds__(128)
fourier_kernel(int mode, Tabs g, const int* __restrict__ tid, const float* __restrict__ wo_p,
               const float* __restrict__ second, const bool* __restrict__ mask, int n,
               float* __restrict__ f_out, float* __restrict__ pdf_out, float* __restrict__ wi_out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    bool on = mask == nullptr || mask[i];
    int t = __ldg(tid + i);
    const float* nodes = g.mu + (long long)t * g.N;
    rt::V3 wo = rt::load3(wo_p + 3 * i);
    if (mode != 2) {
        rt::V3 wi = rt::load3(second + 3 * i);
        float mu_i, mu_o, cos_phi;
        angles(wo, wi, &mu_i, &mu_o, &cos_phi);
        CR ci, co;
        bool ok = false;
        if (on) {
            ci = crw(nodes, g.N, mu_i);
            co = crw(nodes, g.N, mu_o);
            ok = ci.valid && co.valid;
        }
        Runs r;
        if (ok) runs_of(g, t, ci, co, &r);
        if (mode == 0) {
            rt::V3 f = ok ? rgb(g, t, r, cos_phi, mu_i, mu_o) : rt::V3{0.0f, 0.0f, 0.0f};
            rt::store3(f_out + 3 * i, f);
        } else {
            float pdf = 0.0f;
            if (ok) {
                const float* cdf = g.cdf + (long long)t * g.N * g.N;
                float rho = 0.0f;
                for (int b = 0; b < 4; ++b) {
                    int row = min(max(co.off + b, 0), g.N - 1);
                    rho = rho + co.w[b] * __ldg(cdf + row * g.N + g.N - 1) * k2Pi;
                }
                float y = series(r, 0, cos_phi);
                pdf = (rho > 0.0f && y > 0.0f) ? y / fmaxf(rho, 1e-20f) : 0.0f;
            }
            pdf_out[i] = pdf;
        }
        return;
    }
    rt::V3 wi = {0.0f, 0.0f, 0.0f}, f = {0.0f, 0.0f, 0.0f};
    float pdf = 0.0f;
    if (on) {
        float u0 = __ldg(second + 2 * i), u1 = __ldg(second + 2 * i + 1);
        float mu_o = wo.z;
        long long tab = (long long)t * g.N * g.N;
        float mu_i, pdf_mu;
        sample_2d(nodes, g.a0 + tab, g.cdf + tab, g.N, mu_o, u1, &mu_i, &pdf_mu);
        CR ci = crw(nodes, g.N, mu_i);
        CR co = crw(nodes, g.N, mu_o);
        if (ci.valid && co.valid) {
            Runs r;
            runs_of(g, t, ci, co, &r);
            // sample_fourier on the luminance
            bool flip = u0 >= 0.5f;
            float u = flip ? 1.0f - 2.0f * (u0 - 0.5f) : 2.0f * u0;
            float a0 = ak(r, 0, 0);
            float phi = kHalfPi, lo = 0.0f, hi = kPi, big_f, fv;
            for (int it = 0; it < kNewton; ++it) {
                eval_ff(r, phi, u, a0, &big_f, &fv);
                bool above = big_f > 0.0f;
                hi = above ? phi : hi;
                lo = above ? lo : phi;
                phi = phi - big_f / (fabsf(fv) > 1e-20f ? fv : 1.0f);
                phi = (phi > lo && phi < hi) ? phi : 0.5f * (lo + hi);
            }
            eval_ff(r, phi, u, a0, &big_f, &fv);
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
            f = rgb(g, t, r, fminf(fmaxf(cp, -1.0f), 1.0f), mu_i, mu_o);
        }
    }
    rt::store3(wi_out + 3 * i, wi);
    rt::store3(f_out + 3 * i, f);
    pdf_out[i] = pdf;
}

}  // namespace

// mode 0 f (f_out), 1 pdf (pdf_out), 2 sample_f (wi_out, f_out, pdf_out);
// ``second`` is wi (n, 3) for modes 0-1 and u (n, 2) for mode 2; ``mask``
// (n,) bool or null
extern "C" int rt_fourier_bsdf(int mode, const void* mu, const void* a_flat, const void* a_offset,
                               const void* m, const void* a0, const void* cdf, const void* eta,
                               const void* n_channels, int n_mu, int nc, int m_pad,
                               const void* tid, const void* wo, const void* second,
                               const void* mask, int n, void* f_out, void* pdf_out, void* wi_out,
                               void* stream) {
    if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
    Tabs g{(const float*)mu, (const float*)a_flat, (const int*)a_offset, (const int*)m,
           (const float*)a0, (const float*)cdf, (const float*)eta, (const int*)n_channels,
           n_mu, nc, m_pad};
    constexpr int kThreads = 128;
    fourier_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        mode, g, (const int*)tid, (const float*)wo, (const float*)second, (const bool*)mask, n,
        (float*)f_out, (float*)pdf_out, (float*)wi_out);
    return (int)cudaGetLastError();
}
