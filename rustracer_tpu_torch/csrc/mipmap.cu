// K17: the per-texture mipmap lookups of one image, one thread a lane.
//
// Replaces rustracer_tpu/ops/mipmap.py lookup_trilinear (:100), lookup_ewa
// (:128, 8 trilinear taps along the major axis) and lookup_ewa_exact (:167,
// a masked fixed trip of 128 texels at one level), with _texel (:62) and
// bilerp_level (:83). The plain versions are rustracer_tpu_torch/ops/
// mipmap.py trilinear_plain, ewa_plain and ewa_exact_plain; with
// -fmad=false the kernel repeats their float32 operations in their order
// (log2f, expf and sqrtf against torch's: last-bit differences, which can
// move a level's floor or round at an integer lod).
//
// The image's levels are read where the scene's atlas holds them (the
// (T, 3) texels or the (T, 12) quad rows, whose first three floats are the
// texel), through atlas.cuh's texel_at and bilerp with their wrap modes:
// one copy of the images on the device. A lane walks only its own
// level(s); the reference's masked loop over every level adds zeros
// elsewhere. The exact mode stops at the bounding box's last texel (the
// reference's later taps are masked to zero weight).
//
// Bound: bytes at the trilinear and 8-tap modes' texel reads (8 and 64
// texel reads a lane, mostly L1/L2 hits on neighbouring lanes) against a
// few hundred operations; the exact mode does up to 128 exp evaluations a
// lane. tools/texture_work.py k17_work counts both on a call's data.
#include "atlas.cuh"

namespace {

using rt_atlas::Level;
using rt_atlas::Tex;

struct Args {
    const float* texels;
    const int* meta;  // (n_levels, 3) [offset, w, h]
    int n_levels, wrap;
    const float *st, *dst0, *dst1, *width;
    float max_aniso;
    int n;
    float w[8];
    float wsum, e2;
    float* out;
};

__device__ __forceinline__ Level level(const Args& g, int li) {
    const int* m = g.meta + 3 * li;
    return {__ldg(m), __ldg(m + 1), __ldg(m + 2)};
}

// bilerp_level at one level; the quad rows bake REPEAT, so other wraps
// read the quad rows' single texels
template <int STRIDE>
__device__ __forceinline__ Tex bil(const Args& g, Level lv, float s, float t) {
    if (STRIDE == 12 && g.wrap == 0) return rt_atlas::bilerp<true>(g.texels, lv, 0, s, t);
    return rt_atlas::bilerp<false, STRIDE>(g.texels, lv, g.wrap, s, t);
}

template <int STRIDE>
__device__ __forceinline__ Tex trilinear(const Args& g, float s, float t, float width) {
    float top = (float)(g.n_levels - 1);
    float lev = fminf(fmaxf(top + log2f(fmaxf(width, 1e-8f)), 0.0f), top);
    int l0 = (int)floorf(lev);
    int l1 = min(l0 + 1, g.n_levels - 1);
    float dl = lev - (float)l0;
    Tex a = bil<STRIDE>(g, level(g, l0), s, t);
    Tex b = bil<STRIDE>(g, level(g, l1), s, t);
    return {(1.0f - dl) * a.r + dl * b.r, (1.0f - dl) * a.g + dl * b.g,
            (1.0f - dl) * a.b + dl * b.b};
}

template <int STRIDE>
__device__ Tex ewa(const Args& g, float s, float t, float d0s, float d0t, float d1s, float d1t) {
    float len0 = sqrtf(fmaxf(d0s * d0s + d0t * d0t, 1e-24f));
    float len1 = sqrtf(fmaxf(d1s * d1s + d1t * d1t, 1e-24f));
    bool major_is_0 = len0 >= len1;
    float major_len = major_is_0 ? len0 : len1;
    float minor_len = major_is_0 ? len1 : len0;
    float ms = major_is_0 ? d0s : d1s, mt = major_is_0 ? d0t : d1t;
    minor_len = fmaxf(minor_len, major_len / g.max_aniso);
    Tex o = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        float a = ((float)k + 0.5f) / 8.0f - 0.5f;
        Tex v = trilinear<STRIDE>(g, s + a * ms, t + a * mt, minor_len);
        o = {o.r + g.w[k] * v.r, o.g + g.w[k] * v.g, o.b + g.w[k] * v.b};
    }
    return {o.r / g.wsum, o.g / g.wsum, o.b / g.wsum};
}

template <int STRIDE>
__device__ Tex ewa_exact(const Args& g, float s, float t, float d0s, float d0t, float d1s,
                         float d1t) {
    float len0 = sqrtf(fmaxf(d0s * d0s + d0t * d0t, 1e-24f));
    float len1 = sqrtf(fmaxf(d1s * d1s + d1t * d1t, 1e-24f));
    bool swap = len1 > len0;
    float mjs = swap ? d1s : d0s, mjt = swap ? d1t : d0t;
    float mns = swap ? d0s : d1s, mnt = swap ? d0t : d1t;
    float major_len = fmaxf(len0, len1);
    float minor_len = fminf(len0, len1);
    float scale = minor_len * g.max_aniso < major_len
                      ? major_len / (minor_len * g.max_aniso + 1e-24f)
                      : 1.0f;
    mns = mns * scale;
    mnt = mnt * scale;
    minor_len = minor_len * scale;
    float top = (float)(g.n_levels - 1);
    float lod = fminf(fmaxf(top + log2f(fmaxf(minor_len, 1e-8f)), 0.0f), top);
    Level lv = level(g, (int)rintf(lod));
    float wf = (float)lv.w, hf = (float)lv.h;
    float d0x = mjs * wf, d0y = mjt * hf, d1x = mns * wf, d1y = mnt * hf;
    float px = s * wf - 0.5f, py = t * hf - 0.5f;
    float A = d0y * d0y + d1y * d1y + 1.0f;
    float Bc = -2.0f * (d0x * d0y + d1x * d1y);
    float Cc = d0x * d0x + d1x * d1x + 1.0f;
    float inv_f = 1.0f / fmaxf(A * Cc - Bc * Bc * 0.25f, 1e-12f);
    A = A * inv_f;
    Bc = Bc * inv_f;
    Cc = Cc * inv_f;
    float det = fmaxf(-Bc * Bc + 4.0f * A * Cc, 1e-12f);
    float u_r = sqrtf(fmaxf(Cc * det, 0.0f)) * 2.0f / det;
    float v_r = sqrtf(fmaxf(A * det, 0.0f)) * 2.0f / det;
    int s0 = (int)ceilf(px - u_r), s1 = (int)floorf(px + u_r);
    int t0 = (int)ceilf(py - v_r), t1 = (int)floorf(py + v_r);
    int wu = max(s1 - s0 + 1, 1), wv = max(t1 - t0 + 1, 1);
    long long n_box = (long long)wu * (long long)wv;
    int n_taps = n_box < 128 ? (int)n_box : 128;
    Tex o = {0.0f, 0.0f, 0.0f};
    float wsum = 0.0f;
    for (int k = 0; k < n_taps; ++k) {
        int ss = s0 + k % wu, tt = t0 + k / wu;
        float du = (float)ss - px, dv = (float)tt - py;
        float r2 = A * du * du + Bc * du * dv + Cc * dv * dv;
        if (!(r2 < 1.0f)) continue;
        float wgt = expf(-2.0f * r2) - g.e2;
        Tex v = rt_atlas::texel_at<STRIDE>(g.texels, lv, g.wrap, ss, tt);
        o = {o.r + wgt * v.r, o.g + wgt * v.g, o.b + wgt * v.b};
        wsum = wsum + wgt;
    }
    if (!(wsum > 1e-9f)) return bil<STRIDE>(g, lv, s, t);
    float d = fmaxf(wsum, 1e-9f);
    return {o.r / d, o.g / d, o.b / d};
}

template <int MODE, int STRIDE>
__global__ void __launch_bounds__(128) mipmap_kernel(Args g) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= g.n) return;
    float s = __ldg(g.st + 2 * i), t = __ldg(g.st + 2 * i + 1);
    Tex v;
    if (MODE == 0) {
        v = trilinear<STRIDE>(g, s, t, __ldg(g.width + i));
    } else {
        float d0s = __ldg(g.dst0 + 2 * i), d0t = __ldg(g.dst0 + 2 * i + 1);
        float d1s = __ldg(g.dst1 + 2 * i), d1t = __ldg(g.dst1 + 2 * i + 1);
        v = MODE == 1 ? ewa<STRIDE>(g, s, t, d0s, d0t, d1s, d1t)
                      : ewa_exact<STRIDE>(g, s, t, d0s, d0t, d1s, d1t);
    }
    g.out[3 * i] = v.r;
    g.out[3 * i + 1] = v.g;
    g.out[3 * i + 2] = v.b;
}

template <int MODE>
void launch_mode(const Args& g, int stride, cudaStream_t s) {
    constexpr int kThreads = 128;
    int blocks = rt::blocks_for(g.n, kThreads);
    if (stride == 12)
        mipmap_kernel<MODE, 12><<<blocks, kThreads, 0, s>>>(g);
    else
        mipmap_kernel<MODE, 3><<<blocks, kThreads, 0, s>>>(g);
}

}  // namespace

// mode 0 trilinear (width), 1 the 8-tap EWA, 2 the exact EWA (dst0, dst1);
// w0..w7 and wsum the 8-tap weights, e2 exp(-2), both rounded to float32
extern "C" int rt_mipmap_lookup(const void* texels, int stride, const void* meta,
                                int n_levels, int wrap, int mode, const void* st,
                                const void* dst0, const void* dst1, const void* width,
                                float max_aniso, int n, float w0, float w1, float w2, float w3,
                                float w4, float w5, float w6, float w7, float wsum, float e2,
                                void* out, void* stream) {
    if (stride != 3 && stride != 12) return (int)cudaErrorInvalidValue;
    Args g{(const float*)texels, (const int*)meta, n_levels, wrap, (const float*)st,
           (const float*)dst0, (const float*)dst1, (const float*)width, max_aniso, n,
           {w0, w1, w2, w3, w4, w5, w6, w7}, wsum, e2, (float*)out};
    auto s = (cudaStream_t)stream;
    if (mode == 0)
        launch_mode<0>(g, stride, s);
    else if (mode == 1)
        launch_mode<1>(g, stride, s);
    else if (mode == 2)
        launch_mode<2>(g, stride, s);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
