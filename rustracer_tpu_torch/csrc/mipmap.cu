// K17: the per-texture mipmap lookups of one image, one thread a lane.
//
// Replaces rustracer_tpu/ops/mipmap.py lookup_trilinear (:100), lookup_ewa
// (:128, 8 trilinear taps along the major axis) and lookup_ewa_exact (:167,
// a masked fixed trip of 128 texels at one level), with _texel (:62) and
// bilerp_level (:83). The plain versions are rustracer_tpu_torch/ops/
// mipmap.py trilinear_plain, ewa_plain and ewa_exact_plain; with
// -fmad=false the kernel repeats their float32 operations in their order
// (log2f, expf and sqrtf against torch's: last-bit differences, which can
// move a level's floor or round at an integer lod). Each mode's set-up
// (levels, axes, ellipse) is mipmap.cuh's, shared with K20, the texel
// gradient (mipmap_bwd.cu).
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
#include "mipmap.cuh"

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

// bilerp_level at one level; the quad rows bake REPEAT, so other wraps
// read the quad rows' single texels
template <int STRIDE>
__device__ __forceinline__ Tex bil(const Args& g, Level lv, float s, float t) {
    if (STRIDE == 12 && g.wrap == 0) return rt_atlas::bilerp<true>(g.texels, lv, 0, s, t);
    return rt_atlas::bilerp<false, STRIDE>(g.texels, lv, g.wrap, s, t);
}

template <int STRIDE>
__device__ __forceinline__ Tex trilinear(const Args& g, float s, float t, float width) {
    rt_mip::Tri tl = rt_mip::tri_levels(g.n_levels, width);
    float dl = tl.dl;
    Tex a = bil<STRIDE>(g, rt_mip::level(g.meta, tl.l0), s, t);
    Tex b = bil<STRIDE>(g, rt_mip::level(g.meta, tl.l1), s, t);
    return {(1.0f - dl) * a.r + dl * b.r, (1.0f - dl) * a.g + dl * b.g,
            (1.0f - dl) * a.b + dl * b.b};
}

template <int STRIDE>
__device__ Tex ewa(const Args& g, float s, float t, float d0s, float d0t, float d1s, float d1t) {
    rt_mip::Axes ax = rt_mip::ewa_axes(d0s, d0t, d1s, d1t, g.max_aniso);
    Tex o = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        float a = rt_mip::tap_offset(k);
        Tex v = trilinear<STRIDE>(g, s + a * ax.ms, t + a * ax.mt, ax.minor_len);
        o = {o.r + g.w[k] * v.r, o.g + g.w[k] * v.g, o.b + g.w[k] * v.b};
    }
    return {o.r / g.wsum, o.g / g.wsum, o.b / g.wsum};
}

template <int STRIDE>
__device__ Tex ewa_exact(const Args& g, float s, float t, float d0s, float d0t, float d1s,
                         float d1t) {
    rt_mip::Ellipse e =
        rt_mip::ellipse(g.meta, g.n_levels, g.max_aniso, s, t, d0s, d0t, d1s, d1t);
    Tex o = {0.0f, 0.0f, 0.0f};
    float wsum = 0.0f;
    for (int k = 0; k < e.n_taps; ++k) {
        int ss, tt;
        float r2 = rt_mip::ellipse_tap(e, k, &ss, &tt);
        if (!(r2 < 1.0f)) continue;
        float wgt = expf(-2.0f * r2) - g.e2;
        Tex v = rt_atlas::texel_at<STRIDE>(g.texels, e.lv, g.wrap, ss, tt);
        o = {o.r + wgt * v.r, o.g + wgt * v.g, o.b + wgt * v.b};
        wsum = wsum + wgt;
    }
    if (!(wsum > 1e-9f)) return bil<STRIDE>(g, e.lv, s, t);
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
