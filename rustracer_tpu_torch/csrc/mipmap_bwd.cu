// K20: backward of the per-texture mipmap lookups K17, the gradient of the
// (T, 3) texel rows from the gradient of the lookups' (B, 3) output.
//
// Transposes K17 (csrc/mipmap.cu), that is the reference's
// rustracer_tpu/ops/mipmap.py lookup_trilinear (:100), lookup_ewa (:128)
// and lookup_ewa_exact (:167) differentiated by JAX's autodiff. A lookup is
// linear in the texels, so a lane recomputes K17's set-up (mipmap.cuh: the
// same levels, axes, ellipse and taps) and adds weight * g into each texel
// it read, in the forward's order:
//  - trilinear: 2 levels x 4 bilinear corners, (1 - dl) or dl times the
//    corner's weight;
//  - the 8-tap EWA: 8 taps x 2 levels x 4 corners, the tap's float32
//    weight over WSUM32 times those;
//  - the exact EWA: the taps inside the ellipse at the rounded level,
//    exp(-2 r^2) - exp(-2) over the lane's weight sum (a first pass sums
//    the weights, a second adds), or, where that sum is <= 1e-9, the
//    bilinear fallback's 4 corners at that level.
// WRAP_BLACK corners outside the level read 0 and take no gradient;
// REPEAT and CLAMP add into the texel they read. The gradient lands in the
// (T, 3) rows, which the forward reads in grad mode also where a scene's
// atlas holds the (T, 12) quad rows (a quad row's corners are the very
// texels the stride-3 addressing reaches).
//
// Bound: the adds, not the bytes. A lane reads 20-36 bytes and adds into
// 8, 64 or up to 128 texels, which neighbouring lanes share (a magnified
// lookup's corners, a coarse level's few texels); adds to one address
// serialise in L2. So a thread runs one lookup and, for each texel, the
// lanes of its warp that add into the same texel at once sum in registers
// (texel_grad.cuh add_texel, as K10) before one global atomic a channel.
// Every lane of a warp takes the same trip (the exact mode's: the warp's
// most taps); a lane past the end or without a texel adds nothing. The
// sums go in no fixed order: the result agrees with autograd of the plain
// lookups to float rounding.
#include "mipmap.cuh"
#include "texel_grad.cuh"

namespace {

using rt_atlas::Level;
using rt_atlas::texel_index;
using rt_grad::add_texel;

constexpr int kThreads = 128;

struct Args {
    const float* g_out;  // (n, 3) the lookups' gradient
    const int* meta;     // (n_levels, 3) [offset, w, h]
    int n_levels, wrap;
    const float *st, *dst0, *dst1, *width;
    float max_aniso;
    int n;
    float w[8];
    float wsum, e2;
    float* g_tex;  // (n_texels, 3), zeroed by the caller
};

// the transpose of a bilinear lookup of lv at (s, t) (atlas.cuh bilerp):
// each corner takes its weight times (gr, gg, gb); every lane of the warp
// calls it (without `emit`: nothing added)
__device__ __forceinline__ void bilerp_bwd(const Args& g, bool emit, Level lv, float ss,
                                           float tt, float gr, float gg, float gb) {
    float s = ss * (float)lv.w - 0.5f;
    float t = tt * (float)lv.h - 0.5f;
    int s0 = (int)floorf(s);
    int t0 = (int)floorf(t);
    float ds = s - (float)s0;
    float dt = t - (float)t0;
    float wc[4] = {(1.0f - ds) * (1.0f - dt), ds * (1.0f - dt), (1.0f - ds) * dt, ds * dt};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        int key = emit ? texel_index(lv, g.wrap, s0 + (c & 1), t0 + (c >> 1)) : -1;
        add_texel(g.g_tex, key, gr * wc[c], gg * wc[c], gb * wc[c]);
    }
}

// the transpose of a trilinear lookup (its two levels blended)
__device__ __forceinline__ void trilinear_bwd(const Args& g, bool emit, float s, float t,
                                              float width, float gr, float gg, float gb) {
    rt_mip::Tri tl = rt_mip::tri_levels(g.n_levels, width);
    float w0 = 1.0f - tl.dl, w1 = tl.dl;
    bilerp_bwd(g, emit, rt_mip::level(g.meta, tl.l0), s, t, gr * w0, gg * w0, gb * w0);
    bilerp_bwd(g, emit, rt_mip::level(g.meta, tl.l1), s, t, gr * w1, gg * w1, gb * w1);
}

__device__ void ewa_bwd(const Args& g, bool emit, float s, float t, float d0s, float d0t,
                        float d1s, float d1t, float gr, float gg, float gb) {
    rt_mip::Axes ax = rt_mip::ewa_axes(d0s, d0t, d1s, d1t, g.max_aniso);
    gr = gr / g.wsum;
    gg = gg / g.wsum;
    gb = gb / g.wsum;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        float a = rt_mip::tap_offset(k);
        trilinear_bwd(g, emit, s + a * ax.ms, t + a * ax.mt, ax.minor_len, gr * g.w[k],
                      gg * g.w[k], gb * g.w[k]);
    }
}

__device__ void ewa_exact_bwd(const Args& g, bool emit, float s, float t, float d0s, float d0t,
                              float d1s, float d1t, float gr, float gg, float gb) {
    rt_mip::Ellipse e =
        rt_mip::ellipse(g.meta, g.n_levels, g.max_aniso, s, t, d0s, d0t, d1s, d1t);
    if (!emit) e.n_taps = 0;
    // pass 1: the weight sum, in the forward's order
    float wsum = 0.0f;
    for (int k = 0; k < e.n_taps; ++k) {
        int ss, tt;
        float r2 = rt_mip::ellipse_tap(e, k, &ss, &tt);
        if (r2 < 1.0f) wsum = wsum + (expf(-2.0f * r2) - g.e2);
    }
    const bool taps = wsum > 1e-9f;
    float d = fmaxf(wsum, 1e-9f);
    float tr = gr / d, tg = gg / d, tb = gb / d;
    // pass 2: each tap inside takes its weight times g / wsum; the warp
    // runs its most taps
    const int trip = __reduce_max_sync(0xffffffffu, taps ? e.n_taps : 0);
    for (int k = 0; k < trip; ++k) {
        int ss = 0, tt = 0;
        float r2 = k < e.n_taps ? rt_mip::ellipse_tap(e, k, &ss, &tt) : 2.0f;
        bool in = taps && r2 < 1.0f;
        float wgt = in ? expf(-2.0f * r2) - g.e2 : 0.0f;
        add_texel(g.g_tex, in ? texel_index(e.lv, g.wrap, ss, tt) : -1, tr * wgt, tg * wgt,
                  tb * wgt);
    }
    // the bilinear fallback where no tap landed
    bilerp_bwd(g, emit && !taps, e.lv, s, t, gr, gg, gb);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) mipmap_bwd_kernel(Args g) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    // lanes past the end stay: every lane of a warp takes part in the adds
    const bool live = i < g.n;
    const int j = live ? i : 0;
    float s = 0.0f, t = 0.0f, gr = 0.0f, gg = 0.0f, gb = 0.0f;
    if (live) {
        s = __ldg(g.st + 2 * j);
        t = __ldg(g.st + 2 * j + 1);
        gr = __ldg(g.g_out + 3 * j);
        gg = __ldg(g.g_out + 3 * j + 1);
        gb = __ldg(g.g_out + 3 * j + 2);
    }
    if (MODE == 0) {
        trilinear_bwd(g, live, s, t, live ? __ldg(g.width + j) : 1.0f, gr, gg, gb);
        return;
    }
    float d0s = 0.0f, d0t = 0.0f, d1s = 0.0f, d1t = 0.0f;
    if (live) {
        d0s = __ldg(g.dst0 + 2 * j);
        d0t = __ldg(g.dst0 + 2 * j + 1);
        d1s = __ldg(g.dst1 + 2 * j);
        d1t = __ldg(g.dst1 + 2 * j + 1);
    }
    if (MODE == 1)
        ewa_bwd(g, live, s, t, d0s, d0t, d1s, d1t, gr, gg, gb);
    else
        ewa_exact_bwd(g, live, s, t, d0s, d0t, d1s, d1t, gr, gg, gb);
}

}  // namespace

// K17's arguments with the lookups' gradient g_out (n, 3) in place of its
// output, and g_tex, the (n_texels, 3) texel gradient, zeroed by the
// caller and added into
extern "C" int rt_mipmap_lookup_bwd(const void* g_out, const void* meta, int n_levels, int wrap,
                                    int mode, const void* st, const void* dst0, const void* dst1,
                                    const void* width, float max_aniso, int n, float w0, float w1,
                                    float w2, float w3, float w4, float w5, float w6, float w7,
                                    float wsum, float e2, void* g_tex, int n_texels,
                                    void* stream) {
    if (n_texels <= 0) return (int)cudaErrorInvalidValue;
    Args g{(const float*)g_out, (const int*)meta, n_levels, wrap, (const float*)st,
           (const float*)dst0, (const float*)dst1, (const float*)width, max_aniso, n,
           {w0, w1, w2, w3, w4, w5, w6, w7}, wsum, e2, (float*)g_tex};
    auto s = (cudaStream_t)stream;
    int blocks = rt::blocks_for(n, kThreads);
    if (mode == 0)
        mipmap_bwd_kernel<0><<<blocks, kThreads, 0, s>>>(g);
    else if (mode == 1)
        mipmap_bwd_kernel<1><<<blocks, kThreads, 0, s>>>(g);
    else if (mode == 2)
        mipmap_bwd_kernel<2><<<blocks, kThreads, 0, s>>>(g);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
