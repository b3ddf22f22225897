// K17: the per-texture mipmap lookups of one image.
//
// Replaces rustracer_tpu/ops/mipmap.py lookup_trilinear (:100), lookup_ewa
// (:128, 8 trilinear taps along the major axis) and lookup_ewa_exact (:167,
// a masked fixed trip of 128 texels at one level), with _texel (:62) and
// bilerp_level (:83). The plain versions are rustracer_tpu_torch/ops/
// mipmap.py trilinear_plain, ewa_plain and ewa_exact_plain; with
// -fmad=false the kernel repeats their float32 operations in their order
// (log2f, expf and sqrtf against torch's: last-bit differences, which can
// move a level's floor or round at an integer lod), but for the exact
// mode's sum over its taps, taken in another order. Each mode's set-up
// (levels, axes, ellipse) is mipmap.cuh's, shared with K20, the texel
// gradient (mipmap_bwd.cu).
//
// The image's levels are read where the scene's atlas holds them (the
// (T, 3) texels or the (T, 12) quad rows, whose first three floats are the
// texel): one copy of the images on the device. A lane walks only its own
// level(s); the reference's masked loop over every level adds zeros
// elsewhere. The exact mode stops at the bounding box's last texel (the
// reference's later taps are masked to zero weight).
//
// What bounds each mode, and what the design does about it
// (tools/texture_work.py k17_work counts a call's bytes and operations;
// tools/k17_parts.py measures the parts of the design before this one):
// - Trilinear and 8-tap, one thread a lane: 2 and 16 bilinear footprints
//   of 4 texels, mostly L1 and L2 hits shared with neighbouring lanes, so
//   issuing the loads and the address arithmetic held them, not device
//   memory. The 8-tap lookup finds its two levels once a lane (its taps
//   share the minor axis: the same levels as a tap's own). A footprint is
//   read by atlas.cuh footprint: one quad row, three 16-byte loads,
//   wherever the rows are quad rows and its four texels are the row's
//   (REPEAT, which the rows bake in, or any footprint that straddles no
//   edge of the level); else four texels, each coordinate wrapped once (a
//   mask on a power-of-two side). The wrap is a template parameter, so
//   each kernel holds one.
// - Exact, one thread a lane: the box's taps at one level (at most 128),
//   an expf each inside the ellipse. A recorded step's boxes hold about 4
//   taps (2 x 2), so the set-up (two square roots, log2f, four divides,
//   the level's row) and the per-tap wrap held it, not a long box. The
//   taps are walked in 2 x 2 blocks, a block's texels one footprint, in
//   another order than the reference's (within compare_with_plain's
//   2e-5). Splitting a lane's blocks across 2 or 4 threads, their sums
//   added by warp shuffles, was measured on such a step and ran 1.27x and
//   2.1x longer: the set-up, repeated in each thread, outweighs boxes this
//   small.
#include "mipmap.cuh"

namespace {

using rt_atlas::Level;
using rt_atlas::Tex;

constexpr int kThreads = 128;

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

// a trilinear lookup at its two levels and blend (the second level is
// not read where its weight is 0)
template <int STRIDE, int WRAP>
__device__ __forceinline__ Tex trilinear(const Args& g, Level l0, Level l1, float dl, float s,
                                         float t) {
    Tex a = rt_atlas::bilerp<STRIDE>(g.texels, l0, WRAP, s, t);
    if (dl == 0.0f) return a;
    Tex b = rt_atlas::bilerp<STRIDE>(g.texels, l1, WRAP, s, t);
    return {(1.0f - dl) * a.r + dl * b.r, (1.0f - dl) * a.g + dl * b.g,
            (1.0f - dl) * a.b + dl * b.b};
}

template <int MODE, int STRIDE, int WRAP>
__global__ void __launch_bounds__(kThreads) mipmap_kernel(Args g) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= g.n) return;
    float s = __ldg(g.st + 2 * i), t = __ldg(g.st + 2 * i + 1);
    Tex v;
    if (MODE == 0) {
        rt_mip::Tri tl = rt_mip::tri_levels(g.n_levels, __ldg(g.width + i));
        v = trilinear<STRIDE, WRAP>(g, rt_mip::level(g.meta, tl.l0),
                                    rt_mip::level(g.meta, tl.l1), tl.dl, s, t);
    } else {
        rt_mip::Axes ax = rt_mip::ewa_axes(__ldg(g.dst0 + 2 * i), __ldg(g.dst0 + 2 * i + 1),
                                           __ldg(g.dst1 + 2 * i), __ldg(g.dst1 + 2 * i + 1),
                                           g.max_aniso);
        // the taps share the minor axis, so their levels
        rt_mip::Tri tl = rt_mip::tri_levels(g.n_levels, ax.minor_len);
        Level l0 = rt_mip::level(g.meta, tl.l0), l1 = rt_mip::level(g.meta, tl.l1);
        Tex o = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            float a = rt_mip::tap_offset(k);
            Tex tap = trilinear<STRIDE, WRAP>(g, l0, l1, tl.dl, s + a * ax.ms, t + a * ax.mt);
            o = {o.r + g.w[k] * tap.r, o.g + g.w[k] * tap.g, o.b + g.w[k] * tap.b};
        }
        v = {o.r / g.wsum, o.g / g.wsum, o.b / g.wsum};
    }
    g.out[3 * i] = v.r;
    g.out[3 * i + 1] = v.g;
    g.out[3 * i + 2] = v.b;
}

// the exact mode: the box's first n_taps taps (texel (s0 + k % wu, t0 + k
// / wu) of tap k) walked in 2 x 2 blocks in row-major order, a block's
// texels one footprint
template <int STRIDE, int WRAP>
__global__ void __launch_bounds__(kThreads) mipmap_kernel_exact(Args g) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= g.n) return;
    float s = __ldg(g.st + 2 * i), t = __ldg(g.st + 2 * i + 1);
    rt_mip::Ellipse e = rt_mip::ellipse(
        g.meta, g.n_levels, g.max_aniso, s, t, __ldg(g.dst0 + 2 * i), __ldg(g.dst0 + 2 * i + 1),
        __ldg(g.dst1 + 2 * i), __ldg(g.dst1 + 2 * i + 1));
    int cols = (e.wu + 1) / 2, rows = (e.n_taps + 2 * e.wu - 1) / (2 * e.wu);
    Tex o = {0.0f, 0.0f, 0.0f};
    float wsum = 0.0f;
    for (int by = 0; by < rows; ++by) {
        for (int bx = 0; bx < cols; ++bx) {
            int x0 = 2 * bx, y0 = 2 * by;
            float wgt[4];
            bool any = false;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int x = x0 + (j & 1), y = y0 + (j >> 1);
                float du = (float)(e.s0 + x) - e.px, dv = (float)(e.t0 + y) - e.py;
                float r2 = e.A * du * du + e.B * du * dv + e.C * dv * dv;
                bool in = x < e.wu && y * e.wu + x < e.n_taps && r2 < 1.0f;
                wgt[j] = in ? expf(-2.0f * r2) - g.e2 : 0.0f;
                any = any || in;
            }
            if (!any) continue;
            Tex v[4];
            rt_atlas::footprint<STRIDE>(g.texels, e.lv, WRAP, e.s0 + x0, e.t0 + y0, v);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (wgt[j] == 0.0f) continue;
                o = {o.r + wgt[j] * v[j].r, o.g + wgt[j] * v[j].g, o.b + wgt[j] * v[j].b};
                wsum = wsum + wgt[j];
            }
        }
    }
    Tex v;
    if (!(wsum > 1e-9f)) {
        v = rt_atlas::bilerp<STRIDE>(g.texels, e.lv, WRAP, s, t);
    } else {
        float d = fmaxf(wsum, 1e-9f);
        v = {o.r / d, o.g / d, o.b / d};
    }
    g.out[3 * i] = v.r;
    g.out[3 * i + 1] = v.g;
    g.out[3 * i + 2] = v.b;
}

template <int STRIDE, int WRAP>
void launch(const Args& g, int mode, cudaStream_t s) {
    int blocks = rt::blocks_for(g.n, kThreads);
    if (mode == 0)
        mipmap_kernel<0, STRIDE, WRAP><<<blocks, kThreads, 0, s>>>(g);
    else if (mode == 1)
        mipmap_kernel<1, STRIDE, WRAP><<<blocks, kThreads, 0, s>>>(g);
    else
        mipmap_kernel_exact<STRIDE, WRAP><<<blocks, kThreads, 0, s>>>(g);
}

template <int STRIDE>
void launch_stride(const Args& g, int mode, cudaStream_t s) {
    if (g.wrap == 0)
        launch<STRIDE, 0>(g, mode, s);
    else if (g.wrap == 1)
        launch<STRIDE, 1>(g, mode, s);
    else
        launch<STRIDE, 2>(g, mode, s);
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
    if (mode < 0 || mode > 2 || wrap < 0 || wrap > 2) return (int)cudaErrorInvalidValue;
    Args g{(const float*)texels, (const int*)meta, n_levels, wrap, (const float*)st,
           (const float*)dst0, (const float*)dst1, (const float*)width, max_aniso, n,
           {w0, w1, w2, w3, w4, w5, w6, w7}, wsum, e2, (float*)out};
    auto s = (cudaStream_t)stream;
    if (stride == 12)
        launch_stride<12>(g, mode, s);
    else
        launch_stride<3>(g, mode, s);
    return (int)cudaGetLastError();
}
