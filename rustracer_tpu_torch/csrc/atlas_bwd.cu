// K10: backward of the atlas EWA lookup K5, the gradient of the (T, 3)
// atlas texels from the gradient of the lookups' (B, 3) output.
//
// Transposes K5 (csrc/atlas.cu; the reference's atlas_lookup_ewa,
// rustracer_tpu/scene/atlas.py:174-230, differentiated by JAX's
// autodiff). A lookup is linear in the texels: out = sum over 8 taps, 2
// levels and 4 bilinear corners of wk * lw * wc * texel / wsum * scale. One
// thread a lane recomputes K5's set-up (atlas.cuh set_up: the level, the
// taps' st, the blend) and scatter-adds weight * g into each corner's
// texel. Both texel layouts take their gradient in the (T, 3) array: a
// quad row (T, 12) is four REPEAT-wrapped neighbours of the (T, 3) array
// (scene/atlas.py atlas_quad_index), so for `quad` every corner is
// addressed with REPEAT wrapping. WRAP_BLACK corners outside the level
// read 0 and take no gradient.
//
// Coarse levels draw many lanes onto a few texels (level 7 of the hero's
// pyramid is one texel), so the adds are aggregated within a warp before
// the atomics: the lanes of a warp that add into the same texel find each
// other (__match_any_sync), sum their values in a tree of shuffles, and
// the first of them issues one atomicAdd a channel. The sums are taken in
// no fixed order: the result agrees with autograd of the plain lookup to
// float rounding.
//
// Bound: bytes on the lanes' inputs (reg, uv, differentials and the
// output gradient) and the texel gradient written once; on the card the
// atomics' read-modify-write traffic stays in L2.
#include "atlas.cuh"

namespace {

using namespace rt_atlas;

constexpr int kThreads = 256;

struct Args {
    const float* __restrict__ g_out;
    int quad;
    const int* __restrict__ meta;
    int lmax;
    const int* __restrict__ levels;
    const int* __restrict__ reg_img;
    const float* __restrict__ reg_map;
    const float* __restrict__ reg_scale;
    const int* __restrict__ reg_wrap;
    const int* __restrict__ reg;
    const float* __restrict__ uv;
    const float* __restrict__ dudx;
    const float* __restrict__ dvdx;
    const float* __restrict__ dudy;
    const float* __restrict__ dvdy;
    int n;
    Taps taps;
    float wsum;
    float* __restrict__ g_tex;
};

// adds (r, g, b) into texel `key` of g_tex (key < 0: nothing), summed first
// over the warp's lanes with the same key; every lane of the warp calls it
__device__ __forceinline__ void add_aggregated(float* g_tex, int key, float r, float g, float b) {
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int first = __ffs(peers) - 1;
    unsigned rel = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
    unsigned higher = peers & ~((2u << lane) - 1u);      // peers above it
    // tree sum: each round a lane adds its next remaining peer's partial sum,
    // then the lanes at odd positions drop out; the first lane ends with all
    while (__any_sync(0xffffffffu, higher)) {
        int next = __ffs(higher);
        float tr = __shfl_sync(0xffffffffu, r, (next - 1) & 31);
        float tg = __shfl_sync(0xffffffffu, g, (next - 1) & 31);
        float tb = __shfl_sync(0xffffffffu, b, (next - 1) & 31);
        if (next) {
            r += tr;
            g += tg;
            b += tb;
        }
        higher &= ~__ballot_sync(0xffffffffu, rel & 1u);
        rel >>= 1;
    }
    if (lane == first && key >= 0) {
        float* p = g_tex + 3 * (long long)key;
        atomicAdd(p, r);
        atomicAdd(p + 1, g);
        atomicAdd(p + 2, b);
    }
}

__global__ void __launch_bounds__(kThreads) atlas_ewa_bwd_kernel(Args g) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    // every lane runs the loops below (the warp's adds meet in
    // add_aggregated); a lane without a lookup adds to no texel
    const bool live = i < g.n && __ldg(g.reg + i) >= 0;
    // a warp without a lookup has nothing to add (interior bounces leave
    // most warps so)
    if (!__any_sync(0xffffffffu, live)) return;
    Lookup L = {};
    float gr = 0.0f, gg = 0.0f, gb = 0.0f;
    if (live) {
        L = set_up(g, i);
        if (g.quad) L.wrap = 0;  // quad rows wrap REPEAT
        float sc = __ldg(g.reg_scale + L.r);
        gr = g.g_out[3 * i] / g.wsum * sc;
        gg = g.g_out[3 * i + 1] / g.wsum * sc;
        gb = g.g_out[3 * i + 2] / g.wsum * sc;
    }
    for (int k = 0; k < kTaps; ++k) {
        float a = ((float)k + 0.5f) / 8.0f - 0.5f;
        float wk = g.taps.w[k];
        float sk = L.st_s + a * L.ms;
        float tk = L.st_t + a * L.mt;
        for (int l = 0; l < 2; ++l) {
            Level lv = l ? L.lv1 : L.lv0;
            float lw = l ? L.dl : 1.0f - L.dl;
            float s = sk * (float)lv.w - 0.5f;
            float t = tk * (float)lv.h - 0.5f;
            int s0 = live ? (int)floorf(s) : 0;
            int t0 = live ? (int)floorf(t) : 0;
            float ds = s - (float)s0;
            float dt = t - (float)t0;
            for (int c = 0; c < 4; ++c) {
                int s_i = s0 + (c & 1), t_i = t0 + (c >> 1);
                float wc = ((c & 1) ? ds : 1.0f - ds) * ((c >> 1) ? dt : 1.0f - dt);
                int key = -1;
                if (live) {
                    bool inside = s_i >= 0 && s_i < lv.w && t_i >= 0 && t_i < lv.h;
                    int s_f, t_f;
                    if (L.wrap == 0) {  // WRAP_REPEAT
                        s_f = floor_mod(s_i, lv.w);
                        t_f = floor_mod(t_i, lv.h);
                    } else {
                        s_f = min(max(s_i, 0), lv.w - 1);
                        t_f = min(max(t_i, 0), lv.h - 1);
                    }
                    if (L.wrap != 1 || inside) key = lv.off + t_f * lv.w + s_f;
                }
                float f = wk * lw * wc;
                add_aggregated(g.g_tex, key, f * gr, f * gg, f * gb);
            }
        }
    }
}

}  // namespace

// g_tex: the (n_texels, 3) texel gradient, zeroed by the caller, added into.
extern "C" int rt_atlas_lookup_ewa_bwd(const void* g_out, int quad, const void* meta, int lmax,
                                       const void* levels, const void* reg_img,
                                       const void* reg_map, const void* reg_scale,
                                       const void* reg_wrap, const void* reg, const void* uv,
                                       const void* dudx, const void* dvdx, const void* dudy,
                                       const void* dvdy, int n, float w0, float w1, float w2,
                                       float w3, float w4, float w5, float w6, float w7,
                                       float wsum, void* g_tex, int n_texels, void* stream) {
    if (n_texels <= 0) return (int)cudaErrorInvalidValue;
    Args g = {(const float*)g_out, quad, (const int*)meta, lmax, (const int*)levels,
              (const int*)reg_img, (const float*)reg_map, (const float*)reg_scale,
              (const int*)reg_wrap, (const int*)reg, (const float*)uv, (const float*)dudx,
              (const float*)dvdx, (const float*)dudy, (const float*)dvdy, n,
              {{w0, w1, w2, w3, w4, w5, w6, w7}}, wsum, (float*)g_tex};
    atlas_ewa_bwd_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}
