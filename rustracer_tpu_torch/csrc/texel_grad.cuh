// Device code shared by the texel-gradient kernels K10 (atlas_bwd.cu) and
// K20 (mipmap_bwd.cu): a warp's adds into one (T, 3) gradient array, summed
// in registers by texel before any global atomic, and the transposes of a
// bilinear footprint and of the 8-tap EWA lookup's taps that feed them.
#pragma once

#include "atlas.cuh"

namespace rt_grad {

using rt_atlas::Level;
using rt_atlas::texel_index;

// adds (r, g, b) into texel `key` of g_tex (key < 0: nothing); every lane
// of the warp calls it. The lanes with the same key find each other
// (__match_any_sync) and sum their values in a tree of shuffles; the first
// of them adds the sum with one atomic a channel (an add of exactly 0 is
// left out: it would change no bit, the gradient starts at +0)
__device__ __forceinline__ void add_texel(float* g_tex, int key, float r, float g, float b) {
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    unsigned rel = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
    // peers above it; lanes without a texel sum nothing
    unsigned higher = key < 0 ? 0u : peers & ~((2u << lane) - 1u);
    // each round a lane adds its next remaining peer's partial sum, then
    // the lanes at odd positions drop out; the first lane ends with all
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
    if (lane != __ffs(peers) - 1 || key < 0) return;
    float* p = g_tex + 3 * (long long)key;
    if (r != 0.0f) atomicAdd(p, r);
    if (g != 0.0f) atomicAdd(p + 1, g);
    if (b != 0.0f) atomicAdd(p + 2, b);
}

// with `emit`, the 2x2 quad at (s0, t0) of level lv with corner weights
// w: each corner's texel (wrapped as the lookup wraps; -1 outside a
// WRAP_BLACK level) takes w[c] * (gr, gg, gb); every lane of the warp
// calls it, with or without `emit` (a warp where no lane emits returns)
__device__ __forceinline__ void add_quad(float* g_tex, bool emit, Level lv, int wrap, int s0,
                                         int t0, const float w_in[4], float gr, float gg,
                                         float gb) {
    if (!__any_sync(0xffffffffu, emit)) return;
    float w[4] = {w_in[0], w_in[1], w_in[2], w_in[3]};
    int key[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        key[c] = emit ? texel_index(lv, wrap, s0 + (c & 1), t0 + (c >> 1)) : -1;
    }
    // corners that wrap or clamp onto one texel (a level 1 or 2 texels
    // wide, an edge under WRAP_CLAMP) are summed into the first of them
#pragma unroll
    for (int c = 1; c < 4; ++c) {
        bool merged = false;
#pragma unroll
        for (int d = 0; d < c; ++d) {
            if (!merged && key[c] >= 0 && key[c] == key[d]) {
                w[d] += w[c];
                merged = true;
            }
        }
        if (merged) key[c] = -1;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) add_texel(g_tex, key[c], w[c] * gr, w[c] * gg, w[c] * gb);
}

// the transpose of a bilinear lookup of lv at (ss, tt) weighted lw
// (atlas.cuh bilerp): its quad, each corner lw times its bilinear weight
__device__ __forceinline__ void bilerp_bwd(float* g_tex, bool emit, Level lv, int wrap, float ss,
                                           float tt, float lw, float gr, float gg, float gb) {
    float s = ss * (float)lv.w - 0.5f;
    float t = tt * (float)lv.h - 0.5f;
    int s0 = (int)floorf(s);
    int t0 = (int)floorf(t);
    float ds = s - (float)s0;
    float dt = t - (float)t0;
    float w[4] = {lw * ((1.0f - ds) * (1.0f - dt)), lw * (ds * (1.0f - dt)),
                  lw * ((1.0f - ds) * dt), lw * (ds * dt)};
    add_quad(g_tex, emit, lv, wrap, s0, t0, w, gr, gg, gb);
}

// the transpose of T of an 8-tap EWA lookup's taps (k0 .. k0 + T - 1, on
// `levels` of its two levels; L from atlas.cuh set_up or its equivalent)
// for the gradient (gr, gg, gb), already over the weights' sum: a thread
// keeps two open 2x2 quads of a level in registers and sums into them the
// bilinear weights of its taps that fall on them (a magnified or coarse
// lookup's taps mostly fall on one or two); a quad is added (add_quad)
// when a third one opens, and both when the level ends. Every lane of the
// warp calls it with the same T and `levels`
template <int T>
__device__ __forceinline__ void ewa_taps_bwd(float* g_tex, const rt_atlas::Lookup& L, int k0,
                                             const rt_atlas::Taps& taps, int levels, float gr,
                                             float gg, float gb) {
    // two open quads of level qlv: a (the older) and b, their corners
    // and summed weights
    Level qlv = L.lv0;
    bool has_a = false, has_b = false;
    int as = 0, at = 0, bs = 0, bt = 0;
    float wa[4] = {0.0f, 0.0f, 0.0f, 0.0f}, wb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int l = 0; l < 2; ++l) {
        if (l >= levels) break;
        Level lv = l ? L.lv1 : L.lv0;
        float lw = l ? L.dl : 1.0f - L.dl;
        if (l) {
            // to another level (not where both are the top one): add
            // the open quads first
            bool moved = lv.off != qlv.off;
            add_quad(g_tex, moved, qlv, L.wrap, as, at, wa, gr, gg, gb);
            add_quad(g_tex, moved && has_b, qlv, L.wrap, bs, bt, wb, gr, gg, gb);
            if (moved) has_a = has_b = false;
            qlv = lv;
        }
#pragma unroll
        for (int m = 0; m < T; ++m) {
            int k = k0 + m;
            float a = ((float)k + 0.5f) / 8.0f - 0.5f;
            float wk = taps.w[0];
#pragma unroll
            for (int j = 1; j < rt_atlas::kTaps; ++j) wk = k == j ? taps.w[j] : wk;
            float s = (L.st_s + a * L.ms) * (float)lv.w - 0.5f;
            float t = (L.st_t + a * L.mt) * (float)lv.h - 0.5f;
            int s0 = (int)floorf(s);
            int t0 = (int)floorf(t);
            float ds = s - (float)s0;
            float dt = t - (float)t0;
            bool in_a = has_a && s0 == as && t0 == at;
            bool in_b = has_b && s0 == bs && t0 == bt;
            bool fresh = !in_a && !in_b;
            // a third quad: add the older one and shift b into a
            bool spill = fresh && has_b;
            add_quad(g_tex, spill, qlv, L.wrap, as, at, wa, gr, gg, gb);
            if (spill) {
                as = bs;
                at = bt;
#pragma unroll
                for (int c = 0; c < 4; ++c) wa[c] = wb[c];
                has_b = false;
            }
            bool to_b = in_b || (fresh && has_a);
            if (fresh) {
                if (to_b) {
                    bs = s0;
                    bt = t0;
                    has_b = true;
#pragma unroll
                    for (int c = 0; c < 4; ++c) wb[c] = 0.0f;
                } else {
                    as = s0;
                    at = t0;
                    has_a = true;
#pragma unroll
                    for (int c = 0; c < 4; ++c) wa[c] = 0.0f;
                }
            }
            float f = wk * lw;
            float wc[4] = {f * ((1.0f - ds) * (1.0f - dt)), f * (ds * (1.0f - dt)),
                           f * ((1.0f - ds) * dt), f * (ds * dt)};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                wa[c] += to_b ? 0.0f : wc[c];
                wb[c] += to_b ? wc[c] : 0.0f;
            }
        }
    }
    add_quad(g_tex, has_a, qlv, L.wrap, as, at, wa, gr, gg, gb);
    add_quad(g_tex, has_b, qlv, L.wrap, bs, bt, wb, gr, gg, gb);
}

// A tile of ROWS * kTileThreads lanes a block of kTileThreads threads:
// the lanes that add (``active``) are packed in shared memory, so no
// thread works for a lane that adds nothing, and a tile without one costs
// a load a lane
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;

// the tile's packing: its active lanes' offsets from its first, in lane
// order
template <int ROWS>
struct Packed {
    int lane[ROWS * kTileThreads];
    int warp[ROWS * kTileWarps];
};

// packs the active lanes of the tile at `base` (of n lanes) into pk;
// `active(i)` says whether lane i adds. -> their count (the same in every
// thread of the block)
template <int ROWS, class Active>
__device__ __forceinline__ int pack_tile(Active active, long long base, long long n,
                                         Packed<ROWS>& pk) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int in_tile = (int)min((long long)(ROWS * kTileThreads), n - base);
    // a thread looks at lanes tid + j * kTileThreads
    bool on[ROWS];
    unsigned ballot[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        int t = tid + j * kTileThreads;
        on[j] = t < in_tile && active(base + t);
        ballot[j] = __ballot_sync(0xffffffffu, on[j]);
    }
    if (lane == 0) {
#pragma unroll
        for (int j = 0; j < ROWS; ++j) pk.warp[j * kTileWarps + warp] = __popc(ballot[j]);
    }
    __syncthreads();
    int count = 0;
#pragma unroll
    for (int w = 0; w < ROWS * kTileWarps; ++w) count += pk.warp[w];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        if (!on[j]) continue;
        int before = 0;
        for (int w = 0; w < j * kTileWarps + warp; ++w) before += pk.warp[w];
        pk.lane[before + __popc(ballot[j] & ((1u << lane) - 1u))] = tid + j * kTileThreads;
    }
    __syncthreads();
    return count;
}

// the block's `count` packed lookups (``lanes``: a Packed's lane) in
// warp-uniform rounds, G threads a lookup: body(lane i, whether the lookup
// is real, the thread's part of it in [0, G)); an idle group repeats a
// real lookup of its warp (its body must then add zeros)
template <int G, class Body>
__device__ __forceinline__ void rounds(const int* lanes, int count, long long base, Body body) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int p0 = warp * (32 / G); p0 < count; p0 += kTileThreads / G) {
        const int p = p0 + lane / G;
        const bool real = p < count;
        body(base + lanes[real ? p : p0], real, lane % G);
    }
}

// the threads a lookup of a block of `count` packed lookups: the most of
// `least`, 2 `least`, ..., `most` that still run them all in one round,
// else `least`; a `forced` one where it is not 0
__device__ __forceinline__ int group_of(int count, int most, int forced, int least = 1) {
    if (forced) return forced;
    int g = least;
    while (g < most && 2 * g * count <= kTileThreads) g *= 2;
    return g;
}

// a block's tile of 8-tap EWA lookups transposed (ewa_taps_bwd), G threads
// a lookup: look(i, real, &L, &gr, &gg, &gb) sets lane i's lookup and its
// gradient over the weights' sum (zeros where not real). Level 1 is
// skipped where its blend is 0 for the whole warp (an add of exactly 0
// changes no bit: the gradient starts at +0)
template <int G, class Look>
__device__ __forceinline__ void ewa_rounds(const int* lanes, int count, long long base,
                                           float* g_tex, const rt_atlas::Taps& taps, Look look) {
    rounds<G>(lanes, count, base, [&](long long i, bool real, int part) {
        rt_atlas::Lookup L;
        float gr, gg, gb;
        look(i, real, &L, &gr, &gg, &gb);
        const bool flat = L.dl == 0.0f && isfinite(gr) && isfinite(gg) && isfinite(gb);
        const int levels = __all_sync(0xffffffffu, flat) ? 1 : 2;
        ewa_taps_bwd<rt_atlas::kTaps / G>(g_tex, L, part * (rt_atlas::kTaps / G), taps, levels,
                                          gr, gg, gb);
    });
}

// the routes LEAST, 2 LEAST, ..., 8 threads a lookup (group_of's choice
// from `count`, or `forced`, one of them, where it is not 0); only those
// are compiled
template <int LEAST, class Look>
__device__ __forceinline__ void ewa_tile(const int* lanes, int count, long long base, int forced,
                                         float* g_tex, const rt_atlas::Taps& taps, Look look) {
    const int G = group_of(count, 8, forced, LEAST);
    if constexpr (LEAST <= 1) {
        if (G == 1) return ewa_rounds<1>(lanes, count, base, g_tex, taps, look);
    }
    if constexpr (LEAST <= 2) {
        if (G == 2) return ewa_rounds<2>(lanes, count, base, g_tex, taps, look);
    }
    if constexpr (LEAST <= 4) {
        if (G == 4) return ewa_rounds<4>(lanes, count, base, g_tex, taps, look);
    }
    ewa_rounds<8>(lanes, count, base, g_tex, taps, look);
}

}  // namespace rt_grad
