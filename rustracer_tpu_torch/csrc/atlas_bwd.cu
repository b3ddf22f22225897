// K10: backward of the atlas EWA lookup K5, the gradient of the (T, 3)
// atlas texels from the gradient of the lookups' (B, 3) output.
//
// Transposes K5 (csrc/atlas.cu; the reference's atlas_lookup_ewa,
// rustracer_tpu/scene/atlas.py:174-230, differentiated by JAX's
// autodiff). A lookup is linear in the texels: out = sum over 8 taps, 2
// levels and 4 bilinear corners of wk * lw * wc * texel / wsum * scale. A
// lookup recomputes K5's set-up (atlas.cuh set_up: the level, the taps'
// st, the blend) and scatter-adds weight * g into each corner's texel.
// Both texel layouts take their gradient in the (T, 3) array: a quad row
// (T, 12) is four REPEAT-wrapped neighbours of the (T, 3) array
// (scene/atlas.py atlas_quad_index), so for `quad` every corner is
// addressed with REPEAT wrapping. WRAP_BLACK corners outside the level
// read 0 and take no gradient.
//
// Bound: the adds, not the bytes. A textured lane reads 36 bytes and does
// about 830 operations, but its 64 adds land on few texels: interior
// bounces filter on the coarse levels (level 7 of the hero's 128^2 pyramid
// is one texel), and at bounce 0 neighbouring pixels magnify the same
// level-0 texels. Adds to one address serialise wherever they meet: in L2
// for global atomics, and in shared memory, where a float atomicAdd is a
// compare-and-swap loop on this card (ATOMS.CAST.SPIN in SASS), which the
// lanes on one address take in turn. The design, for Hopper, sums the adds
// in registers before any atomic:
//  (a) a block takes a tile of kTile lanes, ballots them on reg >= 0 and
//      packs the textured ones in shared memory (as K5), so no thread
//      works for an untextured lane and a tile without one costs a load.
//      A tile is 4 lanes a thread: a wavefront of 2^18 lanes is 256
//      blocks, all resident at once, so an interior bounce's call (1-8% of
//      its lanes textured) waits on one lookup's chain of dependent loads
//      a block, not on four as with a tile of one lane a thread;
//  (b) a group of G threads runs one lookup, each thread 8 / G of its taps
//      on both levels; the block picks G from its count of lookups, the
//      largest of 2, 4 and 8 that still runs them all in one round, else
//      one thread a lookup, in rounds;
//  (c) a thread keeps two open 2x2 quads of a level in registers and sums
//      into them the bilinear weights of its taps that fall on them (a
//      magnified or coarse lookup's taps mostly fall on one or two); a
//      quad is added when a third one opens, and both when the level ends.
//      Level 1 is skipped where its blend weight is 0 for the whole warp
//      (an add of exactly 0 changes no bit: the gradient starts at +0);
//  (d) a quad's corners that wrap or clamp onto one texel are summed first;
//      then the lanes of the warp that add into one texel at once find
//      each other (__match_any_sync), sum in a tree of shuffles, and one of
//      them adds with one global atomic a channel (texel_grad.cuh, shared
//      with K20).
// The sums go in no fixed order: the result agrees with autograd of the
// plain lookup to float rounding.
#include "atlas.cuh"
#include "texel_grad.cuh"

namespace {

using namespace rt_atlas;
using rt_grad::add_texel;

constexpr int kThreads = 256;  // threads a block
constexpr int kTile = 1024;    // lanes a tile

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

// the block's `count` packed lookups, G threads each
template <int G>
__device__ __forceinline__ void lookups(const Args& g, const int* s_lane, int count,
                                        long long base) {
    constexpr int T = kTaps / G;  // taps a thread
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int k0 = (lane % G) * T;
    // warp-uniform trip count: the adds below need the whole warp
    for (int p0 = warp * (32 / G); p0 < count; p0 += kThreads / G) {
        const int p = p0 + lane / G;
        const bool active = p < count;
        // an idle group repeats a live lookup with a zero gradient
        const long long i = base + s_lane[active ? p : p0];
        Lookup L = set_up(g, i);
        if (g.quad) L.wrap = 0;  // quad rows wrap REPEAT
        float sc = active ? __ldg(g.reg_scale + L.r) : 0.0f;
        float gr = __ldg(g.g_out + 3 * i) / g.wsum * sc;
        float gg = __ldg(g.g_out + 3 * i + 1) / g.wsum * sc;
        float gb = __ldg(g.g_out + 3 * i + 2) / g.wsum * sc;
        // level 1 adds exact zeros where the blend is 0 (every magnified
        // lookup) and the gradient finite: a warp all so skips it
        const bool flat = L.dl == 0.0f && isfinite(gr) && isfinite(gg) && isfinite(gb);
        const int levels = __all_sync(0xffffffffu, flat) ? 1 : 2;
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
                add_quad(g.g_tex, moved, qlv, L.wrap, as, at, wa, gr, gg, gb);
                add_quad(g.g_tex, moved && has_b, qlv, L.wrap, bs, bt, wb, gr, gg, gb);
                if (moved) has_a = has_b = false;
                qlv = lv;
            }
#pragma unroll
            for (int m = 0; m < T; ++m) {
                int k = k0 + m;
                float a = ((float)k + 0.5f) / 8.0f - 0.5f;
                float wk = g.taps.w[0];
#pragma unroll
                for (int j = 1; j < kTaps; ++j) wk = k == j ? g.taps.w[j] : wk;
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
                add_quad(g.g_tex, spill, qlv, L.wrap, as, at, wa, gr, gg, gb);
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
        add_quad(g.g_tex, has_a, qlv, L.wrap, as, at, wa, gr, gg, gb);
        add_quad(g.g_tex, has_b, qlv, L.wrap, bs, bt, wb, gr, gg, gb);
    }
}

__global__ void __launch_bounds__(kThreads, 2) atlas_ewa_bwd_kernel(Args g) {
    constexpr int kWarps = kThreads / 32, kRows = kTile / kThreads;
    __shared__ int s_lane[kTile];  // the tile's textured lanes, packed in lane order
    __shared__ int s_warp[kRows * kWarps];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long base = (long long)blockIdx.x * kTile;
    const int in_tile = (int)min((long long)kTile, g.n - base);
    // (a) pack the textured lanes: a thread looks at lanes tid + j * kThreads
    bool textured[kRows];
    unsigned ballot[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        int t = tid + j * kThreads;
        textured[j] = t < in_tile && __ldg(g.reg + base + t) >= 0;
        ballot[j] = __ballot_sync(0xffffffffu, textured[j]);
    }
    if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) s_warp[j * kWarps + warp] = __popc(ballot[j]);
    }
    __syncthreads();
    int count = 0;
#pragma unroll
    for (int w = 0; w < kRows * kWarps; ++w) count += s_warp[w];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        if (!textured[j]) continue;
        int before = 0;
        for (int w = 0; w < j * kWarps + warp; ++w) before += s_warp[w];
        s_lane[before + __popc(ballot[j] & ((1u << lane) - 1u))] = tid + j * kThreads;
    }
    __syncthreads();
    // (b) G threads a lookup: the most that run all of them in one round,
    // or one thread a lookup
    if (count == 0)
        return;
    else if (2 * count > kThreads)
        lookups<1>(g, s_lane, count, base);
    else if (4 * count > kThreads)
        lookups<2>(g, s_lane, count, base);
    else if (8 * count > kThreads)
        lookups<4>(g, s_lane, count, base);
    else
        lookups<8>(g, s_lane, count, base);
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
    atlas_ewa_bwd_kernel<<<rt::blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}
