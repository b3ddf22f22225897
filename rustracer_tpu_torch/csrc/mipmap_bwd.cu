// K20: backward of the per-texture mipmap lookups K17, the gradient of the
// (T, 3) texel rows from the gradient of the lookups' (B, 3) output.
//
// Transposes K17 (csrc/mipmap.cu), that is the reference's
// rustracer_tpu/ops/mipmap.py lookup_trilinear (:100), lookup_ewa (:128)
// and lookup_ewa_exact (:167) differentiated by JAX's autodiff. A lookup is
// linear in the texels, so a lane recomputes K17's set-up (mipmap.cuh: the
// same levels, axes, ellipse and taps) and adds weight * g into each texel
// it read:
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
// serialise in L2. On a recorded textures-train backward (65,536 lanes a
// call, tools/k20_parts.py) the design with one thread a lane spent 70% of
// an 8-tap call in the adds, each of a lane's 64 corners through
// add_texel's warp match and shuffle tree, a lane's own taps never summed
// first, and only 10-30% of the lanes had a gradient other than 0 (the
// lanes of the surfaces that take the texture); finding the level once a
// lane gained nothing. The design, K10's (atlas_bwd.cu), shares its code
// (texel_grad.cuh):
//  (a) a block takes a tile of 256 lanes and packs in shared memory the
//      lanes that add (pack_tile: a nonzero gradient, or a coordinate that
//      is not finite), so no thread works for a lane whose adds are all 0
//      (a textures-train call of 65,536 lanes is 256 blocks; tiles of 512
//      and 1024 lanes, K10's, left part of the card idle and ran 1.2-2.8x
//      longer);
//  (b) a group of G threads runs one lookup: the block picks G from its
//      count, the most that still runs its lookups in one round (the
//      8-tap lookup 4 to 8, each thread 8 / G of its taps on both levels;
//      trilinear at most 2, each thread one level; the exact lookup at
//      most 8, each thread every G-th tap of the box, the weight sum
//      gathered by shuffles), or ``group`` forces it;
//  (c) the 8-tap lookup finds its level pair once; a thread sums its taps'
//      bilinear weights into two open 2x2 quads of a level (ewa_taps_bwd),
//      so a lookup adds a few quads, not 16; level 1 is skipped where its
//      blend is 0 for the whole warp;
//  (d) a quad's corners that wrap or clamp onto one texel are summed, then
//      the lanes of the warp that add into one texel at once sum in
//      registers (add_texel) before one global atomic a channel;
//  (e) the exact lookup walks its box's taps with a running column and row
//      (no division a tap), an expf only inside the ellipse, and a warp
//      adds only at the taps where one of its lanes is inside.
// The wrap is a template parameter. The sums go in no fixed order: the
// result agrees with autograd of the plain lookups to float rounding.
#include "mipmap.cuh"
#include "texel_grad.cuh"

namespace {

using rt_atlas::Level;

constexpr int kThreads = rt_grad::kTileThreads;
// the fewest threads an 8-tap lookup takes: a lookup's taps spread over
// many quads (an anisotropic footprint at the finer level) then run in
// parallel, and one with its taps on a quad or two still sums them in a
// thread's open quads (on a recorded textures-train backward, G 4 and 8
// beat 1 and 2 on the spread calls, and G 1-4 tied on the others); the
// routes of 1 and 2 threads are not compiled
constexpr int kEwaLeastGroup = 4;

struct Args {
    const float* g_out;  // (n, 3) the lookups' gradient
    const int* meta;     // (n_levels, 3) [offset, w, h]
    int n_levels;
    const float *st, *dst0, *dst1, *width;
    float max_aniso;
    int n;
    rt_atlas::Taps taps;
    float wsum, e2;
    float* g_tex;  // (n_texels, 3), zeroed by the caller
    int group;     // threads a lookup, 0: each block's choice
};

// whether lane i adds: a nonzero gradient, or a coordinate that is not
// finite (its weights then are not, and times 0 they add NaN as the plain
// version's do); `diffs`: the EWA modes' differentials count
__device__ __forceinline__ bool adds(const Args& g, long long i, bool diffs) {
    bool any = __ldg(g.g_out + 3 * i) != 0.0f || __ldg(g.g_out + 3 * i + 1) != 0.0f ||
               __ldg(g.g_out + 3 * i + 2) != 0.0f;
    bool finite = isfinite(__ldg(g.st + 2 * i)) && isfinite(__ldg(g.st + 2 * i + 1));
    if (diffs) {
        finite = finite && isfinite(__ldg(g.dst0 + 2 * i)) && isfinite(__ldg(g.dst0 + 2 * i + 1)) &&
                 isfinite(__ldg(g.dst1 + 2 * i)) && isfinite(__ldg(g.dst1 + 2 * i + 1));
    }
    return any || !finite;
}

// lane i's gradient over `scale`, or zeros for an idle group's repeat
__device__ __forceinline__ void lane_grad(const Args& g, bool real, long long i, float scale,
                                          float* gr, float* gg, float* gb) {
    *gr = real ? __ldg(g.g_out + 3 * i) / scale : 0.0f;
    *gg = real ? __ldg(g.g_out + 3 * i + 1) / scale : 0.0f;
    *gb = real ? __ldg(g.g_out + 3 * i + 2) / scale : 0.0f;
}

// the transpose of a trilinear lookup, G threads a lookup: one thread both
// levels, or two one level each
template <int G, int WRAP>
__device__ __forceinline__ void trilinear_rounds(const Args& g, const int* lanes, int count,
                                                 long long base) {
    rt_grad::rounds<G>(lanes, count, base, [&](long long i, bool real, int part) {
        const float s = __ldg(g.st + 2 * i), t = __ldg(g.st + 2 * i + 1);
        rt_mip::Tri tl = rt_mip::tri_levels(g.n_levels, __ldg(g.width + i));
        float gr, gg, gb;
        lane_grad(g, real, i, 1.0f, &gr, &gg, &gb);
        // a warp whose every lane has a blend of 0 and a finite gradient
        // adds nothing at level 1 (exact zeros)
        const bool flat = tl.dl == 0.0f && isfinite(gr) && isfinite(gg) && isfinite(gb);
        const int levels = __all_sync(0xffffffffu, flat) ? 1 : 2;
        if (G == 2) {
            // the two threads of a lookup sit in one warp: level 1's adds
            // where the warp walks two levels
            rt_grad::bilerp_bwd(g.g_tex, part < levels,
                                rt_mip::level(g.meta, part ? tl.l1 : tl.l0), WRAP, s, t,
                                part ? tl.dl : 1.0f - tl.dl, gr, gg, gb);
            return;
        }
        for (int l = 0; l < levels; ++l) {
            rt_grad::bilerp_bwd(g.g_tex, true, rt_mip::level(g.meta, l ? tl.l1 : tl.l0), WRAP, s,
                                t, l ? tl.dl : 1.0f - tl.dl, gr, gg, gb);
        }
    });
}

template <int WRAP>
__global__ void __launch_bounds__(kThreads, 2) mipmap_bwd_trilinear_kernel(Args g) {
    __shared__ rt_grad::Packed<1> pk;
    const long long base = (long long)blockIdx.x * kThreads;
    const int count = rt_grad::pack_tile<1>([&](long long i) { return adds(g, i, false); },
                                               base, g.n, pk);
    if (rt_grad::group_of(count, 2, g.group) == 1)
        trilinear_rounds<1, WRAP>(g, pk.lane, count, base);
    else
        trilinear_rounds<2, WRAP>(g, pk.lane, count, base);
}

// the transpose of the 8-tap lookup (texel_grad.cuh ewa_tile: G threads a
// lookup, 8 / G taps each, two open quads a thread)
template <int WRAP>
__global__ void __launch_bounds__(kThreads, 2) mipmap_bwd_ewa_kernel(Args g) {
    __shared__ rt_grad::Packed<1> pk;
    const long long base = (long long)blockIdx.x * kThreads;
    const int count = rt_grad::pack_tile<1>([&](long long i) { return adds(g, i, true); },
                                               base, g.n, pk);
    rt_grad::ewa_tile<kEwaLeastGroup>(
        pk.lane, count, base, g.group, g.g_tex, g.taps,
        [&](long long i, bool real, rt_atlas::Lookup* L, float* gr, float* gg, float* gb) {
            rt_mip::Axes ax =
                rt_mip::ewa_axes(__ldg(g.dst0 + 2 * i), __ldg(g.dst0 + 2 * i + 1),
                                 __ldg(g.dst1 + 2 * i), __ldg(g.dst1 + 2 * i + 1), g.max_aniso);
            // the taps share the minor axis, so their levels
            rt_mip::Tri tl = rt_mip::tri_levels(g.n_levels, ax.minor_len);
            L->r = 0;
            L->wrap = WRAP;
            L->st_s = __ldg(g.st + 2 * i);
            L->st_t = __ldg(g.st + 2 * i + 1);
            L->ms = ax.ms;
            L->mt = ax.mt;
            L->dl = tl.dl;
            L->lv0 = rt_mip::level(g.meta, tl.l0);
            L->lv1 = rt_mip::level(g.meta, tl.l1);
            lane_grad(g, real, i, g.wsum, gr, gg, gb);
        });
}

// a thread's share of the exact lookup's box taps k < n_taps (the
// reference's order, every G-th from its part), a running column and row:
// r^2 of the current tap, its texel in (ss, tt)
struct BoxWalk {
    int col, row;
    __device__ __forceinline__ BoxWalk(const rt_mip::Ellipse& e, int part) : col(part), row(0) {
        fold(e);
    }
    __device__ __forceinline__ void fold(const rt_mip::Ellipse& e) {
        while (col >= e.wu) {
            col -= e.wu;
            ++row;
        }
    }
    __device__ __forceinline__ float r2(const rt_mip::Ellipse& e, int* ss, int* tt) const {
        *ss = e.s0 + col;
        *tt = e.t0 + row;
        float du = (float)*ss - e.px, dv = (float)*tt - e.py;
        return e.A * du * du + e.B * du * dv + e.C * dv * dv;
    }
    __device__ __forceinline__ void next(const rt_mip::Ellipse& e, int step) {
        col += step;
        fold(e);
    }
};

// the transpose of the exact lookup, G threads a lookup, each every G-th
// box tap: the weight sum over the group (shuffles), then the adds
template <int G, int WRAP>
__device__ __forceinline__ void exact_rounds(const Args& g, const int* lanes, int count,
                                             long long base) {
    rt_grad::rounds<G>(lanes, count, base, [&](long long i, bool real, int part) {
        const float s = __ldg(g.st + 2 * i), t = __ldg(g.st + 2 * i + 1);
        rt_mip::Ellipse e = rt_mip::ellipse(g.meta, g.n_levels, g.max_aniso, s, t,
                                            __ldg(g.dst0 + 2 * i), __ldg(g.dst0 + 2 * i + 1),
                                            __ldg(g.dst1 + 2 * i), __ldg(g.dst1 + 2 * i + 1));
        if (!real) e.n_taps = 0;
        float gr, gg, gb;
        lane_grad(g, real, i, 1.0f, &gr, &gg, &gb);
        // pass 1: the weight sum (one thread: the forward's order)
        const int mine = e.n_taps > part ? (e.n_taps - part + G - 1) / G : 0;
        float wsum = 0.0f;
        BoxWalk w1(e, part);
        for (int k = 0; k < mine; ++k, w1.next(e, G)) {
            int ss, tt;
            float r2 = w1.r2(e, &ss, &tt);
            if (r2 < 1.0f) wsum = wsum + (expf(-2.0f * r2) - g.e2);
        }
#pragma unroll
        for (int o = G / 2; o > 0; o /= 2) wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
        const bool taps = wsum > 1e-9f;
        float d = fmaxf(wsum, 1e-9f);
        float tr = gr / d, tg = gg / d, tb = gb / d;
        // pass 2: each tap inside takes its weight times g / wsum; the
        // warp runs its most taps a thread and adds where one of its lanes
        // is inside
        const int trip = __reduce_max_sync(0xffffffffu, taps ? mine : 0);
        BoxWalk w2(e, part);
        for (int k = 0; k < trip; ++k, w2.next(e, G)) {
            int ss = 0, tt = 0;
            float r2 = k < mine ? w2.r2(e, &ss, &tt) : 2.0f;
            bool in = taps && r2 < 1.0f;
            if (!__any_sync(0xffffffffu, in)) continue;
            float wgt = in ? expf(-2.0f * r2) - g.e2 : 0.0f;
            rt_grad::add_texel(g.g_tex, in ? rt_atlas::texel_index(e.lv, WRAP, ss, tt) : -1,
                               tr * wgt, tg * wgt, tb * wgt);
        }
        // the bilinear fallback where no tap landed (the group's first
        // thread)
        rt_grad::bilerp_bwd(g.g_tex, real && !taps && part == 0, e.lv, WRAP, s, t, 1.0f, gr, gg,
                            gb);
    });
}

template <int WRAP>
__global__ void __launch_bounds__(kThreads, 2) mipmap_bwd_exact_kernel(Args g) {
    __shared__ rt_grad::Packed<1> pk;
    const long long base = (long long)blockIdx.x * kThreads;
    const int count = rt_grad::pack_tile<1>([&](long long i) { return adds(g, i, true); },
                                               base, g.n, pk);
    switch (rt_grad::group_of(count, 8, g.group)) {
        case 1: exact_rounds<1, WRAP>(g, pk.lane, count, base); break;
        case 2: exact_rounds<2, WRAP>(g, pk.lane, count, base); break;
        case 4: exact_rounds<4, WRAP>(g, pk.lane, count, base); break;
        default: exact_rounds<8, WRAP>(g, pk.lane, count, base); break;
    }
}

// whether `mode` has a route of `group` threads a lookup (0: each block's
// choice): trilinear 1 or 2, the 8-tap lookup kEwaLeastGroup to 8, the
// exact one 1 to 8, a power of two
bool has_route(int mode, int group) {
    const int least = mode == 1 ? kEwaLeastGroup : 1, most = mode == 0 ? 2 : 8;
    return group == 0 || (group >= least && group <= most && !(group & (group - 1)));
}

template <int WRAP>
void launch(const Args& g, int mode, cudaStream_t s) {
    int blocks = rt::blocks_for(g.n, kThreads);
    if (mode == 0)
        mipmap_bwd_trilinear_kernel<WRAP><<<blocks, kThreads, 0, s>>>(g);
    else if (mode == 1)
        mipmap_bwd_ewa_kernel<WRAP><<<blocks, kThreads, 0, s>>>(g);
    else
        mipmap_bwd_exact_kernel<WRAP><<<blocks, kThreads, 0, s>>>(g);
}

}  // namespace

// K17's arguments with the lookups' gradient g_out (n, 3) in place of its
// output, g_tex, the (n_texels, 3) texel gradient, zeroed by the caller
// and added into, and the threads a lookup (group: 1 or 2 for trilinear,
// 4 or 8 for the 8-tap EWA, 1, 2, 4 or 8 for the exact one; 0 each
// block's choice from its count of lanes that add)
extern "C" int rt_mipmap_lookup_bwd(const void* g_out, const void* meta, int n_levels, int wrap,
                                    int mode, const void* st, const void* dst0, const void* dst1,
                                    const void* width, float max_aniso, int n, float w0, float w1,
                                    float w2, float w3, float w4, float w5, float w6, float w7,
                                    float wsum, float e2, void* g_tex, int n_texels, int group,
                                    void* stream) {
    if (n_texels <= 0) return (int)cudaErrorInvalidValue;
    if (mode < 0 || mode > 2 || wrap < 0 || wrap > 2) return (int)cudaErrorInvalidValue;
    if (!has_route(mode, group)) return (int)cudaErrorInvalidValue;
    Args g{(const float*)g_out, (const int*)meta, n_levels, (const float*)st,
           (const float*)dst0, (const float*)dst1, (const float*)width, max_aniso, n,
           {{w0, w1, w2, w3, w4, w5, w6, w7}}, wsum, e2, (float*)g_tex, group};
    auto s = (cudaStream_t)stream;
    if (wrap == 0)
        launch<0>(g, mode, s);
    else if (wrap == 1)
        launch<1>(g, mode, s);
    else
        launch<2>(g, mode, s);
    return (int)cudaGetLastError();
}
