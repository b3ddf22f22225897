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
//      them adds with one global atomic a channel.
// (c) and (d) are texel_grad.cuh's ewa_taps_bwd, shared with K20.
// The sums go in no fixed order: the result agrees with autograd of the
// plain lookup to float rounding.
#include "atlas.cuh"
#include "texel_grad.cuh"

namespace {

using namespace rt_atlas;

constexpr int kThreads = rt_grad::kTileThreads;  // threads a block
constexpr int kRows = 4;                         // lanes a thread packs
constexpr int kTile = kRows * kThreads;          // lanes a tile

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

__global__ void __launch_bounds__(kThreads, 2) atlas_ewa_bwd_kernel(Args g) {
    __shared__ rt_grad::Packed<kRows> pk;  // the tile's textured lanes
    const long long base = (long long)blockIdx.x * kTile;
    // (a) pack the textured lanes
    const int count =
        rt_grad::pack_tile([&](long long i) { return __ldg(g.reg + i) >= 0; }, base, g.n, pk);
    // (b)-(d) G threads a lookup: the most that run all of them in one
    // round, or one thread a lookup
    rt_grad::ewa_tile<1>(
        pk.lane, count, base, 0, g.g_tex, g.taps,
        [&](long long i, bool real, Lookup* L, float* gr, float* gg, float* gb) {
            *L = set_up(g, i);
            if (g.quad) L->wrap = 0;  // quad rows wrap REPEAT
            float sc = real ? __ldg(g.reg_scale + L->r) : 0.0f;
            *gr = __ldg(g.g_out + 3 * i) / g.wsum * sc;
            *gg = __ldg(g.g_out + 3 * i + 1) / g.wsum * sc;
            *gb = __ldg(g.g_out + 3 * i + 2) / g.wsum * sc;
        });
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
