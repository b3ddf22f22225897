// K5: per-lane EWA texture lookup through the shared mip atlas.
//
// Replaces rustracer_tpu/scene/atlas.py atlas_lookup_ewa (:174-230) with
// _bilerp_at_quad (:156) for the (T, 12) quad-row layout and _bilerp_at /
// _texel_at (:139, :124) for the (T, 3) layout with its three wrap modes.
// Per lookup: the registration, the st mapping, the major and minor axes,
// the mip level, then 8 taps x 2 levels of bilinear filtering, the weight
// normalisation and reg_scale, in the reference's operation order (the
// library is built with -fmad=false; log2f and floorf as the plain
// version's torch.log2 and torch.floor). Lanes with reg < 0 get zeros.
//
// Bound: dependent-load latency and instruction issue, not device-memory
// bytes. A lookup reads 16 quad rows (48 bytes each) or 64 texels of a
// small pyramid (the hero atlas is about 1 MB as quad rows) that stays in
// L2, and only the textured lanes need one: in a full-width step about 73%
// of the bounce-0 lanes and 0.6-8% of the interior bounces' lanes. The
// design, for Hopper:
//  (a) each block takes a tile of kTile lanes, ballots them on reg >= 0 and
//      packs the textured ones into shared memory in lane order, so warps
//      run only lookups that count;
//  (b) a group of G threads runs one lookup, each thread 8 / G of its taps
//      on both levels. The block picks G from its own count of lookups:
//      the largest of 1, 2, 4 and 8 that still runs them all in one round
//      of its threads. A sparse tile (an interior bounce) gets up to 8x
//      the independent row loads in flight per lookup; a dense tile keeps
//      one thread per lookup, since every thread of a group repeats the
//      lookup's set-up (one instruction slot per warp either way) and the group
//      adds shuffles. The sum over taps is taken in the reference's order
//      k = 0..7 (through shuffles when G > 1), so the result is bit for
//      bit the one-thread-per-lane sum;
//  (c) results are staged in shared memory (zeros for untextured lanes)
//      and the tile's (kTile, 3) block of the output is written with
//      contiguous words.
// Tables are read through the read-only path (__ldg); a quad row is three
// float4 loads.
#include "atlas.cuh"

namespace {

using namespace rt_atlas;

constexpr int kTile = 128;      // lanes per block
constexpr int kThreads = 128;   // threads per block
constexpr int kMinBlocks = 8;   // resident blocks an SM: at most 64 registers, no spill

struct Args {
    const float* __restrict__ texels;
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
    float* __restrict__ out;
};

// tap k's weighted two-level value
template <bool QUAD>
__device__ __forceinline__ Tex tap(const Args& g, const Lookup& L, int k) {
    float a = ((float)k + 0.5f) / 8.0f - 0.5f;  // exact in float32
    float wk = g.taps.w[0];
#pragma unroll
    for (int j = 1; j < kTaps; ++j) wk = k == j ? g.taps.w[j] : wk;
    float sk = L.st_s + a * L.ms;
    float tk = L.st_t + a * L.mt;
    // the quad rows bake in REPEAT, which every registration then wraps
    constexpr int kStride = QUAD ? 12 : 3;
    const int wrap = QUAD ? 0 : L.wrap;
    Tex b0 = bilerp<kStride>(g.texels, L.lv0, wrap, sk, tk);
    Tex b1 = bilerp<kStride>(g.texels, L.lv1, wrap, sk, tk);
    return {wk * ((1.0f - L.dl) * b0.r + L.dl * b1.r), wk * ((1.0f - L.dl) * b0.g + L.dl * b1.g),
            wk * ((1.0f - L.dl) * b0.b + L.dl * b1.b)};
}

// the block's `count` packed lookups, G threads each, into s_out
template <bool QUAD, int G>
__device__ __forceinline__ void lookups(const Args& g, const int* s_lane, int count,
                                        long long base, float* s_out) {
    constexpr int T = kTaps / G;  // taps a thread
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int leader = lane - lane % G;
    const int k0 = (lane % G) * T;
    // warp-uniform trip count: the shuffles below need the whole warp
    for (int p0 = warp * (32 / G); p0 < count; p0 += kThreads / G) {
        int p = p0 + lane / G;
        bool active = p < count;
        int t = s_lane[active ? p : p0];  // an idle group repeats a live lookup
        Lookup L = set_up(g, base + t);
        // the taps' sum in the reference's order k = 0..7
        float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
        if constexpr (G == 1) {
#pragma unroll
            for (int k = 0; k < kTaps; ++k) {
                Tex v = tap<QUAD>(g, L, k);
                acc_r = acc_r + v.r;
                acc_g = acc_g + v.g;
                acc_b = acc_b + v.b;
            }
        } else {
            Tex v[T];
#pragma unroll
            for (int m = 0; m < T; ++m) v[m] = tap<QUAD>(g, L, k0 + m);
#pragma unroll
            for (int j = 0; j < G; ++j) {
#pragma unroll
                for (int m = 0; m < T; ++m) {
                    acc_r = acc_r + __shfl_sync(0xffffffffu, v[m].r, leader + j);
                    acc_g = acc_g + __shfl_sync(0xffffffffu, v[m].g, leader + j);
                    acc_b = acc_b + __shfl_sync(0xffffffffu, v[m].b, leader + j);
                }
            }
        }
        if (active && lane == leader) {
            float sc = __ldg(g.reg_scale + L.r);
            s_out[3 * t] = acc_r / g.wsum * sc;
            s_out[3 * t + 1] = acc_g / g.wsum * sc;
            s_out[3 * t + 2] = acc_b / g.wsum * sc;
        }
    }
}

template <bool QUAD>
__global__ void __launch_bounds__(kThreads, kMinBlocks) atlas_ewa_kernel(Args g) {
    __shared__ int s_lane[kTile];       // the tile's textured lanes, packed in lane order
    __shared__ float s_out[3 * kTile];  // the tile's (kTile, 3) results
    __shared__ int s_warp[kThreads / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long base = (long long)blockIdx.x * kTile;
    const int in_tile = (int)min((long long)kTile, g.n - base);

    // (a) pack the textured lanes; every result starts as the masked zero
    bool textured = tid < in_tile && g.reg[base + tid] >= 0;
    unsigned ballot = __ballot_sync(0xffffffffu, textured);
    if (lane == 0) s_warp[warp] = __popc(ballot);
#pragma unroll
    for (int j = 0; j < 3; ++j) s_out[tid + j * kTile] = 0.0f;
    __syncthreads();
    int before = 0, count = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
        int c = s_warp[w];
        before += w < warp ? c : 0;
        count += c;
    }
    if (textured) s_lane[before + __popc(ballot & ((1u << lane) - 1u))] = tid;
    __syncthreads();

    // (b) G threads a lookup: the most that run all of them in one round
    if (2 * count > kThreads)
        lookups<QUAD, 1>(g, s_lane, count, base, s_out);
    else if (4 * count > kThreads)
        lookups<QUAD, 2>(g, s_lane, count, base, s_out);
    else if (8 * count > kThreads)
        lookups<QUAD, 4>(g, s_lane, count, base, s_out);
    else
        lookups<QUAD, 8>(g, s_lane, count, base, s_out);
    __syncthreads();

    // (c) the tile's output, contiguous words
    float* o = g.out + 3 * base;
    for (int j = tid; j < 3 * in_tile; j += kThreads) o[j] = s_out[j];
}

}  // namespace

extern "C" int rt_atlas_lookup_ewa(const void* texels, int quad, const void* meta, int lmax,
                                   const void* levels, const void* reg_img, const void* reg_map,
                                   const void* reg_scale, const void* reg_wrap, const void* reg,
                                   const void* uv, const void* dudx, const void* dvdx,
                                   const void* dudy, const void* dvdy, int n, float w0, float w1,
                                   float w2, float w3, float w4, float w5, float w6, float w7,
                                   float wsum, void* out, void* stream) {
    Args g = {(const float*)texels, (const int*)meta, lmax, (const int*)levels,
              (const int*)reg_img, (const float*)reg_map, (const float*)reg_scale,
              (const int*)reg_wrap, (const int*)reg, (const float*)uv, (const float*)dudx,
              (const float*)dvdx, (const float*)dudy, (const float*)dvdy, n,
              {{w0, w1, w2, w3, w4, w5, w6, w7}}, wsum, (float*)out};
    auto kernel = quad ? atlas_ewa_kernel<true> : atlas_ewa_kernel<false>;
    kernel<<<rt::blocks_for(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}
