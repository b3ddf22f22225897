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
#include "common.cuh"

namespace {

constexpr int kTile = 128;      // lanes per block
constexpr int kThreads = 128;   // threads per block
constexpr int kMinBlocks = 8;   // resident blocks an SM: at most 64 registers, no spill
constexpr int kTaps = 8;        // atlas.py N_TAPS

struct Tex {
    float r, g, b;
};

struct Level {
    int off, w, h;
};

__device__ __forceinline__ int floor_mod(int a, int w) { return ((a % w) + w) % w; }

__device__ __forceinline__ Level level_of(const int* meta, int lmax, int img, int li) {
    const int* m = meta + 3 * (img * lmax + li);
    return {__ldg(m), __ldg(m + 1), __ldg(m + 2)};
}

// one wrapped texel of the (T, 3) atlas (_texel_at)
__device__ __forceinline__ Tex texel_at(const float* texels, Level lv, int wrap, int s_i, int t_i) {
    int s_f, t_f;
    if (wrap == 0) {  // WRAP_REPEAT
        s_f = floor_mod(s_i, lv.w);
        t_f = floor_mod(t_i, lv.h);
    } else {
        s_f = min(max(s_i, 0), lv.w - 1);
        t_f = min(max(t_i, 0), lv.h - 1);
    }
    bool inside = s_i >= 0 && s_i < lv.w && t_i >= 0 && t_i < lv.h;
    if (wrap == 1 && !inside) return {0.0f, 0.0f, 0.0f};  // WRAP_BLACK
    const float* p = texels + 3 * (long long)(lv.off + t_f * lv.w + s_f);
    return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// bilinear filtering of one level at st (_bilerp_at / _bilerp_at_quad)
template <bool QUAD>
__device__ __forceinline__ Tex bilerp(const float* texels, Level lv, int wrap, float ss, float tt) {
    float s = ss * (float)lv.w - 0.5f;
    float t = tt * (float)lv.h - 0.5f;
    int s0 = (int)floorf(s);
    int t0 = (int)floorf(t);
    float ds = s - (float)s0;
    float dt = t - (float)t0;
    float w00 = (1.0f - ds) * (1.0f - dt);
    float w10 = ds * (1.0f - dt);
    float w01 = (1.0f - ds) * dt;
    float w11 = ds * dt;
    Tex v00, v10, v01, v11;
    if (QUAD) {
        int row = lv.off + floor_mod(t0, lv.h) * lv.w + floor_mod(s0, lv.w);
        const float4* q = reinterpret_cast<const float4*>(texels + 12 * (long long)row);
        float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
        v00 = {a.x, a.y, a.z};
        v10 = {a.w, b.x, b.y};
        v01 = {b.z, b.w, c.x};
        v11 = {c.y, c.z, c.w};
    } else {
        v00 = texel_at(texels, lv, wrap, s0, t0);
        v10 = texel_at(texels, lv, wrap, s0 + 1, t0);
        v01 = texel_at(texels, lv, wrap, s0, t0 + 1);
        v11 = texel_at(texels, lv, wrap, s0 + 1, t0 + 1);
    }
    return {w00 * v00.r + w10 * v10.r + w01 * v01.r + w11 * v11.r,
            w00 * v00.g + w10 * v10.g + w01 * v01.g + w11 * v11.g,
            w00 * v00.b + w10 * v10.b + w01 * v01.b + w11 * v11.b};
}

struct Taps {
    float w[kTaps];
};

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

// what every tap of one lookup needs: its registration, st and major axis,
// the two levels and the blend between them
struct Lookup {
    int r, wrap;
    float st_s, st_t, ms, mt, dl;
    Level lv0, lv1;
};

__device__ __forceinline__ Lookup set_up(const Args& g, long long i) {
    Lookup L;
    int r = __ldg(g.reg + i);
    int img = __ldg(g.reg_img + r);
    float su = __ldg(g.reg_map + 4 * r), sv = __ldg(g.reg_map + 4 * r + 1);
    float du = __ldg(g.reg_map + 4 * r + 2), dv = __ldg(g.reg_map + 4 * r + 3);
    L.r = r;
    L.wrap = __ldg(g.reg_wrap + r);
    L.st_s = __ldg(g.uv + 2 * i) * su + du;
    L.st_t = __ldg(g.uv + 2 * i + 1) * sv + dv;
    float d0s = __ldg(g.dudx + i) * su, d0t = __ldg(g.dvdx + i) * sv;
    float d1s = __ldg(g.dudy + i) * su, d1t = __ldg(g.dvdy + i) * sv;
    float len0 = sqrtf(fmaxf(d0s * d0s + d0t * d0t, 1e-24f));
    float len1 = sqrtf(fmaxf(d1s * d1s + d1t * d1t, 1e-24f));
    bool major_is_0 = len0 >= len1;
    float major_len = fmaxf(len0, len1);
    float minor_len = fminf(len0, len1);
    L.ms = major_is_0 ? d0s : d1s;
    L.mt = major_is_0 ? d0t : d1t;
    minor_len = fmaxf(minor_len, major_len / 8.0f);  // MAX_ANISOTROPY

    int big_l = __ldg(g.levels + img);
    float top = (float)(big_l - 1);
    float level = top + log2f(fmaxf(minor_len, 1e-8f));
    level = fminf(fmaxf(level, 0.0f), top);
    int l0 = (int)floorf(level);
    int l1 = min(l0 + 1, big_l - 1);
    L.dl = level - (float)l0;
    L.lv0 = level_of(g.meta, g.lmax, img, l0);
    L.lv1 = level_of(g.meta, g.lmax, img, l1);
    return L;
}

// tap k's weighted two-level value
template <bool QUAD>
__device__ __forceinline__ Tex tap(const Args& g, const Lookup& L, int k) {
    float a = ((float)k + 0.5f) / 8.0f - 0.5f;  // exact in float32
    float wk = g.taps.w[0];
#pragma unroll
    for (int j = 1; j < kTaps; ++j) wk = k == j ? g.taps.w[j] : wk;
    float sk = L.st_s + a * L.ms;
    float tk = L.st_t + a * L.mt;
    Tex b0 = bilerp<QUAD>(g.texels, L.lv0, L.wrap, sk, tk);
    Tex b1 = bilerp<QUAD>(g.texels, L.lv1, L.wrap, sk, tk);
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
