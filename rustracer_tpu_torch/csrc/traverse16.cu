// K1: closest-hit and any-hit traversal of the 16-wide BVH (one template:
// ANY_HIT, INSTANCED, ALPHA), a group of 16 lanes per ray.
//
// Replaces rustracer_tpu/accel/traverse16.py: _make_body (:137) with
// _interior_hits (:76) and _leaf_hits (:108), its instance records
// (instanced=True, :196-216, entry and exit :262-280), the outer loops
// _traverse16 (:432) and _traverse16_regen (:282), the watertight test of
// rustracer_tpu/ops/triangle.py:80 (common.cuh tri_intersect), and the alpha
// cutouts of rustracer_tpu/scene/tables.py _closest_with_alpha (:394) with
// _alpha_at (:332) and _tri_hit_uv (:373). Table layout:
// rustracer_tpu/accel/wide.py (128-float interior / leaf / instance
// records).
//
// The walk is the reference's step for step, so hits, t bits and the
// observed counts [rows read, triangle tests] agree with it: each step reads
// one 512-byte record; an interior record gives 16 slab tests against the
// current t_best and descends to the nearest unvisited hit child (children
// are pre-sorted per ray octant), pushing (row, remaining mask) while the
// stack is within the table's depth; a leaf record gives 8 watertight
// triangle tests (the lowest index wins a tie, as argmin does); then it
// pops, and a popped record is read again and its boxes re-tested against
// the tightened t_best. Any hit stops after the first leaf with a hit. The
// TPU loops' regeneration window and majority+drain passes only refill idle
// vector lanes and give bit-identical results; they have no counterpart.
//
// What bounds it on an H100: the work per ray is about 11 dependent record
// reads and 10-15 triangle tests (the 327,680-triangle dragon: 11.06 rows
// and 10.15 tests per camera ray, 11.30 / 14.69 per bounce ray). The bytes
// a call must move are the rays (37 B in and out) and the distinct records
// (7-18 thousand of 114,023), and the operations are about 5,000 a ray,
// each one instruction (no FMAs), so 2^18 rays could take about 40 us at
// 33.5 T instructions/s (operations). What a walk pays instead
// is the latency of its chain of record reads and the instructions each
// step issues. One thread per ray reading a record one float at a time
// turned each warp-wide load into 32 scattered sectors.
// What the design does about it:
//   1. 16 lanes per ray, two rays a warp. Lane k loads words 1+k+16*i of the
//      record, i = 0..6, plus the tag word: each load is one contiguous
//      64-byte run across the group, so the whole record arrives in one
//      round of independent coalesced loads, issued before the tag decides
//      what the record is. On an interior record lane k owns child k, runs
//      the slab test for it, and a ballot gives the hit mask; the nearest
//      child's link comes by shuffle from its lane. On a leaf, lanes 0-7
//      test one triangle each (the vertex words that lie on lanes 8-15 come
//      by shuffle), and a __reduce_min_sync over the t bits with a ballot of
//      the lanes at the minimum gives the lexicographic minimum of
//      (t, index).
//   2. The two groups of a warp run apart: each takes its own branch (leaf
//      or interior, push, pop), and its shuffles, ballots and reductions
//      name only its own lanes. Stepping them in lockstep instead, every
//      sync intrinsic on the full warp, measured slower: a step then ran
//      both branches whenever the groups differed, and the stack slots went
//      to a stack frame.
//   3. The stack lives in the group's registers: entry s sits on lane s % 16
//      in slot s / 16; a push is a predicated write on one lane, a pop a
//      shuffle from it. kMaxDepth = 32 entries, the wrapper's limit, cost 2
//      registers a lane and no local memory.
//   4. Persistent groups: the launch fills the card once (occupancy x SMs)
//      and a group whose ray ends takes the next one with an atomicAdd on a
//      ray counter, so it does not idle until the warp's slowest ray ends.
//      A dead ray (t_max <= 0) writes its miss and the group takes the next
//      ray at once. The launch's last fetch leaves the counter at 0 for the
//      next launch on the stream. Against 8 lanes a ray and against one
//      group per ray, it was faster on every wavefront measured (PERF.md).
//   5. Counts, when asked for, are summed per warp and added once per block.
//
// Instances (INSTANCED; the reference's TransformedPrimitive,
// primitive.rs:89-118): an instance record (tag >= 1 << 20) holds the
// object's 8 BLAS roots in words 1-8 (lanes 0-7), the instance id in word 9
// (lane 8) and the world-to-object rows in words 10-21 (lanes 9-15, then
// 0-4 of the second load); the group takes the 12 by shuffle, moves the
// world ray to object space in the reference's order (m0*x + m1*y + m2*z
// + m3, no FMA: the bits follow), recomputes the inverse direction and the
// octant, takes that octant's root and remembers the instance and the
// stack height. A pop to below that height restores the world ray, read
// again from the ray's input (no register keeps it). The walk also writes
// the instance of the hit, -1 for a static hit and a miss.
//
// Alpha cutouts (ALPHA; the reference's per-triangle test,
// shapes/mesh.rs:355-367): a leaf lane whose triangle passes the watertight
// test and has an alpha id >= 0 (closest hit: t_alpha_tex; any hit also
// t_shadow_alpha_tex, mesh.rs:572-577) reads the triangle's uv words 18-24
// of t_shade (the default uv without them), takes the hit's uv from the
// test's barycentrics, bilerps the baked atlas as _alpha_at does (a floor
// modulo wrap) and drops the candidate where that is 0.0, before the
// group's minimum. The JAX package re-traces whole walks from past each
// cut-out hit instead, up to 64 times with a host-visible test each round:
// here it is one launch. Two departures from that loop, both the
// reference's semantics: the loop skips a surface within rej_t*1e-4 + 1e-5
// behind a cut-out hit, and it gives up after 64 rejections; this does
// neither.
#include "common.cuh"

namespace {

constexpr int kRec = 128;
constexpr int kMaxDepth = 32;  // the wrapper refuses deeper tables
constexpr int kGroup = 16;     // lanes per ray; lane k owns child k
constexpr int kWords = 112 / kGroup;    // record words a lane loads (1..112)
constexpr int kSlots = kMaxDepth / kGroup;  // stack slots a lane holds
constexpr unsigned kFullMask = 0xFFFFu;
constexpr int kThreads = 128;
constexpr int kTagInst = 1 << 20;  // accel/bvh_build.py TAG_INST

__device__ __forceinline__ float inv_dir(float c) {
    float safe = fabsf(c) < 1e-20f ? (c < 0.0f ? -1e-20f : 1e-20f) : c;
    return 1.0f / safe;
}

struct Table {
    const float* __restrict__ rec;
    int n_rows;
    const int* __restrict__ roots;
    int depth;
};

// the alpha tables: t_shade rows (uv words 18-23, flags 24), the two alpha
// columns, the baked atlas and its (offset, width, height) rows
struct Alpha {
    const float* __restrict__ t_shade;
    const int* __restrict__ tex;
    const int* __restrict__ shadow_tex;
    const float* __restrict__ atlas;
    const int* __restrict__ meta;
};

// a floor modulo: never negative, as jnp.mod
__device__ __forceinline__ int wrap(int a, int n) {
    const int r = a % n;
    return r < 0 ? r + n : r;
}

// the atlas's bilinear lookup at (u, v) of alpha map aid >= 0
// (rustracer_tpu/scene/tables.py _alpha_at)
__device__ __forceinline__ float alpha_at(const Alpha& al, int aid, float u, float v) {
    const int off = __ldg(al.meta + 3 * aid);
    const int w = max(__ldg(al.meta + 3 * aid + 1), 1), h = max(__ldg(al.meta + 3 * aid + 2), 1);
    const float uu = u * (float)w - 0.5f, vv = v * (float)h - 0.5f;
    const float fu = floorf(uu), fv = floorf(vv);
    const float du = uu - fu, dv = vv - fv;
    const int u0 = (int)fu, v0 = (int)fv;
    const int ua = wrap(u0, w), ub = wrap(u0 + 1, w);
    const int va = wrap(v0, h) * w, vb = wrap(v0 + 1, h) * w;
    const float t00 = __ldg(al.atlas + off + va + ua), t10 = __ldg(al.atlas + off + va + ub);
    const float t01 = __ldg(al.atlas + off + vb + ua), t11 = __ldg(al.atlas + off + vb + ub);
    return t00 * (1.0f - du) * (1.0f - dv) + t10 * du * (1.0f - dv) + t01 * (1.0f - du) * dv +
           t11 * du * dv;
}

// the hit th of triangle tid lies in a cut-out of its alpha map (or, for a
// shadow ray, of its shadow-alpha map)
template <bool ANY_HIT>
__device__ __forceinline__ bool cut_out(const Alpha& al, int tid, const rt::TriHit& th) {
    const int a0 = __ldg(al.tex + tid);
    const int a1 = ANY_HIT ? __ldg(al.shadow_tex + tid) : -1;
    if (a0 < 0 && a1 < 0) return false;
    const float* row = al.t_shade + (size_t)tid * 32;
    const bool has_uv = __float_as_int(__ldg(row + 24)) & 1;
    const float u0 = has_uv ? __ldg(row + 18) : 0.0f, v0 = has_uv ? __ldg(row + 19) : 0.0f;
    const float u1 = has_uv ? __ldg(row + 20) : 1.0f, v1 = has_uv ? __ldg(row + 21) : 0.0f;
    const float u2 = has_uv ? __ldg(row + 22) : 1.0f, v2 = has_uv ? __ldg(row + 23) : 1.0f;
    const float u = th.b0 * u0 + th.b1 * u1 + th.b2 * u2;
    const float v = th.b0 * v0 + th.b1 * v1 + th.b2 * v2;
    return (a0 >= 0 && alpha_at(al, a0, u, v) == 0.0f) ||
           (a1 >= 0 && alpha_at(al, a1, u, v) == 0.0f);
}

// Ray i walked by the 16 lanes of a group (mask gmask, first lane gbase);
// this thread is lane k of the group. Every value but the loaded words and
// the stack slots is the same on all 16 lanes. Adds the ray's rows read and
// triangle tests to *rows and *tests.
template <bool ANY_HIT, bool INSTANCED, bool ALPHA>
__device__ __forceinline__ void walk(const Table& tab, const Alpha& al,
                                     const float* __restrict__ o_in,
                                     const float* __restrict__ d_in,
                                     const float* __restrict__ t_max, int i, int k, int gbase,
                                     unsigned gmask, bool* __restrict__ hit_out,
                                     float* __restrict__ t_out, int* __restrict__ prim_out,
                                     int* __restrict__ inst_out, unsigned* rows,
                                     unsigned* tests) {
    // the ray in the current space: the world's, or an instance's object
    // space while the walk is inside its BLAS
    rt::V3 o{__ldg(o_in + 3 * i), __ldg(o_in + 3 * i + 1), __ldg(o_in + 3 * i + 2)};
    rt::V3 d{__ldg(d_in + 3 * i), __ldg(d_in + 3 * i + 1), __ldg(d_in + 3 * i + 2)};
    float t_best = __ldg(t_max + i);
    int prim = -1;
    int inst_cur = -1, inst_sp = 0, inst_best = -1;
    if (!(t_best <= 0.0f)) {  // a dead ray is a miss without a step
        float ix = inv_dir(d.x), iy = inv_dir(d.y), iz = inv_dir(d.z);
        const int octant = (d.x < 0.0f ? 1 : 0) | (d.y < 0.0f ? 2 : 0) | (d.z < 0.0f ? 4 : 0);
        int row = __ldg(tab.roots + octant);
        unsigned vmask = kFullMask;
        unsigned sp = 0;
        int stack_row[kSlots];
        unsigned stack_mask[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
            stack_row[s] = 0;
            stack_mask[s] = 0u;
        }
        for (;;) {
            ++*rows;
            const float* rec = tab.rec + (size_t)min(max(row, 0), tab.n_rows - 1) * kRec;
            const int tag = __float_as_int(__ldg(rec));
            float w[kWords];  // w[j] = word 1+k+16j
#pragma unroll
            for (int j = 0; j < kWords; ++j) w[j] = __ldg(rec + 1 + k + kGroup * j);
            bool descend = false;
            int link = 0;
            if (tag < 0) {
                // leaf: triangle j on lane j < 8; its id is word 1+j, its
                // vertex component c word 9+8c+j, which lies on lane
                // j + (8+8c) % 16 as loaded word (8+8c) / 16
                const int tid = __float_as_int(w[0]);
                float v[9];
#pragma unroll
                for (int c = 0; c < 9; ++c) {
                    const float x = w[(8 + 8 * c) / kGroup];
                    v[c] = (8 + 8 * c) % kGroup
                               ? __shfl_down_sync(gmask, x, (8 + 8 * c) % kGroup, kGroup)
                               : x;
                }
                const bool test = k < 8 && tid >= 0;
                *tests += __popc(__ballot_sync(gmask, test));
                float cand_t = rt::kInf;
                int cand = -1;
                if (test) {
                    rt::TriHit th = rt::tri_intersect(o, d, t_best, rt::V3{v[0], v[1], v[2]},
                                                      rt::V3{v[3], v[4], v[5]},
                                                      rt::V3{v[6], v[7], v[8]});
                    if (ALPHA && th.hit && cut_out<ANY_HIT>(al, tid, th)) th.hit = false;
                    if (th.hit) {
                        cand_t = th.t;
                        cand = tid;
                    }
                }
                // the lexicographic minimum of (t, lane) over the group: a
                // hit has t > 0 (a miss +inf), so the bits order as the
                // floats do; the lowest lane at the minimum wins the tie
                const unsigned key = __float_as_uint(cand_t);
                const unsigned best = __reduce_min_sync(gmask, key);
                const int win = __ffs(__ballot_sync(gmask, key == best) >> gbase) - 1;
                cand = __shfl_sync(gmask, cand, win, kGroup);
                if (cand >= 0 && __uint_as_float(best) < t_best) {
                    t_best = __uint_as_float(best);
                    prim = cand;
                    if (INSTANCED) inst_best = inst_cur;
                }
            } else if (INSTANCED && tag >= kTagInst) {
                // instance record: w2o word 10+j lies on lane 9+j (j < 7) as
                // loaded word 0, else on lane j-7 as loaded word 1
                float m[12];
#pragma unroll
                for (int j = 0; j < 12; ++j)
                    m[j] = __shfl_sync(gmask, j < 7 ? w[0] : w[1], j < 7 ? 9 + j : j - 7, kGroup);
                const rt::V3 ow = o, dw = d;
                o = rt::V3{m[0] * ow.x + m[1] * ow.y + m[2] * ow.z + m[3],
                           m[4] * ow.x + m[5] * ow.y + m[6] * ow.z + m[7],
                           m[8] * ow.x + m[9] * ow.y + m[10] * ow.z + m[11]};
                d = rt::V3{m[0] * dw.x + m[1] * dw.y + m[2] * dw.z,
                           m[4] * dw.x + m[5] * dw.y + m[6] * dw.z,
                           m[8] * dw.x + m[9] * dw.y + m[10] * dw.z};
                ix = inv_dir(d.x);
                iy = inv_dir(d.y);
                iz = inv_dir(d.z);
                const int oct = (d.x < 0.0f ? 1 : 0) | (d.y < 0.0f ? 2 : 0) | (d.z < 0.0f ? 4 : 0);
                inst_cur = __shfl_sync(gmask, __float_as_int(w[0]), 8, kGroup);
                inst_sp = (int)sp;
                row = __shfl_sync(gmask, __float_as_int(w[0]), oct, kGroup);
                vmask = kFullMask;
                continue;
            } else {
                // interior: child k; its link is word 1+k, its bounds words
                // 17+k .. 97+k, 16 apart
                const float t0x = (w[1] - o.x) * ix, t1x = (w[4] - o.x) * ix;
                const float t0y = (w[2] - o.y) * iy, t1y = (w[5] - o.y) * iy;
                const float t0z = (w[3] - o.z) * iz, t1z = (w[6] - o.z) * iz;
                const float t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
                const float t_far =
                    fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) * 1.00000024f;
                const bool h = ((vmask >> k) & 1u) && t_near <= t_far && t_far > 0.0f &&
                               t_near < t_best && __float_as_int(w[0]) >= 0;
                const unsigned m = __ballot_sync(gmask, h) >> gbase;
                if (m != 0) {
                    descend = true;
                    const int slot = __ffs(m) - 1;  // the nearest unvisited hit child
                    link = __shfl_sync(gmask, __float_as_int(w[0]), slot, kGroup);
                    const unsigned rest = m & (m - 1u);
                    if (rest != 0) {
                        if (sp < (unsigned)tab.depth && k == (int)(sp % kGroup)) {
#pragma unroll
                            for (int s = 0; s < kSlots; ++s)
                                if (sp / kGroup == (unsigned)s) {
                                    stack_row[s] = row;
                                    stack_mask[s] = rest;
                                }
                        }
                        ++sp;
                    }
                }
            }
            if (descend) {
                row = link;
                vmask = kFullMask;
            } else if (sp > 0) {
                --sp;
                int r = stack_row[0];
                unsigned mm = stack_mask[0];
#pragma unroll
                for (int s = 1; s < kSlots; ++s)
                    if (sp / kGroup == (unsigned)s) {
                        r = stack_row[s];
                        mm = stack_mask[s];
                    }
                r = __shfl_sync(gmask, r, sp % kGroup, kGroup);
                mm = __shfl_sync(gmask, mm, sp % kGroup, kGroup);
                const bool in_stack = sp < (unsigned)tab.depth;
                row = in_stack ? r : 0;
                vmask = in_stack ? mm : 0u;
                if (INSTANCED && inst_cur >= 0 && (int)sp < inst_sp) {
                    // popped below the instance's entry: the world ray again
                    inst_cur = -1;
                    o = rt::V3{__ldg(o_in + 3 * i), __ldg(o_in + 3 * i + 1),
                               __ldg(o_in + 3 * i + 2)};
                    d = rt::V3{__ldg(d_in + 3 * i), __ldg(d_in + 3 * i + 1),
                               __ldg(d_in + 3 * i + 2)};
                    ix = inv_dir(d.x);
                    iy = inv_dir(d.y);
                    iz = inv_dir(d.z);
                }
            } else {
                break;
            }
            if (ANY_HIT && prim >= 0) break;
        }
    }
    if (k == 0) {
        const bool hit = prim >= 0;
        hit_out[i] = hit;
        t_out[i] = hit ? t_best : rt::kInf;
        prim_out[i] = hit ? prim : 0;
        if (INSTANCED || ALPHA) inst_out[i] = hit ? inst_best : -1;
    }
}

// At least 8 blocks an SM (at most 64 registers): left free, ptxas took 48
// registers and spilled 4 bytes to an 8-byte stack frame; with the bound it
// takes 55 and spills nothing.
template <bool ANY_HIT, bool INSTANCED, bool ALPHA>
__global__ void __launch_bounds__(kThreads, 8)
    traverse16_kernel(Table tab, Alpha al, const float* __restrict__ o_in,
                      const float* __restrict__ d_in, const float* __restrict__ t_max, int n,
                      bool* __restrict__ hit_out, float* __restrict__ t_out,
                      int* __restrict__ prim_out, int* __restrict__ inst_out,
                      unsigned long long* __restrict__ counts, unsigned* __restrict__ next_ray) {
    __shared__ unsigned long long block_counts[2];
    if (counts != nullptr) {
        if (threadIdx.x < 2) block_counts[threadIdx.x] = 0;
        __syncthreads();
    }
    const int lane = threadIdx.x & 31;
    const int k = lane & (kGroup - 1);  // lane within the group
    const int gbase = lane & ~(kGroup - 1);
    const unsigned gmask = kFullMask << gbase;
    // every group fetches once past the last ray; the launch's final fetch,
    // n + groups - 1, is the counter's last use and leaves it at 0
    const unsigned last = (unsigned)n + gridDim.x * (kThreads / kGroup) - 1u;
    auto fetch = [&]() {
        unsigned got = 0;
        if (k == 0) {
            got = atomicAdd(next_ray, 1u);
            if (got == last) atomicExch(next_ray, 0u);
        }
        return __shfl_sync(gmask, got, 0, kGroup);
    };
    unsigned rows = 0, tests = 0;
    for (unsigned i = fetch(); i < (unsigned)n; i = fetch())
        walk<ANY_HIT, INSTANCED, ALPHA>(tab, al, o_in, d_in, t_max, (int)i, k, gbase, gmask,
                                        hit_out, t_out, prim_out, inst_out, &rows, &tests);
    if (counts != nullptr) {
        // every lane of a group holds its group's sums: take lane 0's
        unsigned long long a = k == 0 ? rows : 0, b = k == 0 ? tests : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            a += __shfl_xor_sync(~0u, a, off);
            b += __shfl_xor_sync(~0u, b, off);
        }
        if (lane == 0) {
            atomicAdd(block_counts, a);
            atomicAdd(block_counts + 1, b);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            atomicAdd(counts, block_counts[0]);
            atomicAdd(counts + 1, block_counts[1]);
        }
    }
}

template <bool ANY_HIT, bool INSTANCED, bool ALPHA>
int launch(const void* table, int n_rows, const void* roots, int depth, const void* o,
           const void* d, const void* t_max, int n, void* hit, void* t, void* prim, void* inst,
           void* counts, void* next_ray, const Alpha& al, void* stream) {
    auto kernel = traverse16_kernel<ANY_HIT, INSTANCED, ALPHA>;
    // as many blocks as the card holds at once (per device ordinal and
    // instantiation), or one group per ray if that is fewer
    static int resident[16] = {0};
    int dev = 0;
    cudaGetDevice(&dev);
    int& fit = resident[dev & 15];
    if (fit == 0) {
        int sms = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
        fit = sms * per_sm;
    }
    const size_t per_ray = ((size_t)n * kGroup + kThreads - 1) / kThreads;
    const int blocks = per_ray < (size_t)fit ? (int)per_ray : fit;
    Table tab{(const float*)table, n_rows, (const int*)roots, depth};
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        tab, al, (const float*)o, (const float*)d, (const float*)t_max, n, (bool*)hit, (float*)t,
        (int*)prim, (int*)inst, (unsigned long long*)counts, (unsigned*)next_ray);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_traverse16_closest(const void* table, int n_rows, const void* roots, int depth,
                                     const void* o, const void* d, const void* t_max, int n,
                                     void* hit, void* t, void* prim, void* counts,
                                     void* next_ray, void* stream) {
    return launch<false, false, false>(table, n_rows, roots, depth, o, d, t_max, n, hit, t, prim,
                                       nullptr, counts, next_ray, Alpha{}, stream);
}

extern "C" int rt_traverse16_any(const void* table, int n_rows, const void* roots, int depth,
                                 const void* o, const void* d, const void* t_max, int n,
                                 void* hit, void* t, void* prim, void* counts, void* next_ray,
                                 void* stream) {
    return launch<true, false, false>(table, n_rows, roots, depth, o, d, t_max, n, hit, t, prim,
                                      nullptr, counts, next_ray, Alpha{}, stream);
}

// the instanced, alpha and instanced-alpha walks: the same arguments, then
// the instance output and the alpha tables (null without alpha)
#define RT_TRAVERSE16_EXT(NAME, ANY_HIT, INSTANCED, ALPHA)                                      \
    extern "C" int NAME(const void* table, int n_rows, const void* roots, int depth,             \
                        const void* o, const void* d, const void* t_max, int n, void* hit,       \
                        void* t, void* prim, void* inst, void* counts, void* next_ray,           \
                        const void* t_shade, const void* alpha_tex,                              \
                        const void* shadow_alpha_tex, const void* atlas, const void* meta,       \
                        void* stream) {                                                          \
        Alpha al{(const float*)t_shade, (const int*)alpha_tex, (const int*)shadow_alpha_tex,     \
                 (const float*)atlas, (const int*)meta};                                         \
        return launch<ANY_HIT, INSTANCED, ALPHA>(table, n_rows, roots, depth, o, d, t_max, n,    \
                                                 hit, t, prim, inst, counts, next_ray, al,       \
                                                 stream);                                        \
    }

RT_TRAVERSE16_EXT(rt_traverse16_inst_closest, false, true, false)
RT_TRAVERSE16_EXT(rt_traverse16_inst_any, true, true, false)
RT_TRAVERSE16_EXT(rt_traverse16_alpha_closest, false, false, true)
RT_TRAVERSE16_EXT(rt_traverse16_alpha_any, true, false, true)
RT_TRAVERSE16_EXT(rt_traverse16_inst_alpha_closest, false, true, true)
RT_TRAVERSE16_EXT(rt_traverse16_inst_alpha_any, true, true, true)
