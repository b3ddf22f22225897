// K1: closest-hit and any-hit traversal of the 16-wide BVH, one thread per
// ray (one template, ANY_HIT flag).
//
// Replaces rustracer_tpu/accel/traverse16.py: the non-instanced _make_body
// (:137) with _interior_hits (:76) and _leaf_hits (:108), the outer loops
// _traverse16 (:432) and _traverse16_regen (:282), and the watertight test
// of rustracer_tpu/ops/triangle.py:80 (common.cuh tri_intersect). Table
// layout: rustracer_tpu/accel/wide.py (128-float interior / leaf records).
//
// The walk is the reference's step for step, so hits and the observed
// counts agree with it: each step reads one 512-byte record; an interior
// record gives 16 slab tests against the current t_best and descends to the
// nearest unvisited hit child (children are pre-sorted per ray octant),
// pushing (row, remaining mask); a leaf record gives 8 watertight triangle
// tests (the lowest index wins a tie, as argmin does); then it pops, and a
// popped record is read again and its boxes re-tested against the tightened
// t_best. The TPU loops' regeneration window and majority+drain passes only
// refill idle vector lanes and give bit-identical results; with one thread
// per ray they have no counterpart here.
//
// Bound: dependent, incoherent 512-byte record reads (latency of the L2 and
// device memory), not arithmetic. This first version keeps the stack in
// local memory and relies on many resident warps to hide that latency;
// persistent threads and a wider per-warp schedule are later work.
#include "common.cuh"

namespace {

constexpr int kRec = 128;
constexpr int kMaxDepth = 32;  // the wrapper refuses deeper tables
constexpr unsigned kFullMask = 0xFFFFu;

__device__ __forceinline__ float inv_dir(float c) {
    float safe = fabsf(c) < 1e-20f ? (c < 0.0f ? -1e-20f : 1e-20f) : c;
    return 1.0f / safe;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(128)
    traverse16_kernel(const float* __restrict__ table, int n_rows, const int* __restrict__ roots,
                      int depth, const float* __restrict__ o_in, const float* __restrict__ d_in,
                      const float* __restrict__ t_max, int n, bool* __restrict__ hit_out,
                      float* __restrict__ t_out, int* __restrict__ prim_out,
                      unsigned long long* __restrict__ counts) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    rt::V3 o = rt::load3(o_in + 3 * i);
    rt::V3 d = rt::load3(d_in + 3 * i);
    float ix = inv_dir(d.x), iy = inv_dir(d.y), iz = inv_dir(d.z);
    int octant = (d.x < 0.0f ? 1 : 0) | (d.y < 0.0f ? 2 : 0) | (d.z < 0.0f ? 4 : 0);
    float t_best = t_max[i];
    bool done = t_best <= 0.0f;  // dead lanes start done
    int prim = -1;
    int row = roots[octant];
    unsigned vmask = kFullMask;
    int sp = 0;
    int stack_row[kMaxDepth];
    unsigned stack_mask[kMaxDepth];
    unsigned rows = 0, tests = 0;

    while (!done) {
        ++rows;
        const float* rec = table + (size_t)min(max(row, 0), n_rows - 1) * kRec;
        int tag = __float_as_int(rec[0]);
        bool descend = false;
        int link = 0;
        if (tag < 0) {
            // leaf: up to 8 triangles, vertices component-major in blocks of 8
            float cand_t = rt::kInf;
            int cand = -1;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                int tid = __float_as_int(rec[1 + j]);
                if (tid < 0) continue;
                ++tests;
                rt::TriHit th = rt::tri_intersect(
                    o, d, t_best, rt::V3{rec[9 + j], rec[17 + j], rec[25 + j]},
                    rt::V3{rec[33 + j], rec[41 + j], rec[49 + j]},
                    rt::V3{rec[57 + j], rec[65 + j], rec[73 + j]});
                if (th.hit && th.t < cand_t) {
                    cand_t = th.t;
                    cand = tid;
                }
            }
            if (cand >= 0 && cand_t < t_best) {
                t_best = cand_t;
                prim = cand;
            }
        } else {
            // interior: 16 slab tests, words 17..113 component-major
            unsigned m = 0;
#pragma unroll 4
            for (int k = 0; k < 16; ++k) {
                if (!((vmask >> k) & 1u)) continue;
                float t0x = (rec[17 + k] - o.x) * ix, t1x = (rec[65 + k] - o.x) * ix;
                float t0y = (rec[33 + k] - o.y) * iy, t1y = (rec[81 + k] - o.y) * iy;
                float t0z = (rec[49 + k] - o.z) * iz, t1z = (rec[97 + k] - o.z) * iz;
                float t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
                float t_far =
                    fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) * 1.00000024f;
                if (t_near <= t_far && t_far > 0.0f && t_near < t_best &&
                    __float_as_int(rec[1 + k]) >= 0)
                    m |= 1u << k;
            }
            if (m != 0) {
                descend = true;
                int slot = __ffs(m) - 1;  // nearest unvisited hit child
                link = __float_as_int(rec[1 + slot]);
                unsigned rest = m & (m - 1u);
                if (rest != 0) {
                    if (sp < depth) {
                        stack_row[sp] = row;
                        stack_mask[sp] = rest;
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
            row = sp < depth ? stack_row[sp] : 0;
            vmask = sp < depth ? stack_mask[sp] : 0u;
        } else {
            done = true;
        }
        if (ANY_HIT && prim >= 0) done = true;
    }
    bool hit = prim >= 0;
    hit_out[i] = hit;
    t_out[i] = hit ? t_best : rt::kInf;
    prim_out[i] = hit ? prim : 0;
    if (counts != nullptr) {
        atomicAdd(counts, (unsigned long long)rows);
        atomicAdd(counts + 1, (unsigned long long)tests);
    }
}

template <bool ANY_HIT>
int launch(const void* table, int n_rows, const void* roots, int depth, const void* o,
           const void* d, const void* t_max, int n, void* hit, void* t, void* prim, void* counts,
           void* stream) {
    constexpr int kThreads = 128;
    traverse16_kernel<ANY_HIT><<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)table, n_rows, (const int*)roots, depth, (const float*)o, (const float*)d,
        (const float*)t_max, n, (bool*)hit, (float*)t, (int*)prim, (unsigned long long*)counts);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_traverse16_closest(const void* table, int n_rows, const void* roots, int depth,
                                     const void* o, const void* d, const void* t_max, int n,
                                     void* hit, void* t, void* prim, void* counts, void* stream) {
    return launch<false>(table, n_rows, roots, depth, o, d, t_max, n, hit, t, prim, counts,
                         stream);
}

extern "C" int rt_traverse16_any(const void* table, int n_rows, const void* roots, int depth,
                                 const void* o, const void* d, const void* t_max, int n,
                                 void* hit, void* t, void* prim, void* counts, void* stream) {
    return launch<true>(table, n_rows, roots, depth, o, d, t_max, n, hit, t, prim, counts,
                        stream);
}
