// K14: the closest hit (quadric_closest) and any hit (quadric_any) of each
// ray over every quadric of the scene, brute force, one thread per lane.
//
// Replaces rustracer_tpu/scene/tables.py intersect_quadrics_all (:234) with
// ops/quadrics.py quadric_hit_t (:230) and its _sphere_hit_t,
// _cylinder_hit_t and _disk_hit_t (:167-228). A thread walks the Q quadrics
// in ascending order: the ray goes to object space through rows 0-2 of the
// quadric's world-to-object matrix in the reference's component form
// (tables.py:253-258), the hit test of its type runs with the best t so far
// as t_max, and a hit with t < t_best (strict, so the first of two equal
// hits wins) becomes the best. Outputs as :272-274 returns them: hit, t
// (INF on a miss), qid (0 on a miss). The any-hit entry point tests each
// quadric against the ray's own t_max and stops at the first hit: a ray
// hits some quadric below t_max exactly when the closest walk finds one.
//
// Bound: operations. A lane reads its ray (28 bytes) and writes 9 bytes;
// per quadric it does the 33 operations of the transform and 40-70 of the
// test (sqrtf, a divide, atan2f on clipped quadrics). The tables (17
// words a quadric) are read with the same address by every thread of a warp, so each
// read is one broadcast from L1; a scene holds a few dozen quadrics at
// most, so no staging is needed.
#include "quadrics.cuh"

namespace {

using rt::V3;

struct Quadric {
    int type;
    rt::QParams q;
};

__device__ __forceinline__ Quadric load_quadric(const int* __restrict__ q_type,
                                                const float* __restrict__ q_params, int i) {
    const float* p = q_params + 4 * i;
    return {__ldg(q_type + i), {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)}};
}

// the ray in quadric i's object space (rows 0-2 of its w2o, (Q, 4, 4))
__device__ __forceinline__ void object_ray(const float* __restrict__ w2o, int i, V3 o, V3 d,
                                           V3* oc, V3* dc) {
    const float* m = w2o + 16 * i;
    float m00 = __ldg(m), m01 = __ldg(m + 1), m02 = __ldg(m + 2), m03 = __ldg(m + 3);
    float m10 = __ldg(m + 4), m11 = __ldg(m + 5), m12 = __ldg(m + 6), m13 = __ldg(m + 7);
    float m20 = __ldg(m + 8), m21 = __ldg(m + 9), m22 = __ldg(m + 10), m23 = __ldg(m + 11);
    *oc = {m00 * o.x + m01 * o.y + m02 * o.z + m03, m10 * o.x + m11 * o.y + m12 * o.z + m13,
           m20 * o.x + m21 * o.y + m22 * o.z + m23};
    *dc = {m00 * d.x + m01 * d.y + m02 * d.z, m10 * d.x + m11 * d.y + m12 * d.z,
           m20 * d.x + m21 * d.y + m22 * d.z};
}

__global__ void quadric_closest_kernel(const int* __restrict__ q_type,
                                       const float* __restrict__ q_w2o,
                                       const float* __restrict__ q_params, int nq,
                                       const float* __restrict__ o_in,
                                       const float* __restrict__ d_in,
                                       const float* __restrict__ t_max_in, int n,
                                       bool* __restrict__ hit_out, float* __restrict__ t_out,
                                       int* __restrict__ qid_out) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    V3 o = rt::load3(o_in + 3 * lane), d = rt::load3(d_in + 3 * lane);
    float t_best = t_max_in[lane];
    int qid = -1;
    for (int i = 0; i < nq; ++i) {
        Quadric qu = load_quadric(q_type, q_params, i);
        V3 oc, dc;
        object_ray(q_w2o, i, o, d, &oc, &dc);
        rt::HitT h = rt::quadric_hit_t(qu.type, oc, dc, t_best, qu.q);
        if (h.hit && h.t < t_best) {
            t_best = h.t;
            qid = i;
        }
    }
    bool hit = qid >= 0;
    hit_out[lane] = hit;
    t_out[lane] = hit ? t_best : rt::kInf;
    qid_out[lane] = hit ? qid : 0;
}

__global__ void quadric_any_kernel(const int* __restrict__ q_type,
                                   const float* __restrict__ q_w2o,
                                   const float* __restrict__ q_params, int nq,
                                   const float* __restrict__ o_in,
                                   const float* __restrict__ d_in,
                                   const float* __restrict__ t_max_in, int n,
                                   bool* __restrict__ hit_out) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    V3 o = rt::load3(o_in + 3 * lane), d = rt::load3(d_in + 3 * lane);
    float t_max = t_max_in[lane];
    bool hit = false;
    for (int i = 0; i < nq && !hit; ++i) {
        Quadric qu = load_quadric(q_type, q_params, i);
        V3 oc, dc;
        object_ray(q_w2o, i, o, d, &oc, &dc);
        hit = rt::quadric_hit_t(qu.type, oc, dc, t_max, qu.q).hit;
    }
    hit_out[lane] = hit;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int rt_quadric_closest(const void* q_type, const void* q_w2o, const void* q_params,
                                  int nq, const void* o, const void* d, const void* t_max, int n,
                                  void* hit, void* t, void* qid, void* stream) {
    quadric_closest_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)q_type, (const float*)q_w2o, (const float*)q_params, nq, (const float*)o,
        (const float*)d, (const float*)t_max, n, (bool*)hit, (float*)t, (int*)qid);
    return (int)cudaGetLastError();
}

extern "C" int rt_quadric_any(const void* q_type, const void* q_w2o, const void* q_params,
                              int nq, const void* o, const void* d, const void* t_max, int n,
                              void* hit, void* stream) {
    quadric_any_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)q_type, (const float*)q_w2o, (const float*)q_params, nq, (const float*)o,
        (const float*)d, (const float*)t_max, n, (bool*)hit);
    return (int)cudaGetLastError();
}
