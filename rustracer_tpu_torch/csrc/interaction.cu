// K2: rebuild the surface interaction of each closest hit: a triangle hit
// from its packed (T, 32) t_shade row, a quadric hit (a sphere, cylinder or
// disk) from its quadric's tables.
//
// Replaces rustracer_tpu/scene/tables.py build_interaction (:549-707).
// Triangle lanes (prim >= nq): one row read per lane, the watertight
// re-intersection at t*1.0001+1e-4 (:610) for the barycentrics, then p and
// its error bound, uv (the default uv when the row has none), the geometric
// normal with the reverse flip, the interpolated shading normal and the
// face-forward, dpdu/dpdv, dndu/dndv, the material and area-light ids
// (bitcast words 25/26). Quadric lanes (prim < nq, the branch of :556-595
// with ops/quadrics.py quadric_intersect :245): the ray in the quadric's
// object space, the full hit of its type (quadrics.cuh) re-intersected at
// t*1.0001+1e-4, p through o2w with the conservative error bound
// e1 + gamma(3) (e2 + |translation|), the normal cross(dpdu, dpdv) with the
// reverse flip, dndu/dndv from the closed forms (dp/r on a sphere, dp/du / r
// on a cylinder, 0 on a disk) through the inverse transpose. Both then take
// the shading frame, and miss lanes the placeholders (:684-698). Every
// lane's arithmetic is the same in each kernel below, so their outputs
// agree bit for bit.
//
// Bound: the dependent 128-byte row read per lane and the 15 output
// streams (about 150 bytes written per lane); the arithmetic (some 300 flops
// a triangle lane, some 400 and acosf, sinf, atan2f a sphere lane) stays in
// registers. Outputs are struct-of-arrays, one thread a lane in lane order,
// so that each stream is written in whole sectors. Two kernels:
// - a scene whose one quadric row is the never-hit dummy takes
//   build_interaction_kernel, without the quadric branch (with it,
//   triangle lanes took 4-6% longer: tools/bench_step_kernels.py
//   --kernels K2);
// - a scene with quadrics takes build_interaction_kernel_quadrics. There,
//   one thread a lane ran the miss, quadric and triangle paths of a mixed
//   warp one after another, each path ending in its own 15 stores, so
//   each stream was written up to three times a warp, in part; the stores
//   held half the time (tools/k2_parts.py). So each path leaves its
//   surface in registers and every lane then stores once (the glass
//   step's bounce 1 1.6x, the 16-quadric table 1.9x). Measured and not
//   kept: the lanes of a block ordered by kind in shared memory, each
//   warp on one path (their stores staged through shared memory to stay
//   whole sectors) ran 1.07-1.16x slower than the one store sequence on
//   the testball steps (4% faster on the 16-quadric table); the
//   quadric rows staged in shared memory a block ran 1-3% slower than
//   the read-only path. sinf's slow path (arguments beyond the range of
//   theta in [0, pi]) keeps a 32-byte stack frame that no lane reaches.
// On the dragon's bounce hits (misses and triangles) the one store
// sequence also ran 1.5x faster, but 10% slower on its camera hits (all
// triangles), so the triangle-only kernel keeps its two.
#include "quadrics.cuh"

namespace {

using rt::V3;

struct Quadrics {
    const int* type;
    const float *o2w, *w2o, *params;  // (Q, 4, 4), (Q, 4, 4), (Q, 4)
    const int *material, *arealight;
    const bool* reverse;
};

// the hits' instances and the instance tables (rustracer_tpu/accel/wide.py)
struct Instances {
    const int* inst;
    const float *o2w, *w2o;  // (I, 4, 4)
    const bool* flip;
};

struct Outs {
    float *p, *p_error, *n, *uv, *dpdu, *dpdv, *ns, *ss, *ts, *dndu, *dndv, *wo;
    int *material, *arealight, *prim_id;
};

__device__ __forceinline__ V3 bary(float b0, float b1, float b2, V3 a, V3 b, V3 c) {
    return {b0 * a.x + b1 * b.x + b2 * c.x, b0 * a.y + b1 * b.y + b2 * c.y,
            b0 * a.z + b1 * b.z + b2 * c.z};
}

__device__ __forceinline__ V3 rows3(const float* m, V3 v) {
    return {m[0] * v.x + m[1] * v.y + m[2] * v.z, m[4] * v.x + m[5] * v.y + m[6] * v.z,
            m[8] * v.x + m[9] * v.y + m[10] * v.z};
}

// core/transform.py xform_point: rows 0-2 and the divide by w
__device__ __forceinline__ V3 xform_point(const float* m, V3 p) {
    V3 r = rows3(m, p);
    float w = m[12] * p.x + m[13] * p.y + m[14] * p.z + m[15];
    float inv_w = 1.0f / w;
    return {(r.x + m[3]) * inv_w, (r.y + m[7]) * inv_w, (r.z + m[11]) * inv_w};
}

// core/transform.py xform_normal: the columns of the inverse
__device__ __forceinline__ V3 xform_normal(const float* m_inv, V3 n) {
    return {m_inv[0] * n.x + m_inv[4] * n.y + m_inv[8] * n.z,
            m_inv[1] * n.x + m_inv[5] * n.y + m_inv[9] * n.z,
            m_inv[2] * n.x + m_inv[6] * n.y + m_inv[10] * n.z};
}

__device__ __forceinline__ V3 abs3(V3 v) { return {fabsf(v.x), fabsf(v.y), fabsf(v.z)}; }

// a quadric's table row (QUADRIC_KEYS)
struct QRow {
    float o2w[16], w2o[16];
    float params[4];
    int type, material, arealight, reverse;
};

// quadric q's row from the tables, through the read-only path
__device__ __forceinline__ QRow load_row(const Quadrics& qs, int q) {
    QRow r;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        r.o2w[k] = __ldg(qs.o2w + 16 * q + k);
        r.w2o[k] = __ldg(qs.w2o + 16 * q + k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) r.params[k] = __ldg(qs.params + 4 * q + k);
    r.type = __ldg(qs.type + q);
    r.material = __ldg(qs.material + q);
    r.arealight = __ldg(qs.arealight + q);
    r.reverse = qs.reverse[q];
    return r;
}

// a lane's surface: what K2 writes, but wo and the id
struct Surface {
    V3 p, p_error, n, ns, ss, ts, dpdu, dpdv, dndu, dndv;
    float u, v;
    int material, arealight;
};

__device__ __forceinline__ V3 finite_or_zero(V3 v) {
    return {isfinite(v.x) ? v.x : 0.0f, isfinite(v.y) ? v.y : 0.0f, isfinite(v.z) ? v.z : 0.0f};
}

// core/interaction.py make_shading_frame
__device__ __forceinline__ void shading_frame(V3 ns, V3 dpdu, V3* ss, V3* ts) {
    *ss = rt::normalize(dpdu - rt::dot(dpdu, ns) * ns);
    if (rt::dot(*ss, *ss) < 1e-12f) {
        V3 unused;
        rt::coordinate_system(ns, ss, &unused);
    }
    *ts = rt::cross(ns, *ss);
}

// a miss lane's placeholders (tables.py :684-698)
__device__ __forceinline__ Surface miss_surface(V3 o) {
    Surface s;
    s.p = o;
    s.p_error = {0.0f, 0.0f, 0.0f};
    s.n = s.ns = {0.0f, 0.0f, 1.0f};
    s.ss = s.dpdu = {1.0f, 0.0f, 0.0f};
    s.ts = s.dpdv = {0.0f, 1.0f, 0.0f};
    s.dndu = s.dndv = {0.0f, 0.0f, 0.0f};
    s.u = s.v = 0.0f;
    s.material = s.arealight = -1;
    return s;
}

// the quadric branch of tables.py build_interaction (:556-595) for a lane
// that hit the quadric of row q: world-space p, error, uv, dpdu/dpdv,
// normal and dndu/dndv, the shading frame. Inlined, the row by value: an
// out-of-line call (a 208-byte stack frame) made every lane 1.6x slower
__device__ __forceinline__ Surface quadric_surface(const QRow& q, V3 o, V3 d, float t) {
    rt::QParams qp{q.params[0], q.params[1], q.params[2], q.params[3]};
    rt::QuadricHit qh = rt::quadric_intersect(q.type, xform_point(q.w2o, o), rows3(q.w2o, d),
                                              t * 1.0001f + 1e-4f, qp);
    Surface s;
    s.p = xform_point(q.o2w, qh.p);
    // conservative world-space error: |M| err + gamma(3) (|M| |p| + |trans|)
    float abs_m[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) abs_m[k] = fabsf(q.o2w[k]);
    V3 e1 = rows3(abs_m, qh.p_error), e2 = rows3(abs_m, abs3(qh.p));
    s.p_error = {e1.x + rt::kGamma3 * (e2.x + abs_m[3]), e1.y + rt::kGamma3 * (e2.y + abs_m[7]),
                 e1.z + rt::kGamma3 * (e2.z + abs_m[11])};
    s.dpdu = rows3(q.o2w, qh.dpdu);
    s.dpdv = rows3(q.o2w, qh.dpdv);
    s.n = rt::normalize(rt::cross(s.dpdu, s.dpdv));
    // dn/du = dp/du / r except on a disk, dn/dv = dp/dv / r on a sphere only
    float inv_r = 1.0f / fmaxf(qp.r0, 1e-8f);
    float ku = q.type == rt::kDisk ? 0.0f : inv_r;
    float kv = q.type == rt::kSphere ? inv_r : 0.0f;
    s.dndu = xform_normal(q.w2o, qh.dpdu * ku);
    s.dndv = xform_normal(q.w2o, qh.dpdv * kv);
    if (q.reverse) {
        s.n = -s.n;
        s.dndu = -s.dndu;
        s.dndv = -s.dndv;
    }
    s.ns = s.n;
    shading_frame(s.n, s.dpdu, &s.ss, &s.ts);
    s.u = qh.u;
    s.v = qh.v;
    s.material = q.material;
    s.arealight = q.arealight;
    return s;
}

// the triangle branch (:597-683) for a lane that hit triangle prim - nq
// (of instance is.inst[i] where kInstances)
template <bool kInstances>
__device__ __forceinline__ Surface triangle_surface(const float* __restrict__ t_shade, int n_tris,
                                                    int nq, const Instances& is, int i, int prim,
                                                    V3 o, V3 d, float t) {
    int tid = min(max(prim - nq, 0), n_tris - 1);
    const float* rec = t_shade + (size_t)tid * 32;
    V3 p0 = rt::load3(rec), p1 = rt::load3(rec + 3), p2 = rt::load3(rec + 6);
    // an instanced hit's vertices move to world space before the test (the
    // normals after it, as late as the triangle-only kernel loads them)
    const int inst = kInstances ? is.inst[i] : -1;
    if (kInstances && inst >= 0) {
        float m[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) m[k] = is.o2w[16 * inst + k];
        p0 = xform_point(m, p0);
        p1 = xform_point(m, p1);
        p2 = xform_point(m, p2);
    }
    rt::TriHit th = rt::tri_intersect(o, d, t * 1.0001f + 1e-4f, p0, p1, p2);
    float b0 = th.b0, b1 = th.b1, b2 = th.b2;
    int flags = __float_as_int(rec[24]);
    bool has_uv = flags & 1, has_n = flags & 2, rev = flags & 4;
    if (kInstances && inst >= 0) rev = rev != is.flip[inst];
    float u0 = has_uv ? rec[18] : 0.0f, v0 = has_uv ? rec[19] : 0.0f;
    float u1 = has_uv ? rec[20] : 1.0f, v1 = has_uv ? rec[21] : 0.0f;
    float u2 = has_uv ? rec[22] : 1.0f, v2 = has_uv ? rec[23] : 1.0f;

    Surface s;
    // point and its gamma(7) error bound (ops/triangle.py triangle_point_error)
    s.p = bary(b0, b1, b2, p0, p1, p2);
    V3 q0 = b0 * p0, q1 = b1 * p1, q2 = b2 * p2;
    V3 abs_sum = {fabsf(q0.x) + fabsf(q1.x) + fabsf(q2.x), fabsf(q0.y) + fabsf(q1.y) + fabsf(q2.y),
                  fabsf(q0.z) + fabsf(q1.z) + fabsf(q2.z)};
    s.p_error = rt::kGamma7 * abs_sum;
    s.u = b0 * u0 + b1 * u1 + b2 * u2;
    s.v = b0 * v0 + b1 * v1 + b2 * v2;

    // dpdu/dpdv (ops/triangle.py triangle_partial_derivs)
    float du02 = u0 - u2, dv02 = v0 - v2, du12 = u1 - u2, dv12 = v1 - v2;
    V3 dp02 = p0 - p2, dp12 = p1 - p2;
    float det = du02 * dv12 - dv02 * du12;
    bool degenerate = fabsf(det) < 1e-12f;
    float inv = 1.0f / (degenerate ? 1.0f : det);
    s.dpdu = (dv12 * dp02 - dv02 * dp12) * inv;
    s.dpdv = (-du12 * dp02 + du02 * dp12) * inv;
    if (degenerate)
        rt::coordinate_system(rt::normalize(rt::cross(p2 - p0, p1 - p0)), &s.dpdu, &s.dpdv);

    // normals
    V3 ng = rt::normalize(rt::cross(p0 - p2, p1 - p2));
    if (rev) ng = -ng;
    V3 nv0 = rt::load3(rec + 9), nv1 = rt::load3(rec + 12), nv2 = rt::load3(rec + 15);
    if (kInstances && inst >= 0) {
        float m[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) m[k] = is.w2o[16 * inst + k];
        nv0 = xform_normal(m, nv0);
        nv1 = xform_normal(m, nv1);
        nv2 = xform_normal(m, nv2);
    }
    V3 n_interp = rt::normalize(bary(b0, b1, b2, nv0, nv1, nv2));
    if (rev) n_interp = -n_interp;
    s.ns = has_n ? n_interp : ng;
    if (has_n && rt::dot(ng, s.ns) < 0.0f) ng = -ng;
    s.n = ng;

    // dndu/dndv (ops/triangle.py triangle_normal_derivs), zero without normals
    s.dndu = {0.0f, 0.0f, 0.0f};
    s.dndv = {0.0f, 0.0f, 0.0f};
    if (has_n && !degenerate) {
        V3 dn02 = nv0 - nv2, dn12 = nv1 - nv2;
        s.dndu = (dv12 * dn02 - dv02 * dn12) * inv;
        s.dndv = (-du12 * dn02 + du02 * dn12) * inv;
        if (rev) {
            s.dndu = -s.dndu;
            s.dndv = -s.dndv;
        }
    }
    shading_frame(s.ns, s.dpdu, &s.ss, &s.ts);
    s.material = __float_as_int(rec[25]);
    s.arealight = __float_as_int(rec[26]);
    return s;
}

// lane i's 14 outputs but wo, in one sequence of stores
__device__ __forceinline__ void store_surface(const Outs& out, int i, const Surface& s,
                                              int prim_id) {
    rt::store3(out.p + 3 * i, s.p);
    rt::store3(out.p_error + 3 * i, s.p_error);
    rt::store3(out.n + 3 * i, s.n);
    rt::store3(out.ns + 3 * i, s.ns);
    rt::store3(out.ss + 3 * i, s.ss);
    rt::store3(out.ts + 3 * i, s.ts);
    out.uv[2 * i] = s.u;
    out.uv[2 * i + 1] = s.v;
    rt::store3(out.dpdu + 3 * i, s.dpdu);
    rt::store3(out.dpdv + 3 * i, s.dpdv);
    rt::store3(out.dndu + 3 * i, finite_or_zero(s.dndu));
    rt::store3(out.dndv + 3 * i, finite_or_zero(s.dndv));
    out.material[i] = s.material;
    out.arealight[i] = s.arealight;
    out.prim_id[i] = prim_id;
}

// lane i's surface by its path (a miss, its quadric's, its triangle's);
// *prim becomes -1 on a miss
template <bool kInstances>
__device__ __forceinline__ Surface surface(const float* __restrict__ t_shade, int n_tris, int nq,
                                           const Quadrics& qs, const Instances& is,
                                           const float* __restrict__ o_in, V3 d,
                                           const bool* __restrict__ hit_in,
                                           const float* __restrict__ t_in, int i, int* prim) {
    V3 o = rt::load3(o_in + 3 * i);
    float t = t_in[i];
    if (!hit_in[i]) {
        *prim = -1;
        return miss_surface(o);
    }
    if (*prim < nq) return quadric_surface(load_row(qs, min(max(*prim, 0), nq - 1)), o, d, t);
    return triangle_surface<kInstances>(t_shade, n_tris, nq, is, i, *prim, o, d, t);
}

// a scene without a real quadric: a miss lane stores its placeholders, a
// triangle lane its surface
template <bool kInstances>
__global__ void build_interaction_kernel(const float* __restrict__ t_shade, int n_tris, int nq,
                                         Instances is, const float* __restrict__ o_in,
                                         const float* __restrict__ d_in,
                                         const bool* __restrict__ hit_in,
                                         const float* __restrict__ t_in,
                                         const int* __restrict__ prim_in, int n, Outs out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    V3 o = rt::load3(o_in + 3 * i);
    V3 d = rt::load3(d_in + 3 * i);
    bool hit = hit_in[i];
    int prim = prim_in[i];
    float t = t_in[i];
    rt::store3(out.wo + 3 * i, rt::normalize(-d));
    if (!hit) {
        store_surface(out, i, miss_surface(o), -1);
        return;
    }
    store_surface(out, i, triangle_surface<kInstances>(t_shade, n_tris, nq, is, i, prim, o, d, t),
                  prim);
}

// a scene with quadrics: each lane's path leaves its surface in
// registers, then one sequence of stores for every path
template <bool kInstances>
__global__ void build_interaction_kernel_quadrics(
    const float* __restrict__ t_shade, int n_tris, int nq, Quadrics qs, Instances is,
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    const bool* __restrict__ hit_in, const float* __restrict__ t_in,
    const int* __restrict__ prim_in, int n, Outs out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    V3 d = rt::load3(d_in + 3 * i);
    int prim = prim_in[i];
    rt::store3(out.wo + 3 * i, rt::normalize(-d));
    store_surface(out, i,
                  surface<kInstances>(t_shade, n_tris, nq, qs, is, o_in, d, hit_in, t_in, i,
                                      &prim),
                  prim);
}

template <bool kInstances>
int launch(const void* t_shade, int n_tris, int nq, int with_quadrics, const Quadrics& qs,
           const Instances& is, const void* o, const void* d, const void* hit, const void* t,
           const void* prim, int n, const Outs& out, void* stream) {
    constexpr int kThreads = 128;
    auto s = (cudaStream_t)stream;
    auto tab = (const float*)t_shade;
    auto oo = (const float*)o, dd = (const float*)d, tt = (const float*)t;
    auto hh = (const bool*)hit;
    auto pp = (const int*)prim;
    int blocks = rt::blocks_for(n, kThreads);
    if (with_quadrics)
        build_interaction_kernel_quadrics<kInstances>
            <<<blocks, kThreads, 0, s>>>(tab, n_tris, nq, qs, is, oo, dd, hh, tt, pp, n, out);
    else
        build_interaction_kernel<kInstances>
            <<<blocks, kThreads, 0, s>>>(tab, n_tris, nq, is, oo, dd, hh, tt, pp, n, out);
    return (int)cudaGetLastError();
}

}  // namespace

#define RT_BUILD_INTERACTION_ARGS                                                               \
    const void *t_shade, int n_tris, int nq, int with_quadrics, const void *q_type,              \
        const void *q_o2w, const void *q_w2o, const void *q_params, const void *q_material,      \
        const void *q_arealight, const void *q_reverse, const void *o, const void *d,           \
        const void *t_max, const void *hit, const void *t, const void *prim, int n, void *p,    \
        void *p_error, void *ng, void *uv, void *dpdu, void *dpdv, void *ns, void *ss, void *ts, \
        void *dndu, void *dndv, void *wo, void *material, void *arealight, void *prim_id
#define RT_BUILD_INTERACTION_TABLES                                                             \
    Quadrics qs{(const int*)q_type,     (const float*)q_o2w,    (const float*)q_w2o,             \
                (const float*)q_params, (const int*)q_material, (const int*)q_arealight,         \
                (const bool*)q_reverse};                                                         \
    Outs out{(float*)p,      (float*)p_error,  (float*)ng,  (float*)uv,   (float*)dpdu,          \
             (float*)dpdv,   (float*)ns,       (float*)ss,  (float*)ts,   (float*)dndu,          \
             (float*)dndv,   (float*)wo,       (int*)material, (int*)arealight, (int*)prim_id};

extern "C" int rt_build_interaction(RT_BUILD_INTERACTION_ARGS, void* stream) {
    RT_BUILD_INTERACTION_TABLES
    return launch<false>(t_shade, n_tris, nq, with_quadrics, qs, Instances{}, o, d, hit, t, prim,
                         n, out, stream);
}

extern "C" int rt_build_interaction_inst(RT_BUILD_INTERACTION_ARGS, const void* inst,
                                         const void* inst_o2w, const void* inst_w2o,
                                         const void* inst_flip, void* stream) {
    RT_BUILD_INTERACTION_TABLES
    Instances is{(const int*)inst, (const float*)inst_o2w, (const float*)inst_w2o,
                 (const bool*)inst_flip};
    return launch<true>(t_shade, n_tris, nq, with_quadrics, qs, is, o, d, hit, t, prim, n, out,
                        stream);
}

