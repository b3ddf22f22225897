// K2: rebuild the surface interaction of each closest hit from its packed
// (T, 32) t_shade row, one thread per lane.
//
// Replaces the triangle branch of rustracer_tpu/scene/tables.py
// build_interaction (:549-707): one row read per lane, the watertight
// re-intersection at t*1.0001+1e-4 (:610) for the barycentrics, then p and
// its error bound, uv (the default uv when the row has none), the geometric
// normal with the reverse flip, the interpolated shading normal and the
// face-forward, dpdu/dpdv, dndu/dndv, the shading frame, the material and
// area-light ids (bitcast words 25/26), and the miss-lane placeholders
// (:684-698). Lanes whose prim is below nq would be quadric hits; the port
// accepts no real quadrics, so such lanes are misses and only take the
// placeholders.
//
// Bound: the dependent 128-byte row read per lane and the 15 output
// streams (about 150 bytes written per lane); the arithmetic (some 300 flops)
// stays in registers. Outputs are struct-of-arrays so that each stream is
// written coalesced.
#include "common.cuh"

namespace {

using rt::V3;

struct Outs {
    float *p, *p_error, *n, *uv, *dpdu, *dpdv, *ns, *ss, *ts, *dndu, *dndv, *wo;
    int *material, *arealight, *prim_id;
};

__device__ __forceinline__ V3 bary(float b0, float b1, float b2, V3 a, V3 b, V3 c) {
    return {b0 * a.x + b1 * b.x + b2 * c.x, b0 * a.y + b1 * b.y + b2 * c.y,
            b0 * a.z + b1 * b.z + b2 * c.z};
}

__global__ void build_interaction_kernel(const float* __restrict__ t_shade, int n_tris, int nq,
                                         const float* __restrict__ o_in,
                                         const float* __restrict__ d_in,
                                         const float* __restrict__ t_max,
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
    // quadric hits cannot occur (no real quadrics): is_tri decides validity
    bool tri = hit && prim >= nq;
    if (!tri) {
        rt::store3(out.p + 3 * i, o);
        rt::store3(out.p_error + 3 * i, V3{0.0f, 0.0f, 0.0f});
        rt::store3(out.n + 3 * i, V3{0.0f, 0.0f, 1.0f});
        rt::store3(out.ns + 3 * i, V3{0.0f, 0.0f, 1.0f});
        rt::store3(out.ss + 3 * i, V3{1.0f, 0.0f, 0.0f});
        rt::store3(out.ts + 3 * i, V3{0.0f, 1.0f, 0.0f});
        out.uv[2 * i] = 0.0f;
        out.uv[2 * i + 1] = 0.0f;
        rt::store3(out.dpdu + 3 * i, V3{1.0f, 0.0f, 0.0f});
        rt::store3(out.dpdv + 3 * i, V3{0.0f, 1.0f, 0.0f});
        rt::store3(out.dndu + 3 * i, V3{0.0f, 0.0f, 0.0f});
        rt::store3(out.dndv + 3 * i, V3{0.0f, 0.0f, 0.0f});
        out.material[i] = -1;
        out.arealight[i] = -1;
        out.prim_id[i] = -1;
        return;
    }
    int tid = min(max(prim - nq, 0), n_tris - 1);
    const float* rec = t_shade + (size_t)tid * 32;
    V3 p0 = rt::load3(rec), p1 = rt::load3(rec + 3), p2 = rt::load3(rec + 6);
    rt::TriHit th = rt::tri_intersect(o, d, t * 1.0001f + 1e-4f, p0, p1, p2);
    float b0 = th.b0, b1 = th.b1, b2 = th.b2;
    int flags = __float_as_int(rec[24]);
    bool has_uv = flags & 1, has_n = flags & 2, rev = flags & 4;
    float u0 = has_uv ? rec[18] : 0.0f, v0 = has_uv ? rec[19] : 0.0f;
    float u1 = has_uv ? rec[20] : 1.0f, v1 = has_uv ? rec[21] : 0.0f;
    float u2 = has_uv ? rec[22] : 1.0f, v2 = has_uv ? rec[23] : 1.0f;

    // point and its gamma(7) error bound (ops/triangle.py triangle_point_error)
    V3 p = bary(b0, b1, b2, p0, p1, p2);
    V3 q0 = b0 * p0, q1 = b1 * p1, q2 = b2 * p2;
    V3 abs_sum = {fabsf(q0.x) + fabsf(q1.x) + fabsf(q2.x), fabsf(q0.y) + fabsf(q1.y) + fabsf(q2.y),
                  fabsf(q0.z) + fabsf(q1.z) + fabsf(q2.z)};
    V3 p_error = rt::kGamma7 * abs_sum;
    float uu = b0 * u0 + b1 * u1 + b2 * u2;
    float vv = b0 * v0 + b1 * v1 + b2 * v2;

    // dpdu/dpdv (ops/triangle.py triangle_partial_derivs)
    float du02 = u0 - u2, dv02 = v0 - v2, du12 = u1 - u2, dv12 = v1 - v2;
    V3 dp02 = p0 - p2, dp12 = p1 - p2;
    float det = du02 * dv12 - dv02 * du12;
    bool degenerate = fabsf(det) < 1e-12f;
    float inv = 1.0f / (degenerate ? 1.0f : det);
    V3 dpdu = (dv12 * dp02 - dv02 * dp12) * inv;
    V3 dpdv = (-du12 * dp02 + du02 * dp12) * inv;
    if (degenerate) rt::coordinate_system(rt::normalize(rt::cross(p2 - p0, p1 - p0)), &dpdu, &dpdv);

    // normals
    V3 ng = rt::normalize(rt::cross(p0 - p2, p1 - p2));
    if (rev) ng = -ng;
    V3 nv0 = rt::load3(rec + 9), nv1 = rt::load3(rec + 12), nv2 = rt::load3(rec + 15);
    V3 n_interp = rt::normalize(bary(b0, b1, b2, nv0, nv1, nv2));
    if (rev) n_interp = -n_interp;
    V3 ns = has_n ? n_interp : ng;
    if (has_n && rt::dot(ng, ns) < 0.0f) ng = -ng;

    // dndu/dndv (ops/triangle.py triangle_normal_derivs), zero without normals
    V3 dndu = {0.0f, 0.0f, 0.0f}, dndv = {0.0f, 0.0f, 0.0f};
    if (has_n && !degenerate) {
        V3 dn02 = nv0 - nv2, dn12 = nv1 - nv2;
        dndu = (dv12 * dn02 - dv02 * dn12) * inv;
        dndv = (-du12 * dn02 + du02 * dn12) * inv;
        if (rev) {
            dndu = -dndu;
            dndv = -dndv;
        }
    }
    auto finite_or_zero = [](V3 v) {
        return V3{isfinite(v.x) ? v.x : 0.0f, isfinite(v.y) ? v.y : 0.0f,
                  isfinite(v.z) ? v.z : 0.0f};
    };

    // shading frame (core/interaction.py make_shading_frame)
    V3 ss = rt::normalize(dpdu - rt::dot(dpdu, ns) * ns);
    if (rt::dot(ss, ss) < 1e-12f) {
        V3 unused;
        rt::coordinate_system(ns, &ss, &unused);
    }
    V3 ts = rt::cross(ns, ss);

    rt::store3(out.p + 3 * i, p);
    rt::store3(out.p_error + 3 * i, p_error);
    rt::store3(out.n + 3 * i, ng);
    rt::store3(out.ns + 3 * i, ns);
    rt::store3(out.ss + 3 * i, ss);
    rt::store3(out.ts + 3 * i, ts);
    out.uv[2 * i] = uu;
    out.uv[2 * i + 1] = vv;
    rt::store3(out.dpdu + 3 * i, dpdu);
    rt::store3(out.dpdv + 3 * i, dpdv);
    rt::store3(out.dndu + 3 * i, finite_or_zero(dndu));
    rt::store3(out.dndv + 3 * i, finite_or_zero(dndv));
    out.material[i] = __float_as_int(rec[25]);
    out.arealight[i] = __float_as_int(rec[26]);
    out.prim_id[i] = prim;
}

}  // namespace

extern "C" int rt_build_interaction_tri(
    const void* t_shade, int n_tris, int nq, const void* o, const void* d, const void* t_max,
    const void* hit, const void* t, const void* prim, int n, void* p, void* p_error, void* ng,
    void* uv, void* dpdu, void* dpdv, void* ns, void* ss, void* ts, void* dndu, void* dndv,
    void* wo, void* material, void* arealight, void* prim_id, void* stream) {
    Outs out{(float*)p,    (float*)p_error, (float*)ng,       (float*)uv,
             (float*)dpdu, (float*)dpdv,    (float*)ns,       (float*)ss,
             (float*)ts,   (float*)dndu,    (float*)dndv,     (float*)wo,
             (int*)material, (int*)arealight, (int*)prim_id};
    constexpr int kThreads = 128;
    build_interaction_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)t_shade, n_tris, nq, (const float*)o, (const float*)d, (const float*)t_max,
        (const bool*)hit, (const float*)t, (const int*)prim, n, out);
    return (int)cudaGetLastError();
}
