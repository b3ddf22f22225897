// K21-K23: the path integrator's per-bounce chain for Lambertian surfaces
// under triangle area lights (ops/pathshade.py).
//
// They replace the JAX package's chain around the closest hit and the
// shading, rustracer_tpu/integrators/path.py _hit_and_emit (:190) and
// _scatter (:230), with integrators/common.py estimate_direct_light_side
// (:97), ops/bsdf.py bsdf_f (:522), bsdf_pdf (:539) and bsdf_sample_f
// (:617, sample_lobe's Lambertian branch :381), scene/lights.py sample_li's
// area rows (:415), pdf_li_hit (:574) and arealight_le (:617),
// core/sampling.py concentric_sample_disk (:47), cosine_sample_hemisphere
// (:62) and power_heuristic (:90), core/math.py offset_ray_origin (:195) and
// ops/triangle.py triangle_sample (:152). In the port each was a few dozen
// PyTorch launches a bounce.
//
// K21 path_hit_emit: per lane the hit's valid mask on a live path, the
// emission of its triangle light row (arealight_le), weighted on a bounce
// ray by the power heuristic of the BSDF pdf against pdf_li_hit times the
// selection pmf (a table, K13's lookup, or the uniform 1 / n) and 1 after
// a specular bounce or on a camera ray (kFirst), L += beta * le, the
// path's alive mask and length.
//
// K22 path_scatter_lambert: per lane, after the shading, the NEE toward
// its picked triangle light (the uniform area sample, the facing test and
// the area pdf; the Lambertian f and pdf of the lane's one lobe on the
// shading frame, with bsdf_f's geometric-normal reflect test; the power
// heuristic), its shadow ray (both offset_ray_origin's of unoccluded;
// t_max 1 - 1e-3 where the NEE may add, else 0) and the radiance beta * ld
// that waits on it; the cosine-hemisphere bounce (u0 clamped to 0.99999),
// its f and pdf, the throughput, spawn_ray, the dead lanes' t_max 0 and
// Russian roulette (u_rr not null). No lobe of this route is specular: the
// bounce's prev_spec is false and eta_scale passes through. With one lobe
// a material the lobe choice of bsdf_sample_f picks that lobe, so its draw
// is not read.
//
// K23 path_nee_add: after K1's any hit on that shadow ray, L + pending
// where it found no occluder, L + 0 elsewhere: the plain chain's order of
// the additions to L (the emission at the hit first, then beta * ld with
// the beta from before the bounce).
//
// One thread a lane; a lane's (B, 3) and (B, 16) fields are read at stride
// 3 and 16 floats (a warp's loads of a field touch consecutive lines), the
// light rows through the read-only path; K21 reads the hit's normal, wo and
// the MIS inputs only on the lanes that hit a light. Bound: bytes (K22 some
// 230 bytes a lane in and out for some 400 float operations; K21 some 50
// bytes on a lane that hits no light, K23 37).
//
// Every formula repeats its plain twin operation for operation (the
// library is built with -fmad=false), with each torch.clamp's NaN
// behaviour (clamp_min / clamp_max below), so the outputs are the twins'
// bits wherever the math library agrees with PyTorch's: sqrtf and the
// divides are IEEE, and rsqrtf of the normalisations and cosf and sinf of
// the concentric map (lights.cuh concentric_disk) are the functions
// torch.rsqrt, torch.cos and torch.sin call on the card (PERF.md, section
// 6, names the recorded calls this was checked on). cosf and sinf keep
// their slow path's 32-byte stack frame in K22; lights.cuh sincos_bounded,
// without it, is within 1 ulp of them, not their bits.
#include "lights.cuh"

namespace {

constexpr int kThreads = 256;
// float32(1 / pi), gamma(6), float32(1 - 1e-3) and float32(0.99999) as the
// plain twins round them (core/math.py INV_PI, ops/triangle.py GAMMA6)
constexpr float kInvPi = 0x1.45f306p-2f;
constexpr float kGamma6 = 0x1.80000ap-22f;
constexpr float kShadowTMax = 0x1.ff7ceep-1f;
constexpr float kU0Max = 0x1.fffebp-1f;

using rt::V3;

// torch.clamp(x, min=lo) and torch.clamp(x, max=hi): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// torch.rsqrt on the card
__device__ __forceinline__ V3 normalize_t(V3 v) {
    return v * rsqrtf(clamp_min(rt::dot(v, v), 1e-20f));
}

__device__ __forceinline__ V3 ldg3(const float* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }
__device__ __forceinline__ bool ldg_bool(const bool* p) {
    return __ldg(reinterpret_cast<const unsigned char*>(p)) != 0;
}

__device__ __forceinline__ bool is_black(V3 c) { return c.x == 0.0f && c.y == 0.0f && c.z == 0.0f; }

__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }

// core/math.py next_float_up / next_float_down
__device__ __forceinline__ float next_up(float x) {
    if (x == 0.0f) x = 0.0f;  // -0 -> +0
    const int bits = __float_as_int(x);
    const float out = __int_as_float(bits < 0 ? bits - 1 : bits + 1);
    return (isinf(x) && x > 0.0f) ? x : out;
}
__device__ __forceinline__ float next_down(float x) { return -next_up(-x); }

__device__ __forceinline__ float offset_axis(float p, float off) {
    const float po = p + off;
    return off > 0.0f ? next_up(po) : (off < 0.0f ? next_down(po) : po);
}

// core/math.py offset_ray_origin: off the surface along n by the projected
// error, to w's side, rounded away from p
__device__ __forceinline__ V3 offset_ray_origin(V3 p, V3 err, V3 n, V3 w) {
    const float d = fabsf(n.x) * err.x + fabsf(n.y) * err.y + fabsf(n.z) * err.z;
    V3 off = d * n;
    if (rt::dot(w, n) < 0.0f) off = -off;
    return {offset_axis(p.x, off.x), offset_axis(p.y, off.y), offset_axis(p.z, off.z)};
}

// the shading frame's world_to_local and local_to_world (ops/bsdf.py)
struct Frame {
    V3 ss, ts, ns;
};
__device__ __forceinline__ V3 to_local(const Frame& f, V3 v) {
    return {rt::dot(v, f.ss), rt::dot(v, f.ts), rt::dot(v, f.ns)};
}
__device__ __forceinline__ V3 to_world(const Frame& f, V3 v) {
    return (v.x * f.ss + v.y * f.ts) + v.z * f.ns;
}

// ops/bsdf.py bsdf_f of one Lambertian lobe of reflectance r (before the
// cosine): R / pi where the lobe is active, wi reflects (geometric normal)
// and wo and wi lie on one side of the shading frame, 0 where |wo.z| <= 1e-8
__device__ __forceinline__ V3 lambert_f(V3 r, bool active, V3 wo_l, V3 wi_l, bool reflect) {
    const bool same = wo_l.z * wi_l.z > 0.0f;
    const V3 f = (active && reflect && same) ? r * kInvPi : V3{0.0f, 0.0f, 0.0f};
    return fabsf(wo_l.z) > 1e-8f ? f : V3{0.0f, 0.0f, 0.0f};
}

// ops/bsdf.py bsdf_pdf of one Lambertian lobe: |cos wi| / pi where it is
// active and wo and wi lie on one side (the mean over one lobe is its pdf
// over 1, the same float)
__device__ __forceinline__ float lambert_pdf(bool active, V3 wo_l, V3 wi_l) {
    const bool same = wo_l.z * wi_l.z > 0.0f;
    const float pdf = (active && same) ? fabsf(wi_l.z) * kInvPi : 0.0f;
    return (fabsf(wo_l.z) > 1e-8f && active) ? pdf : 0.0f;
}

// the largest of three, NaN if any is (torch max)
__device__ __forceinline__ float max3(float a, float b, float c) {
    float m = a;
    m = (b > m || b != b) && m == m ? b : m;
    m = (c > m || c != c) && m == m ? c : m;
    return m;
}

template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
    path_hit_emit_kernel(const bool* __restrict__ si_valid, const int* __restrict__ arealight,
                         const int* __restrict__ material, const float* __restrict__ n_in,
                         const float* __restrict__ wo_in, const float* __restrict__ p_in,
                         const float* __restrict__ d_in, const float* __restrict__ L_in,
                         const float* __restrict__ beta_in, const float* __restrict__ prev_p,
                         const bool* __restrict__ alive_in, const float* __restrict__ prev_pdf,
                         const bool* __restrict__ prev_spec, const int* __restrict__ path_len_in,
                         const float* __restrict__ pmf, float pmf_const, int n, int n_lights,
                         const bool* __restrict__ twosided, const float* __restrict__ emit,
                         const float* __restrict__ area, bool* __restrict__ valid_out,
                         float* __restrict__ L_out, bool* __restrict__ alive_out,
                         int* __restrict__ path_len_out) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const bool alive = alive_in[i];
    const bool valid = si_valid[i] && alive;
    const int lid = arealight[i];
    // the weighted emission, 0 where the lane hits no light
    V3 lw{0.0f, 0.0f, 0.0f};
    if (valid && lid >= 0) {
        const int lc = min(lid, n_lights - 1);
        const V3 nh = rt::load3(n_in + 3 * i);
        // scene/lights.py arealight_le
        const bool emits = ldg_bool(twosided + lc) || rt::dot(nh, rt::load3(wo_in + 3 * i)) > 0.0f;
        const V3 le = emits ? ldg3(emit + 3 * lc) : V3{0.0f, 0.0f, 0.0f};
        float w_hit = 1.0f;
        if (!kFirst) {
            // pdf_li_hit times the selection pmf, the power heuristic
            const V3 diff = rt::load3(prev_p + 3 * i) - rt::load3(p_in + 3 * i);
            const float dist2 = clamp_min(rt::dot(diff, diff), 1e-12f);
            const float cos_l = fabsf(rt::dot(nh, rt::load3(d_in + 3 * i)));
            float pdf = dist2 / clamp_min(cos_l * __ldg(area + lc), 1e-12f);
            pdf = cos_l > 1e-7f ? pdf : 0.0f;
            const float lpdf = pdf * (pmf ? pmf[i] : pmf_const);
            w_hit = prev_spec[i] ? 1.0f : rt::power_heuristic(prev_pdf[i], lpdf);
        }
        lw = w_hit * le;
    }
    rt::store3(L_out + 3 * i, rt::load3(L_in + 3 * i) + mul(rt::load3(beta_in + 3 * i), lw));
    const bool alive2 = alive && valid && material[i] >= 0;
    valid_out[i] = valid;
    alive_out[i] = alive2;
    path_len_out[i] = path_len_in[i] + (alive2 ? 1 : 0);
}

__global__ void __launch_bounds__(kThreads) path_scatter_lambert_kernel(
    const float* __restrict__ p_in, const float* __restrict__ perr_in,
    const float* __restrict__ n_in, const float* __restrict__ ns_in,
    const float* __restrict__ ss_in, const float* __restrict__ ts_in,
    const float* __restrict__ wo_in, const bool* __restrict__ si_valid,
    const float* __restrict__ params, const bool* __restrict__ active,
    const bool* __restrict__ alive_in, const float* __restrict__ beta_in,
    const float* __restrict__ eta_scale, const int* __restrict__ lid_in,
    const float* __restrict__ pmf, float pmf_const, const float* __restrict__ u_light,
    const float* __restrict__ u2, const float* __restrict__ u_rr, float rr_threshold, int n,
    const float* __restrict__ tri_p, const float* __restrict__ emit,
    const float* __restrict__ area, const bool* __restrict__ tri_rev,
    const bool* __restrict__ twosided, float* __restrict__ ray_o, float* __restrict__ ray_d,
    float* __restrict__ ray_tmax, float* __restrict__ beta_out, bool* __restrict__ alive_out,
    float* __restrict__ prev_pdf, bool* __restrict__ prev_spec, float* __restrict__ sh_o,
    float* __restrict__ sh_d, float* __restrict__ sh_tmax, float* __restrict__ pending) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const bool alive = alive_in[i];
    const V3 p = rt::load3(p_in + 3 * i), perr = rt::load3(perr_in + 3 * i);
    const V3 ng = rt::load3(n_in + 3 * i), wo = rt::load3(wo_in + 3 * i);
    const Frame fr{rt::load3(ss_in + 3 * i), rt::load3(ts_in + 3 * i), rt::load3(ns_in + 3 * i)};
    const V3 beta = rt::load3(beta_in + 3 * i);

    // the lane's one lobe: its reflectance (params [0:3]) and whether it
    // is active on a live path
    const V3 r = rt::load3(params + (size_t)i * 16);
    const bool on = active[i] && alive;
    const V3 wo_l = to_local(fr, wo);
    const float wo_n = rt::dot(wo, ng);

    // --- NEE: scene/lights.py sample_li on the triangle row ---
    const int lid = lid_in[i];
    const float* tp = tri_p + 9 * lid;
    const V3 p0 = ldg3(tp), p1 = ldg3(tp + 3), p2 = ldg3(tp + 6);
    const float su0 = sqrtf(u_light[2 * i]);
    const float b0 = 1.0f - su0;
    const float b1 = u_light[2 * i + 1] * su0;
    const float b2 = (1.0f - b0) - b1;
    const V3 pa = (b0 * p0 + b1 * p1) + b2 * p2;
    V3 na = normalize_t(rt::cross(p1 - p0, p2 - p0));
    const V3 q0 = b0 * p0, q1 = b1 * p1, q2 = b2 * p2;
    const V3 err = kGamma6 * V3{(fabsf(q0.x) + fabsf(q1.x)) + fabsf(q2.x),
                                (fabsf(q0.y) + fabsf(q1.y)) + fabsf(q2.y),
                                (fabsf(q0.z) + fabsf(q1.z)) + fabsf(q2.z)};
    if (ldg_bool(tri_rev + lid)) na = -na;
    const V3 da = pa - p;
    const float dist2 = clamp_min(rt::dot(da, da), 1e-12f);
    const V3 wi = da * rsqrtf(clamp_min(dist2, 1e-20f));
    const float cos_l = rt::dot(na, -wi);
    const bool facing = ldg_bool(twosided + lid) ? fabsf(cos_l) > 1e-7f : cos_l > 1e-7f;
    const V3 li = facing ? ldg3(emit + 3 * lid) : V3{0.0f, 0.0f, 0.0f};
    float lpdf = dist2 / clamp_min(fabsf(cos_l) * __ldg(area + lid), 1e-12f);
    lpdf = facing ? lpdf : 0.0f;
    const float light_pdf = lpdf * (pmf ? pmf[i] : pmf_const);

    // the Lambertian f (times |cos|) and pdf toward the light
    const V3 wi_l = to_local(fr, wi);
    const V3 f = lambert_f(r, on, wo_l, wi_l, rt::dot(wi, ng) * wo_n > 0.0f) * fabsf(wi_l.z);
    const float s_pdf = lambert_pdf(on, wo_l, wi_l);
    const bool possible =
        light_pdf > 0.0f && !is_black(li) && !is_black(f) && si_valid[i];
    const float w = rt::power_heuristic(light_pdf, s_pdf);
    const float w_pdf = w / (possible ? clamp_min(light_pdf, 1e-12f) : 1.0f);
    const V3 ld = possible ? mul(f, li) * w_pdf : V3{0.0f, 0.0f, 0.0f};
    rt::store3(pending + 3 * i, on ? mul(beta, ld) : V3{0.0f, 0.0f, 0.0f});

    // the shadow ray (integrators/common.py shadow_ray)
    const V3 so = offset_ray_origin(p, perr, ng, wi);
    const V3 pt = offset_ray_origin(pa, err, na, so - pa);
    rt::store3(sh_o + 3 * i, so);
    rt::store3(sh_d + 3 * i, pt - so);
    sh_tmax[i] = possible ? kShadowTMax : 0.0f;

    // --- the bounce: ops/bsdf.py bsdf_sample_f's cosine-hemisphere sample ---
    float dx, dy;
    rt::concentric_disk(clamp_max(u2[2 * i], kU0Max), u2[2 * i + 1], &dx, &dy);
    float z = sqrtf(clamp_min((1.0f - dx * dx) - dy * dy, 0.0f));
    if (wo_l.z < 0.0f) z = z * -1.0f;
    const V3 wb = to_world(fr, V3{dx, dy, z});
    const V3 wb_l = to_local(fr, wb);
    V3 fb = lambert_f(r, on, wo_l, wb_l, rt::dot(wb, ng) * wo_n > 0.0f);
    float pdf = lambert_pdf(on, wo_l, wb_l);
    const bool ok = on && fabsf(wo_l.z) > 1e-8f && pdf > 0.0f;
    fb = ok ? fb : V3{0.0f, 0.0f, 0.0f};
    pdf = ok ? pdf : 0.0f;
    const V3 contrib = fb * (fabsf(wb_l.z) / clamp_min(pdf, 1e-12f));
    bool alive2 = alive && ok && !is_black(fb) && pdf > 0.0f;
    V3 beta2 = alive2 ? mul(beta, contrib) : beta;
    rt::store3(ray_o + 3 * i, offset_ray_origin(p, perr, ng, wb));
    rt::store3(ray_d + 3 * i, wb);
    ray_tmax[i] = alive2 ? rt::kInf : 0.0f;
    prev_pdf[i] = pdf;
    prev_spec[i] = false;

    // Russian roulette (ops/pathshade.py russian_roulette)
    if (u_rr) {
        const float es = eta_scale[i];
        const float bmax = max3(beta2.x * es, beta2.y * es, beta2.z * es);
        const float q = clamp_min(1.0f - bmax, 0.05f);
        const bool do_rr = bmax < rr_threshold;
        alive2 = alive2 && !(do_rr && u_rr[i] < q);
        if (do_rr && alive2) {
            const float s = clamp_min(1.0f - q, 1e-3f);
            beta2 = V3{beta2.x / s, beta2.y / s, beta2.z / s};
        }
    }
    rt::store3(beta_out + 3 * i, beta2);
    alive_out[i] = alive2;
}

__global__ void __launch_bounds__(kThreads)
    path_nee_add_kernel(const float* __restrict__ L_in, const float* __restrict__ pend,
                        const bool* __restrict__ occluded, int n, float* __restrict__ L_out) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const V3 add = occluded[i] ? V3{0.0f, 0.0f, 0.0f} : rt::load3(pend + 3 * i);
    rt::store3(L_out + 3 * i, rt::load3(L_in + 3 * i) + add);
}

}  // namespace

// the hit (valid, arealight, material, n, wo, p; the ray's d), the path
// state (L, beta, prev_p, alive, prev_pdf, prev_spec, path_len), the
// selection pmf (n,) or null for pmf_const, first (camera rays: weight 1),
// the triangle light rows (twosided, emit, area) -> valid, L, alive,
// path_len
extern "C" int rt_path_hit_emit(const void* si_valid, const void* arealight, const void* material,
                                const void* n_in, const void* wo, const void* p, const void* d,
                                const void* L_in, const void* beta, const void* prev_p,
                                const void* alive, const void* prev_pdf, const void* prev_spec,
                                const void* path_len, const void* pmf, float pmf_const, int first,
                                int n, int n_lights, const void* twosided, const void* emit,
                                const void* area, void* valid_out, void* L_out, void* alive_out,
                                void* path_len_out, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (n_lights <= 0) return (int)cudaErrorInvalidValue;
    const auto kernel = first ? path_hit_emit_kernel<true> : path_hit_emit_kernel<false>;
    kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const bool*)si_valid, (const int*)arealight, (const int*)material, (const float*)n_in,
        (const float*)wo, (const float*)p, (const float*)d, (const float*)L_in,
        (const float*)beta, (const float*)prev_p, (const bool*)alive, (const float*)prev_pdf,
        (const bool*)prev_spec, (const int*)path_len, (const float*)pmf, pmf_const, n, n_lights,
        (const bool*)twosided, (const float*)emit, (const float*)area, (bool*)valid_out,
        (float*)L_out, (bool*)alive_out, (int*)path_len_out);
    return (int)cudaGetLastError();
}

// the shaded hit (p, p_error, n, ns, ss, ts, wo (n, 3), valid), its one
// lobe (params (n, 1, 16), active (n, 1)), the path state (alive, beta,
// eta_scale), the light pick (lid, pmf (n,) or null for pmf_const), the
// draws (u_light (n, 2), u2 (n, 2), u_rr or null: no Russian roulette;
// the lobe's draw picks the one lobe and is not read) and its threshold, the triangle light rows (tri_p (L, 3, 3),
// emit, area, tri_rev, twosided) -> ray_o, ray_d, ray_tmax, beta, alive,
// prev_pdf, prev_spec, the shadow ray's o, d and t_max, pending (n, 3)
extern "C" int rt_path_scatter_lambert(
    const void* p, const void* perr, const void* n_in, const void* ns, const void* ss,
    const void* ts, const void* wo, const void* si_valid, const void* params,
    const void* active, const void* alive, const void* beta, const void* eta_scale,
    const void* lid, const void* pmf, float pmf_const, const void* u_light, const void* u2,
    const void* u_rr, float rr_threshold, int n, int n_lights,
    const void* tri_p, const void* emit, const void* area, const void* tri_rev,
    const void* twosided, void* ray_o, void* ray_d, void* ray_tmax, void* beta_out,
    void* alive_out, void* prev_pdf, void* prev_spec, void* sh_o, void* sh_d, void* sh_tmax,
    void* pending, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (n_lights <= 0) return (int)cudaErrorInvalidValue;
    path_scatter_lambert_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)p, (const float*)perr, (const float*)n_in, (const float*)ns,
        (const float*)ss, (const float*)ts, (const float*)wo, (const bool*)si_valid,
        (const float*)params, (const bool*)active, (const bool*)alive, (const float*)beta,
        (const float*)eta_scale, (const int*)lid, (const float*)pmf, pmf_const,
        (const float*)u_light, (const float*)u2, (const float*)u_rr,
        rr_threshold, n, (const float*)tri_p, (const float*)emit, (const float*)area,
        (const bool*)tri_rev, (const bool*)twosided, (float*)ray_o, (float*)ray_d,
        (float*)ray_tmax, (float*)beta_out, (bool*)alive_out, (float*)prev_pdf,
        (bool*)prev_spec, (float*)sh_o, (float*)sh_d, (float*)sh_tmax, (float*)pending);
    return (int)cudaGetLastError();
}

// L (n, 3), pending (n, 3), occluded (n,) -> L_out (n, 3)
extern "C" int rt_path_nee_add(const void* L_in, const void* pend, const void* occluded, int n,
                               void* L_out, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    path_nee_add_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)L_in, (const float*)pend, (const bool*)occluded, n, (float*)L_out);
    return (int)cudaGetLastError();
}
