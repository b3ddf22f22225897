// Sphere, cylinder and disk intersection in one thread, shared by K14
// (quadrics.cu, the hit test of every quadric) and K2's quadric branch
// (interaction.cu, the full hit of the lane's quadric).
//
// Each function repeats its plain twin in rustracer_tpu_torch/ops/quadrics.py
// operation for operation (the library is built with -fmad=false, so no
// multiply and add fuse): the reference's stable quadratic, the pole nudge
// px = 1e-5 * radius, the full-sphere short cut that skips atan2f, the retry
// at t1 when t0's hit is clipped away, a == 0 -> 1e-20 for the cylinder and
// |dz| < 1e-12 for the disk. sqrtf and the divides are IEEE; atan2f, acosf
// and sinf are CUDA's, which may differ by an ulp or two from the plain
// versions' (torch.atan2, acos, sin): only there can the two disagree.
#pragma once

#include "common.cuh"

namespace rt {

enum QuadricType { kSphere = 0, kCylinder = 1, kDisk = 2 };

// float32(2 * float32(pi)) and float32(2 * float32(pi) - 1e-6), the
// reference's constants as it rounds them (ops/quadrics.py TWO_PI, FULL_PHI)
constexpr float kTwoPi = 0x1.921fb6p+2f;
constexpr float kFullPhi = 0x1.921fb2p+2f;

struct Roots {
    float t0, t1;
    bool has;
};

// core/math.py quadratic: q = -0.5 (b +- sqrt(disc)), t1 = c / q
__device__ __forceinline__ Roots quadratic(float a, float b, float c) {
    float disc = b * b - 4.0f * a * c;
    float root = sqrtf(fmaxf(disc, 0.0f));
    float q = b < 0.0f ? -0.5f * (b - root) : -0.5f * (b + root);
    float t0 = q / a;
    float t1 = c / (q == 0.0f ? 1.0f : q);
    if (q == 0.0f) t1 = t0;
    return {fminf(t0, t1), fmaxf(t0, t1), disc >= 0.0f};
}

__device__ __forceinline__ float phi_of(float x, float y) {
    float phi = atan2f(y, x);
    return phi < 0.0f ? phi + kTwoPi : phi;
}

// A quadric's parameter row: sphere and cylinder [radius, z_min, z_max,
// phi_max], disk [height, radius, inner_radius, phi_max].
struct QParams {
    float r0, r1, r2, phi_max;
};

__device__ __forceinline__ bool full_sphere(QParams q) {
    return q.phi_max >= kFullPhi && q.r1 <= -q.r0 && q.r2 >= q.r0;
}

struct HitT {
    float t;
    bool hit;
};

// ---- (t, hit) only: ops/quadrics.py _sphere_hit_t, _cylinder_hit_t,
// _disk_hit_t ----

__device__ __forceinline__ HitT sphere_hit_t(V3 o, V3 d, float t_max, QParams q) {
    float radius = q.r0;
    float a = d.x * d.x + d.y * d.y + d.z * d.z;
    float b = 2.0f * (o.x * d.x + o.y * d.y + o.z * d.z);
    float c = o.x * o.x + o.y * o.y + o.z * o.z - radius * radius;
    Roots r = quadratic(a, b, c);
    bool full = full_sphere(q);
    auto ok_at = [&](float t) {
        float px = o.x + t * d.x, py = o.y + t * d.y, pz = o.z + t * d.z;
        float s = radius / fmaxf(sqrtf(px * px + py * py + pz * pz), 1e-20f);
        px = px * s;
        py = py * s;
        pz = pz * s;
        if (full) return true;
        if (px == 0.0f && py == 0.0f) px = 1e-5f * radius;
        return pz >= q.r1 && pz <= q.r2 && phi_of(px, py) <= q.phi_max;
    };
    bool valid0 = r.has && r.t0 > 0.0f && r.t0 < t_max && ok_at(r.t0);
    bool valid1 = r.has && r.t1 > 0.0f && r.t1 < t_max && ok_at(r.t1);
    return {valid0 ? r.t0 : r.t1, valid0 || valid1};
}

__device__ __forceinline__ HitT cylinder_hit_t(V3 o, V3 d, float t_max, QParams q) {
    float a = d.x * d.x + d.y * d.y;
    float b = 2.0f * (d.x * o.x + d.y * o.y);
    float c = o.x * o.x + o.y * o.y - q.r0 * q.r0;
    Roots r = quadratic(a == 0.0f ? 1e-20f : a, b, c);
    bool has = r.has && a > 0.0f;
    auto ok_at = [&](float t) {
        float px = o.x + t * d.x, py = o.y + t * d.y, pz = o.z + t * d.z;
        return pz >= q.r1 && pz <= q.r2 && phi_of(px, py) <= q.phi_max;
    };
    bool valid0 = has && r.t0 > 0.0f && r.t0 < t_max && ok_at(r.t0);
    bool valid1 = has && r.t1 > 0.0f && r.t1 < t_max && ok_at(r.t1);
    return {valid0 ? r.t0 : r.t1, valid0 || valid1};
}

__device__ __forceinline__ HitT disk_hit_t(V3 o, V3 d, float t_max, QParams q) {
    bool parallel = fabsf(d.z) < 1e-12f;
    float t = (q.r0 - o.z) / (parallel ? 1.0f : d.z);
    float px = o.x + t * d.x, py = o.y + t * d.y;
    float dist2 = px * px + py * py;
    bool hit = !parallel && t > 0.0f && t < t_max && dist2 <= q.r1 * q.r1 &&
               dist2 >= q.r2 * q.r2 && phi_of(px, py) <= q.phi_max;
    return {t, hit};
}

// ops/quadrics.py quadric_hit_t: the type code clipped to [0, 2]
__device__ __forceinline__ HitT quadric_hit_t(int type, V3 o, V3 d, float t_max, QParams q) {
    if (type <= kSphere) return sphere_hit_t(o, d, t_max, q);
    if (type == kCylinder) return cylinder_hit_t(o, d, t_max, q);
    return disk_hit_t(o, d, t_max, q);
}

// ---- the full hit: ops/quadrics.py sphere_intersect, cylinder_intersect,
// disk_intersect (object space) ----

struct QuadricHit {
    V3 p, p_error, dpdu, dpdv;
    float u, v;
};

__device__ __forceinline__ QuadricHit sphere_intersect(V3 o, V3 d, float t_max, QParams q) {
    float radius = q.r0, z_min = q.r1, z_max = q.r2, phi_max = q.phi_max;
    float a = dot(d, d);
    float b = 2.0f * dot(o, d);
    float c = dot(o, o) - radius * radius;
    Roots r = quadratic(a, b, c);
    bool full = full_sphere(q);
    struct At {
        V3 p;
        float phi;
        bool ok;
    };
    auto eval_at = [&](float t) {
        V3 p = o + t * d;
        p = p * (radius / fmaxf(sqrtf(dot(p, p)), 1e-20f));
        if (p.x == 0.0f && p.y == 0.0f) p.x = 1e-5f * radius;
        float phi = phi_of(p.x, p.y);
        bool z_ok = p.z >= z_min && p.z <= z_max;
        return At{p, phi, full || (z_ok && phi <= phi_max)};
    };
    At e0 = eval_at(r.t0), e1 = eval_at(r.t1);
    bool valid0 = r.has && r.t0 > 0.0f && r.t0 < t_max && e0.ok;
    bool valid1 = r.has && r.t1 > 0.0f && r.t1 < t_max && e1.ok;
    At e = (!valid0 && valid1) ? e1 : e0;
    V3 p = e.p;

    float theta = acosf(fminf(fmaxf(p.z / radius, -1.0f), 1.0f));
    float theta_min = acosf(fminf(fmaxf(z_min / radius, -1.0f), 1.0f));
    float theta_max = acosf(fminf(fmaxf(z_max / radius, -1.0f), 1.0f));
    float span = theta_max - theta_min;
    span = fabsf(span) > 1e-9f ? span : 1.0f;
    float z_radius = sqrtf(p.x * p.x + p.y * p.y);
    float inv_zr = 1.0f / fmaxf(z_radius, 1e-20f);
    float cos_phi = p.x * inv_zr, sin_phi = p.y * inv_zr;
    float dtheta = theta_max - theta_min;
    QuadricHit h;
    h.p = p;
    h.p_error = {kGamma5 * fabsf(p.x), kGamma5 * fabsf(p.y), kGamma5 * fabsf(p.z)};
    h.u = e.phi / phi_max;
    h.v = (theta - theta_min) / span;
    h.dpdu = {-phi_max * p.y, phi_max * p.x, 0.0f};
    h.dpdv = {p.z * cos_phi * dtheta, p.z * sin_phi * dtheta, -radius * sinf(theta) * dtheta};
    return h;
}

__device__ __forceinline__ QuadricHit cylinder_intersect(V3 o, V3 d, float t_max, QParams q) {
    float radius = q.r0, z_min = q.r1, z_max = q.r2, phi_max = q.phi_max;
    float a = d.x * d.x + d.y * d.y;
    float b = 2.0f * (d.x * o.x + d.y * o.y);
    float c = o.x * o.x + o.y * o.y - radius * radius;
    Roots r = quadratic(a == 0.0f ? 1e-20f : a, b, c);
    bool has = r.has && a > 0.0f;
    struct At {
        V3 p;
        float phi;
        bool ok;
    };
    auto eval_at = [&](float t) {
        V3 p = o + t * d;
        float s = radius / fmaxf(sqrtf(p.x * p.x + p.y * p.y), 1e-20f);
        p = V3{p.x * s, p.y * s, p.z};
        float phi = phi_of(p.x, p.y);
        return At{p, phi, p.z >= z_min && p.z <= z_max && phi <= phi_max};
    };
    At e0 = eval_at(r.t0), e1 = eval_at(r.t1);
    bool valid0 = has && r.t0 > 0.0f && r.t0 < t_max && e0.ok;
    bool valid1 = has && r.t1 > 0.0f && r.t1 < t_max && e1.ok;
    At e = (!valid0 && valid1) ? e1 : e0;
    V3 p = e.p;
    QuadricHit h;
    h.p = p;
    h.p_error = {kGamma3 * fabsf(p.x), kGamma3 * fabsf(p.y), kGamma3 * 0.0f};
    h.u = e.phi / phi_max;
    h.v = (p.z - z_min) / fmaxf(z_max - z_min, 1e-20f);
    h.dpdu = {-phi_max * p.y, phi_max * p.x, 0.0f};
    h.dpdv = {0.0f, 0.0f, z_max - z_min};
    return h;
}

__device__ __forceinline__ QuadricHit disk_intersect(V3 o, V3 d, float t_max, QParams q) {
    float height = q.r0, radius = q.r1, inner = q.r2, phi_max = q.phi_max;
    bool parallel = fabsf(d.z) < 1e-12f;
    float t = (height - o.z) / (parallel ? 1.0f : d.z);
    V3 p = o + t * d;
    float dist2 = p.x * p.x + p.y * p.y;
    float phi = phi_of(p.x, p.y);
    float r_hit = sqrtf(dist2);
    float k = inner - radius;
    float inv_r = 1.0f / fmaxf(r_hit, 1e-20f);
    QuadricHit h;
    h.u = phi / phi_max;
    h.v = 1.0f - (r_hit - inner) / fmaxf(radius - inner, 1e-20f);
    h.dpdu = {-phi_max * p.y, phi_max * p.x, 0.0f};
    h.dpdv = {p.x * inv_r * k, p.y * inv_r * k, 0.0f * k};
    h.p = {p.x, p.y, height};
    h.p_error = {0.0f, 0.0f, 0.0f};
    return h;
}

// ops/quadrics.py quadric_intersect for the lane's one type
__device__ __forceinline__ QuadricHit quadric_intersect(int type, V3 o, V3 d, float t_max,
                                                        QParams q) {
    if (type == kSphere) return sphere_intersect(o, d, t_max, q);
    if (type == kCylinder) return cylinder_intersect(o, d, t_max, q);
    return disk_intersect(o, d, t_max, q);
}

}  // namespace rt
