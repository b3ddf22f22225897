// Device helpers shared by the kernels of rustracer_tpu_torch.
//
// The library is compiled with -fmad=false: PyTorch evaluates every
// multiply and add of these formulas as a separately rounded operation, and
// the kernels do the same op for op, so results agree with the plain
// PyTorch versions bit for bit up to the few places noted here: the exact
// residual of edge_fn, 1/sqrtf where torch.rsqrt may round differently, and
// fminf/fmaxf, which drop a NaN where torch.minimum/maximum keep it (no
// NaN reaches them from finite rays and tables).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr float kInf = __builtin_huge_valf();
// gamma(n) = n*eps / (1 - n*eps) rounded to float32 (core/math.py gamma)
constexpr float kGamma2 = 0x1.000002p-23f;
constexpr float kGamma3 = 0x1.800004p-23f;
constexpr float kGamma5 = 0x1.400006p-22f;
constexpr float kGamma7 = 0x1.c0000cp-22f;

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void store3(float* p, V3 v) {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// 1/sqrt with two IEEE roundings (the approximate rsqrtf differs more)
__device__ __forceinline__ float rsqrt_rn(float x) { return 1.0f / sqrtf(x); }
__device__ __forceinline__ V3 normalize(V3 v) {
    return v * rsqrt_rn(fmaxf(dot(v, v), 1e-20f));
}

// orthonormal (v2, v3) around the unit vector v1 (core/math.py)
__device__ __forceinline__ void coordinate_system(V3 v1, V3* v2, V3* v3) {
    bool use_x = fabsf(v1.x) > fabsf(v1.y);
    float inv_a = rsqrt_rn(use_x ? v1.x * v1.x + v1.z * v1.z
                                 : v1.y * v1.y + v1.z * v1.z);
    *v2 = use_x ? V3{-v1.z * inv_a, 0.0f, v1.x * inv_a}
                : V3{0.0f, v1.z * inv_a, -v1.y * inv_a};
    *v3 = cross(v1, *v2);
}

// Edge function ax*by - ay*bx with the exact-zero fallback of the
// watertight test (ops/triangle.py _edge_fn): where the float result is
// exactly 0 its sign comes from the exact residual of the two products.
// The residual here is fmaf(a, b, -p), exact for all finite inputs. The
// JAX and plain versions split with Dekker instead, which overflows for
// coordinates above ~2^103 and zeroes the residual there; only there can
// the two differ.
__device__ __forceinline__ float edge_fn(float ax, float ay, float bx, float by) {
    float p1 = ax * by;
    float e1 = fmaf(ax, by, -p1);
    float p2 = ay * bx;
    float e2 = fmaf(ay, bx, -p2);
    float d = p1 - p2;
    return d == 0.0f ? e1 - e2 : d;
}

struct TriHit {
    bool hit;
    float t, b0, b1, b2;
};

// Watertight ray-triangle test (ops/triangle.py triangle_intersect_c):
// translate, permute so the largest |d| component is z, shear, then the
// three edge functions and the conservative t error bound.
__device__ __forceinline__ TriHit tri_intersect(V3 o, V3 d, float t_max, V3 p0, V3 p1, V3 p2) {
    float adx = fabsf(d.x), ady = fabsf(d.y), adz = fabsf(d.z);
    bool is0 = (adx >= ady) && (adx >= adz);
    bool is1 = !is0 && (ady >= adz);
    // kz=0 -> (y,z,x); kz=1 -> (z,x,y); kz=2 -> (x,y,z)
    auto perm = [&](V3 c) {
        return V3{is0 ? c.y : (is1 ? c.z : c.x), is0 ? c.z : (is1 ? c.x : c.y),
                  is0 ? c.x : (is1 ? c.y : c.z)};
    };
    V3 dp = perm(d);
    float sz = 1.0f / dp.z;
    float sx = -dp.x * sz;
    float sy = -dp.y * sz;
    auto shear = [&](V3 p) {
        V3 q = perm(p - o);
        return V3{q.x + sx * q.z, q.y + sy * q.z, q.z * sz};
    };
    V3 a = shear(p0), b = shear(p1), c = shear(p2);
    float e0 = edge_fn(b.x, b.y, c.x, c.y);
    float e1 = edge_fn(c.x, c.y, a.x, a.y);
    float e2 = edge_fn(a.x, a.y, b.x, b.y);
    bool same_sign = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                     (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
    float det = e0 + e1 + e2;
    bool nonzero = det != 0.0f;
    float inv_det = 1.0f / (nonzero ? det : 1.0f);
    float t = (e0 * a.z + e1 * b.z + e2 * c.z) * inv_det;
    float max_zt = fmaxf(fmaxf(fabsf(a.z), fabsf(b.z)), fabsf(c.z));
    float max_xt = fmaxf(fmaxf(fabsf(a.x), fabsf(b.x)), fabsf(c.x));
    float max_yt = fmaxf(fmaxf(fabsf(a.y), fabsf(b.y)), fabsf(c.y));
    float max_e = fmaxf(fmaxf(fabsf(e0), fabsf(e1)), fabsf(e2));
    float delta_z = kGamma3 * max_zt;
    float delta_x = kGamma5 * (max_xt + max_zt);
    float delta_y = kGamma5 * (max_yt + max_zt);
    float delta_e = 2.0f * (kGamma2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt);
    float delta_t =
        3.0f * (kGamma3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e) * fabsf(inv_det);
    TriHit h;
    h.hit = same_sign && nonzero && (t > delta_t) && (t < t_max);
    h.t = t;
    h.b0 = e0 * inv_det;
    h.b1 = e1 * inv_det;
    h.b2 = e2 * inv_det;
    return h;
}

// the word hash of core/rng.py hash_u32: a murmur3-style finalizer over the
// words in turn (K3's samplers, K18's noise lattice)
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

__device__ __forceinline__ uint32_t hash_step(uint32_t h, uint32_t w) {
    return mix32(h ^ w) + 0x7F4A7C15u;
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
    return mix32(hash_step(hash_step(hash_step(0x9E3779B9u, a), b), c));
}

__device__ __forceinline__ uint32_t hash4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
    return mix32(hash_step(hash_step(hash_step(hash_step(0x9E3779B9u, a), b), c), d));
}

__device__ __forceinline__ uint32_t hash5(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                          uint32_t e) {
    return mix32(hash_step(hash_step(hash_step(hash_step(hash_step(0x9E3779B9u, a), b), c), d), e));
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace rt
