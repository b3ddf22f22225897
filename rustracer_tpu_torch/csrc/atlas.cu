// K5: per-lane EWA texture lookup through the shared mip atlas.
//
// Replaces rustracer_tpu/scene/atlas.py atlas_lookup_ewa (:174-230) with
// _bilerp_at_quad (:156) for the (T, 12) quad-row layout and _bilerp_at /
// _texel_at (:139, :124) for the (T, 3) layout with its three wrap modes.
// One thread per lane: the registration lookup, the st mapping, the major
// and minor axes, the mip level, then 8 taps x 2 levels of bilinear
// filtering, the weight normalisation, reg_scale and the reg < 0 mask, in
// the reference's operation order (the library is built with -fmad=false;
// log2f and floorf as the plain version's torch.log2 and torch.floor).
//
// Bound: dependent-load latency and instruction issue, not device-memory
// bytes. A lane reads 16 quad rows (48 bytes each) or 64 texels, but the
// hero atlas is a 128^2 pyramid of about 21.8k texels (about 1 MB as quad
// rows, 262 KB as texels) that stays in L2 and mostly in L1; the design
// reads tables through the read-only path (__ldg), keeps each lane's work in
// registers, and loads a quad row as three float4s.
#include "common.cuh"

namespace {

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
    float w[8];
};

template <bool QUAD>
__global__ void atlas_ewa_kernel(const float* __restrict__ texels, const int* __restrict__ meta,
                                 int lmax, const int* __restrict__ levels,
                                 const int* __restrict__ reg_img, const float* __restrict__ reg_map,
                                 const float* __restrict__ reg_scale,
                                 const int* __restrict__ reg_wrap, const int* __restrict__ reg,
                                 const float* __restrict__ uv, const float* __restrict__ dudx,
                                 const float* __restrict__ dvdx, const float* __restrict__ dudy,
                                 const float* __restrict__ dvdy, int n, Taps taps, float wsum,
                                 float* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int rg = reg[i];
    int r = max(rg, 0);
    int img = __ldg(reg_img + r);
    float su = __ldg(reg_map + 4 * r), sv = __ldg(reg_map + 4 * r + 1);
    float du = __ldg(reg_map + 4 * r + 2), dv = __ldg(reg_map + 4 * r + 3);
    int wrap = __ldg(reg_wrap + r);
    float st_s = uv[2 * i] * su + du;
    float st_t = uv[2 * i + 1] * sv + dv;
    float d0s = dudx[i] * su, d0t = dvdx[i] * sv;
    float d1s = dudy[i] * su, d1t = dvdy[i] * sv;
    float len0 = sqrtf(fmaxf(d0s * d0s + d0t * d0t, 1e-24f));
    float len1 = sqrtf(fmaxf(d1s * d1s + d1t * d1t, 1e-24f));
    bool major_is_0 = len0 >= len1;
    float major_len = fmaxf(len0, len1);
    float minor_len = fminf(len0, len1);
    float ms = major_is_0 ? d0s : d1s;
    float mt = major_is_0 ? d0t : d1t;
    minor_len = fmaxf(minor_len, major_len / 8.0f);  // MAX_ANISOTROPY

    int big_l = __ldg(levels + img);
    float top = (float)(big_l - 1);
    float level = top + log2f(fmaxf(minor_len, 1e-8f));
    level = fminf(fmaxf(level, 0.0f), top);
    int l0 = (int)floorf(level);
    int l1 = min(l0 + 1, big_l - 1);
    float dl = level - (float)l0;
    Level lv0 = level_of(meta, lmax, img, l0);
    Level lv1 = level_of(meta, lmax, img, l1);

    float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        float a = ((float)k + 0.5f) / 8.0f - 0.5f;  // exact in float32
        float sk = st_s + a * ms;
        float tk = st_t + a * mt;
        Tex b0 = bilerp<QUAD>(texels, lv0, wrap, sk, tk);
        Tex b1 = bilerp<QUAD>(texels, lv1, wrap, sk, tk);
        float wk = taps.w[k];
        acc_r = acc_r + wk * ((1.0f - dl) * b0.r + dl * b1.r);
        acc_g = acc_g + wk * ((1.0f - dl) * b0.g + dl * b1.g);
        acc_b = acc_b + wk * ((1.0f - dl) * b0.b + dl * b1.b);
    }
    float sc = __ldg(reg_scale + r);
    bool keep = rg >= 0;
    out[3 * i] = keep ? acc_r / wsum * sc : 0.0f;
    out[3 * i + 1] = keep ? acc_g / wsum * sc : 0.0f;
    out[3 * i + 2] = keep ? acc_b / wsum * sc : 0.0f;
}

}  // namespace

extern "C" int rt_atlas_lookup_ewa(const void* texels, int quad, const void* meta, int lmax,
                                   const void* levels, const void* reg_img, const void* reg_map,
                                   const void* reg_scale, const void* reg_wrap, const void* reg,
                                   const void* uv, const void* dudx, const void* dvdx,
                                   const void* dudy, const void* dvdy, int n, float w0, float w1,
                                   float w2, float w3, float w4, float w5, float w6, float w7,
                                   float wsum, void* out, void* stream) {
    constexpr int kThreads = 128;
    Taps taps = {{w0, w1, w2, w3, w4, w5, w6, w7}};
    auto kernel = quad ? atlas_ewa_kernel<true> : atlas_ewa_kernel<false>;
    kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)texels, (const int*)meta, lmax, (const int*)levels, (const int*)reg_img,
        (const float*)reg_map, (const float*)reg_scale, (const int*)reg_wrap, (const int*)reg,
        (const float*)uv, (const float*)dudx, (const float*)dvdx, (const float*)dudy,
        (const float*)dvdy, n, taps, wsum, (float*)out);
    return (int)cudaGetLastError();
}
