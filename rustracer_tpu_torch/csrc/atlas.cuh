// Device code shared by K5 (atlas.cu, the atlas EWA lookup) and K10
// (atlas_bwd.cu, its backward): the texel addressing of both layouts, the
// bilinear filter and a lookup's set-up (registration, st mapping, major
// and minor axes, mip levels), in the reference's operation order
// (rustracer_tpu/scene/atlas.py atlas_lookup_ewa, :174-230).
#pragma once

#include "common.cuh"

namespace rt_atlas {

constexpr int kTaps = 8;  // atlas.py N_TAPS

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

// one wrapped texel of the atlas (_texel_at): rows of STRIDE floats whose
// first three are the texel, 3 for the (T, 3) layout, 12 for the quad rows
// (K17 reads single texels of either)
template <int STRIDE = 3>
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
    const float* p = texels + STRIDE * (long long)(lv.off + t_f * lv.w + s_f);
    return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// bilinear filtering of one level at st (_bilerp_at / _bilerp_at_quad);
// without QUAD, the four texels of rows of STRIDE floats (texel_at)
template <bool QUAD, int STRIDE = 3>
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
        v00 = texel_at<STRIDE>(texels, lv, wrap, s0, t0);
        v10 = texel_at<STRIDE>(texels, lv, wrap, s0 + 1, t0);
        v01 = texel_at<STRIDE>(texels, lv, wrap, s0, t0 + 1);
        v11 = texel_at<STRIDE>(texels, lv, wrap, s0 + 1, t0 + 1);
    }
    return {w00 * v00.r + w10 * v10.r + w01 * v01.r + w11 * v11.r,
            w00 * v00.g + w10 * v10.g + w01 * v01.g + w11 * v11.g,
            w00 * v00.b + w10 * v10.b + w01 * v01.b + w11 * v11.b};
}

struct Taps {
    float w[kTaps];
};

// what every tap of one lookup needs: its registration, st and major axis,
// the two levels and the blend between them
struct Lookup {
    int r, wrap;
    float st_s, st_t, ms, mt, dl;
    Level lv0, lv1;
};

// ``A``: the kernel's arguments (fields reg, reg_img, reg_map, reg_wrap, uv,
// dudx, dvdx, dudy, dvdy, levels, meta, lmax)
template <class A>
__device__ __forceinline__ Lookup set_up(const A& g, long long i) {
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

}  // namespace rt_atlas
