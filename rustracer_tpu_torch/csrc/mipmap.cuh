// Device code shared by K17 (mipmap.cu, the per-texture lookups) and K20
// (mipmap_bwd.cu, their texel gradient): each mode's set-up, the levels
// and footprint a lane's lookup reads, in the plain versions' operation
// order (rustracer_tpu_torch/ops/mipmap.py tri_levels, ewa_axes, ellipse,
// ellipse_tap). One copy of it makes the backward pick the forward's
// levels, axes and taps on every lane.
#pragma once

#include "atlas.cuh"

namespace rt_mip {

using rt_atlas::Level;

__device__ __forceinline__ Level level(const int* meta, int li) {
    const int* m = meta + 3 * li;
    return {__ldg(m), __ldg(m + 1), __ldg(m + 2)};
}

// a trilinear lookup of filter width `width`: its two levels and the blend
struct Tri {
    int l0, l1;
    float dl;
};

__device__ __forceinline__ Tri tri_levels(int n_levels, float width) {
    float top = (float)(n_levels - 1);
    float lev = fminf(fmaxf(top + log2f(fmaxf(width, 1e-8f)), 0.0f), top);
    int l0 = (int)floorf(lev);
    return {l0, min(l0 + 1, n_levels - 1), lev - (float)l0};
}

// the 8-tap lookup's major axis and minor length (raised so that
// major/minor <= max_aniso)
struct Axes {
    float ms, mt, minor_len;
};

__device__ __forceinline__ Axes ewa_axes(float d0s, float d0t, float d1s, float d1t,
                                         float max_aniso) {
    float len0 = sqrtf(fmaxf(d0s * d0s + d0t * d0t, 1e-24f));
    float len1 = sqrtf(fmaxf(d1s * d1s + d1t * d1t, 1e-24f));
    bool major_is_0 = len0 >= len1;
    float major_len = major_is_0 ? len0 : len1;
    float minor_len = major_is_0 ? len1 : len0;
    return {major_is_0 ? d0s : d1s, major_is_0 ? d0t : d1t,
            fmaxf(minor_len, major_len / max_aniso)};
}

// tap k's offset along the major axis
__device__ __forceinline__ float tap_offset(int k) { return ((float)k + 0.5f) / 8.0f - 0.5f; }

// the exact lookup's footprint at its rounded level: the texel-space
// centre, the implicit ellipse A x^2 + B x y + C y^2 < 1, its bounding
// box's first texel and width, and the box's taps visited (at most 128)
struct Ellipse {
    Level lv;
    float px, py, A, B, C;
    int s0, t0, wu, n_taps;
};

__device__ __forceinline__ Ellipse ellipse(const int* meta, int n_levels, float max_aniso, float s,
                                           float t, float d0s, float d0t, float d1s, float d1t) {
    float len0 = sqrtf(fmaxf(d0s * d0s + d0t * d0t, 1e-24f));
    float len1 = sqrtf(fmaxf(d1s * d1s + d1t * d1t, 1e-24f));
    bool swap = len1 > len0;
    float mjs = swap ? d1s : d0s, mjt = swap ? d1t : d0t;
    float mns = swap ? d0s : d1s, mnt = swap ? d0t : d1t;
    float major_len = fmaxf(len0, len1);
    float minor_len = fminf(len0, len1);
    float scale = minor_len * max_aniso < major_len
                      ? major_len / (minor_len * max_aniso + 1e-24f)
                      : 1.0f;
    mns = mns * scale;
    mnt = mnt * scale;
    minor_len = minor_len * scale;
    float top = (float)(n_levels - 1);
    float lod = fminf(fmaxf(top + log2f(fmaxf(minor_len, 1e-8f)), 0.0f), top);
    Ellipse e;
    e.lv = level(meta, (int)rintf(lod));
    float wf = (float)e.lv.w, hf = (float)e.lv.h;
    float d0x = mjs * wf, d0y = mjt * hf, d1x = mns * wf, d1y = mnt * hf;
    e.px = s * wf - 0.5f;
    e.py = t * hf - 0.5f;
    float A = d0y * d0y + d1y * d1y + 1.0f;
    float Bc = -2.0f * (d0x * d0y + d1x * d1y);
    float Cc = d0x * d0x + d1x * d1x + 1.0f;
    float inv_f = 1.0f / fmaxf(A * Cc - Bc * Bc * 0.25f, 1e-12f);
    e.A = A * inv_f;
    e.B = Bc * inv_f;
    e.C = Cc * inv_f;
    float det = fmaxf(-e.B * e.B + 4.0f * e.A * e.C, 1e-12f);
    float u_r = sqrtf(fmaxf(e.C * det, 0.0f)) * 2.0f / det;
    float v_r = sqrtf(fmaxf(e.A * det, 0.0f)) * 2.0f / det;
    e.s0 = (int)ceilf(e.px - u_r);
    int s1 = (int)floorf(e.px + u_r);
    e.t0 = (int)ceilf(e.py - v_r);
    int t1 = (int)floorf(e.py + v_r);
    e.wu = max(s1 - e.s0 + 1, 1);
    int wv = max(t1 - e.t0 + 1, 1);
    long long n_box = (long long)e.wu * (long long)wv;
    e.n_taps = n_box < 128 ? (int)n_box : 128;
    return e;
}

// tap k of the box: its texel (*ss, *tt) and r^2 (inside where < 1)
__device__ __forceinline__ float ellipse_tap(const Ellipse& e, int k, int* ss, int* tt) {
    *ss = e.s0 + k % e.wu;
    *tt = e.t0 + k / e.wu;
    float du = (float)*ss - e.px, dv = (float)*tt - e.py;
    return e.A * du * du + e.B * du * dv + e.C * dv * dv;
}

}  // namespace rt_mip
