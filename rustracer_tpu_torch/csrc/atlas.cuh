// Device code shared by K5 (atlas.cu, the atlas EWA lookup) and K10
// (atlas_bwd.cu, its backward): the texel addressing of both layouts, the
// bilinear filter and a lookup's set-up (registration, st mapping, major
// and minor axes, mip levels), in the reference's operation order
// (rustracer_tpu/scene/atlas.py atlas_lookup_ewa, :174-230). K17
// (mipmap.cu) and K20 (mipmap_bwd.cu) read and address texels through the
// same wrap and footprint code, so a backward adds into the rows its
// forward read.
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

// a mod n for n > 0, in [0, n): a mask where n is a power of two, else
// one remainder
__device__ __forceinline__ int floor_mod(int a, int n) {
    if ((n & (n - 1)) == 0) return a & (n - 1);
    int r = a % n;
    return r < 0 ? r + n : r;
}

__device__ __forceinline__ Level level_of(const int* meta, int lmax, int img, int li) {
    const int* m = meta + 3 * (img * lmax + li);
    return {__ldg(m), __ldg(m + 1), __ldg(m + 2)};
}

// the column (or row) that coordinate a of a side of n texels reads under
// wrap: WRAP_REPEAT (0) a floor modulo, WRAP_BLACK (1) and WRAP_CLAMP (2)
// a clamp (BLACK reads zeros outside the level)
__device__ __forceinline__ int wrap_coord(int a, int n, int wrap) {
    return wrap == 0 ? floor_mod(a, n) : min(max(a, 0), n - 1);
}

// the atlas row of texel (s_i, t_i) of lv (_texel_at), -1 where WRAP_BLACK
// reads zeros; K10 and K20 add a texel's gradient into this row
__device__ __forceinline__ int texel_index(Level lv, int wrap, int s_i, int t_i) {
    if (wrap == 1 && !(s_i >= 0 && s_i < lv.w && t_i >= 0 && t_i < lv.h)) return -1;
    return lv.off + wrap_coord(t_i, lv.h, wrap) * lv.w + wrap_coord(s_i, lv.w, wrap);
}

// the texel of row `row` of rows of STRIDE floats (their first three), or
// zeros
template <int STRIDE>
__device__ __forceinline__ Tex texel_row(const float* texels, long long row, bool zero) {
    if (zero) return {0.0f, 0.0f, 0.0f};
    const float* p = texels + STRIDE * row;
    return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// one wrapped texel of the atlas (_texel_at): rows of STRIDE floats whose
// first three are the texel, 3 for the (T, 3) layout, 12 for the quad rows
template <int STRIDE = 3>
__device__ __forceinline__ Tex texel_at(const float* texels, Level lv, int wrap, int s_i, int t_i) {
    int row = texel_index(lv, wrap, s_i, t_i);
    return texel_row<STRIDE>(texels, row, row < 0);
}

// the columns (or rows) that coordinates a and a + 1 of a side of n texels
// read under wrap (one floor modulo for both), and whether each lies
// inside the side
struct Pair {
    int i0, i1;
    bool in0, in1;
};

__device__ __forceinline__ Pair wrap_pair(int a, int n, int wrap) {
    Pair p;
    if (wrap == 0) {
        p.i0 = floor_mod(a, n);
        p.i1 = p.i0 + 1 == n ? 0 : p.i0 + 1;
    } else {
        p.i0 = min(max(a, 0), n - 1);
        p.i1 = min(max(a + 1, 0), n - 1);
    }
    p.in0 = a >= 0 && a < n;
    p.in1 = a + 1 >= 0 && a + 1 < n;
    return p;
}

// the 2 x 2 texels v00, v10, v01, v11 whose first is (s0, t0) of lv, in
// rows of STRIDE floats: one quad row (three 16-byte loads; a texel and
// its REPEAT neighbours right, below and diagonal: atlas_quad_texels)
// where the rows are quad rows and hold these four (REPEAT, or a
// footprint inside the level), else four texels, each coordinate wrapped
// once (wrap_pair)
template <int STRIDE>
__device__ __forceinline__ void footprint(const float* texels, Level lv, int wrap, int s0, int t0,
                                          Tex (&v)[4]) {
    Pair ps = wrap_pair(s0, lv.w, wrap), pt = wrap_pair(t0, lv.h, wrap);
    if (STRIDE == 12 && (wrap == 0 || (ps.in0 && ps.in1 && pt.in0 && pt.in1))) {
        const float4* q = reinterpret_cast<const float4*>(
            texels + 12 * (long long)(lv.off + pt.i0 * lv.w + ps.i0));
        float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
        v[0] = {a.x, a.y, a.z};
        v[1] = {a.w, b.x, b.y};
        v[2] = {b.z, b.w, c.x};
        v[3] = {c.y, c.z, c.w};
        return;
    }
    long long r0 = lv.off + pt.i0 * lv.w, r1 = lv.off + pt.i1 * lv.w;
    bool black = wrap == 1;
    v[0] = texel_row<STRIDE>(texels, r0 + ps.i0, black && !(ps.in0 && pt.in0));
    v[1] = texel_row<STRIDE>(texels, r0 + ps.i1, black && !(ps.in1 && pt.in0));
    v[2] = texel_row<STRIDE>(texels, r1 + ps.i0, black && !(ps.in0 && pt.in1));
    v[3] = texel_row<STRIDE>(texels, r1 + ps.i1, black && !(ps.in1 && pt.in1));
}

// bilinear filtering of one level at st (_bilerp_at / _bilerp_at_quad) in
// rows of STRIDE floats (footprint). K5 reads quad rows only where every
// registration wraps REPEAT, and calls this with wrap 0 for them
template <int STRIDE>
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
    Tex v[4];
    footprint<STRIDE>(texels, lv, wrap, s0, t0, v);
    return {w00 * v[0].r + w10 * v[1].r + w01 * v[2].r + w11 * v[3].r,
            w00 * v[0].g + w10 * v[1].g + w01 * v[2].g + w11 * v[3].g,
            w00 * v[0].b + w10 * v[1].b + w01 * v[2].b + w11 * v[3].b};
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
