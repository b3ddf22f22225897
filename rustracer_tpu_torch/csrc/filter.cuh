// Reconstruction filter weights shared by K4 (csrc/film.cu) and its
// transpose K9 (csrc/film_bwd.cu).
//
// The weights of rustracer_tpu/render/filters.py Filter.evaluate (:31-55),
// op for op in the reference's order, as render/filters.py's plain version
// computes them: box, triangle, Gaussian and Mitchell-Netravali. The host
// (Filter.kernel_params) hands over the constants the reference rounds to
// float32 where they meet a float32 array: the Gaussian's -alpha and its
// two edge values exp(-alpha r^2) (computed in float64), Mitchell's seven
// polynomial coefficients (computed in float64). Each kernel is built once
// per kind (a template argument), so the box keeps its one comparison. A
// weight is the product of two 1-D factors (axis_weight), x times y, so K4
// can evaluate each axis once a sample (Filter.axis_weights in
// render/filters.py is the plain twin).
#pragma once

#include <cuda_runtime.h>

namespace rt {

enum FilterKind : int { kBox = 0, kTriangle = 1, kGaussian = 2, kMitchell = 3 };

struct FilterParams {
    float rx, ry;
    float p[8];  // gaussian: -alpha, expv_x, expv_y; mitchell: i3 i2 i0 o3 o2 o1 o0
};

__device__ __forceinline__ float mitchell_1d(const FilterParams& f, float x) {
    x = fabsf(2.0f * x);
    float x2 = x * x;
    float x3 = x2 * x;
    const float sixth = (float)(1.0 / 6.0);
    float inner = (f.p[0] * x3 + f.p[1] * x2 + f.p[2]) * sixth;
    float outer = (f.p[3] * x3 + f.p[4] * x2 + f.p[5] * x + f.p[6]) * sixth;
    return x > 1.0f ? (x > 2.0f ? 0.0f : outer) : inner;
}

// the 1-D factor of axis Axis (0: x, 1: y) at offset d from the sample
// point, inside the extent; the weight is the x factor times the y factor
template <int Kind, int Axis>
__device__ __forceinline__ float axis_weight(const FilterParams& f, float d) {
    const float r = Axis == 0 ? f.rx : f.ry;
    if (Kind == kBox) return 1.0f;
    if (Kind == kTriangle) return fmaxf(r - fabsf(d), 0.0f);
    if (Kind == kGaussian) return fmaxf(expf(f.p[0] * d * d) - f.p[1 + Axis], 0.0f);
    return mitchell_1d(f, d / r);
}

// weight at offset (dx, dy) from the sample point; 0 outside the extent
template <int Kind>
__device__ __forceinline__ float filter_weight(const FilterParams& f, float dx, float dy) {
    float w = Kind == kBox ? 1.0f : axis_weight<Kind, 0>(f, dx) * axis_weight<Kind, 1>(f, dy);
    return (fabsf(dx) <= f.rx && fabsf(dy) <= f.ry) ? w : 0.0f;
}

// launch a kernel templated on the filter kind: F<Kind> is a functor
// template whose operator() launches; -> cudaErrorInvalidValue for an
// unknown kind
template <template <int> class Launch, typename... Args>
inline int dispatch_filter(int kind, Args... args) {
    switch (kind) {
        case kBox: Launch<kBox>()(args...); break;
        case kTriangle: Launch<kTriangle>()(args...); break;
        case kGaussian: Launch<kGaussian>()(args...); break;
        case kMitchell: Launch<kMitchell>()(args...); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

inline FilterParams filter_params(float rx, float ry, const float* p8) {
    FilterParams f;
    f.rx = rx;
    f.ry = ry;
    for (int i = 0; i < 8; ++i) f.p[i] = p8[i];
    return f;
}

}  // namespace rt
