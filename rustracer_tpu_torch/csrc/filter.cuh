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
// per kind (a template argument), so the box keeps its one comparison.
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

// weight at offset (dx, dy) from the sample point; 0 outside the extent
template <int Kind>
__device__ __forceinline__ float filter_weight(const FilterParams& f, float dx, float dy) {
    float w;
    if (Kind == kBox) {
        w = 1.0f;
    } else if (Kind == kTriangle) {
        w = fmaxf(f.rx - fabsf(dx), 0.0f) * fmaxf(f.ry - fabsf(dy), 0.0f);
    } else if (Kind == kGaussian) {
        float gx = fmaxf(expf(f.p[0] * dx * dx) - f.p[1], 0.0f);
        float gy = fmaxf(expf(f.p[0] * dy * dy) - f.p[2], 0.0f);
        w = gx * gy;
    } else {
        w = mitchell_1d(f, dx / f.rx) * mitchell_1d(f, dy / f.ry);
    }
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
