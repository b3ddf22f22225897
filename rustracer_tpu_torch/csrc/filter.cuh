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
// and K9 evaluate each axis once a sample (axis_taps; Filter.axis_weights
// in render/filters.py is the plain twin). Mitchell's d / r is a multiply
// by 1 / r where r is a power of two (PBRT's radius 2), the same bits as
// the divide.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace rt {

enum FilterKind : int { kBox = 0, kTriangle = 1, kGaussian = 2, kMitchell = 3 };

struct FilterParams {
    float rx, ry;
    float p[8];  // gaussian: -alpha, expv_x, expv_y; mitchell: i3 i2 i0 o3 o2 o1 o0
    // 1 / rx and 1 / ry where the radius is a power of two (then d * inv
    // is d / r, bit for bit: the same real number, rounded once), else 0
    float inv_rx, inv_ry;
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
    const float inv = Axis == 0 ? f.inv_rx : f.inv_ry;
    if (inv != 0.0f) return mitchell_1d(f, d * inv);
    return mitchell_1d(f, d / r);
}

// weight at offset (dx, dy) from the sample point; 0 outside the extent
template <int Kind>
__device__ __forceinline__ float filter_weight(const FilterParams& f, float dx, float dy) {
    float w = Kind == kBox ? 1.0f : axis_weight<Kind, 0>(f, dx) * axis_weight<Kind, 1>(f, dy);
    return (fabsf(dx) <= f.rx && fabsf(dy) <= f.ry) ? w : 0.0f;
}

// K4 and K9 keep a footprint of up to kMaxAxisTaps x kMaxAxisTaps taps in
// registers (PBRT's radius 2: 4 x 4); a wider one walks filter_weight tap
// by tap
constexpr int kMaxAxisTaps = 4;

// kMaxAxisTaps weights of one axis as scalars (no array, so nothing goes to
// local memory): at(k) folds to one register for a constant k and is 4
// selects for a k known at run time
struct AxisTaps {
    float v0, v1, v2, v3;
    __device__ __forceinline__ float at(int k) const {
        return k == 0 ? v0 : k == 1 ? v1 : k == 2 ? v2 : k == 3 ? v3 : 0.0f;
    }
};
static_assert(kMaxAxisTaps == 4, "AxisTaps holds 4 weights");

// the weights of axis Axis at offsets lo + k + 0.5 - p (0 beyond the
// footprint's n taps and outside the extent). A tap's weight is
// wx.at(k) * wy.at(j): inside the extent the product filter_weight forms,
// bit for bit; outside it +-0, which the tap's test fw > 0 drops as
// filter_weight's 0 is dropped
template <int Kind, int Axis>
__device__ __forceinline__ AxisTaps axis_taps(const FilterParams& f, int lo, float p, int n) {
    const float r = Axis == 0 ? f.rx : f.ry;
    // (float)(lo + k) + 0.5f, exactly: pixel coordinates are far below 2^22
    const float flo = (float)lo;
    float v[kMaxAxisTaps];
#pragma unroll
    for (int k = 0; k < kMaxAxisTaps; ++k) {
        float d = (flo + ((float)k + 0.5f)) - p;
        v[k] = (k < n && fabsf(d) <= r) ? axis_weight<Kind, Axis>(f, d) : 0.0f;
    }
    return {v[0], v[1], v[2], v[3]};
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

// 1 / r for a radius r that is a power of two, else 0
inline float power_of_two_inverse(float r) {
    int e;
    return frexpf(r, &e) == 0.5f ? ldexpf(1.0f, 1 - e) : 0.0f;
}

inline FilterParams filter_params(float rx, float ry, const float* p8) {
    FilterParams f;
    f.rx = rx;
    f.ry = ry;
    for (int i = 0; i < 8; ++i) f.p[i] = p8[i];
    f.inv_rx = power_of_two_inverse(rx);
    f.inv_ry = power_of_two_inverse(ry);
    return f;
}

}  // namespace rt
