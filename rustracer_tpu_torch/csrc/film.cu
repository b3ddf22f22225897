// K4: filter-weighted splat of a sample batch into the film, one thread per
// sample, one 16-byte vector reduction per filter tap.
//
// Replaces rustracer_tpu/render/film.py Film.add_samples (:67-111): the
// luminance clamp, the nx x ny filter footprint, the valid mask and the crop
// bounds. Every filter of the reference: the box (weight 1 inside its
// extent) and the triangle, Gaussian and Mitchell weights of
// csrc/filter.cuh over a footprint of ceil(2r)^2 taps, the kernel built
// once per kind. Taps of a filter wider than the box 0.5 overlap other
// samples' taps, so the sums stay atomic. Sums are taken in no fixed order:
// a pixel that receives at most two taps into a zero film is bit for bit
// the plain version's (a + b == b + a), more agree to float rounding.
//
// Bound: bytes. The samples are read once (p_film 8, radiance 12, valid 1
// byte a lane) and each pixel a tap lands on is read and written once in
// L2 by its reduction; with the film out of L2, as in the render, each
// touched line also comes in from device memory. The film is one (H, W, 4)
// float32 buffer, r, g, b and the weight side by side in 16 bytes, so a tap
// is one red.global.add.v4.f32 (atomicAdd(float4*, float4), global memory,
// compute capability 9.x): a warp's taps on a row touch their 16 sectors
// once, where four scalar reductions into an (H, W, 3) and an (H, W) array
// touched 12 sectors three times and 4 once. p_film is read as one float2 a
// lane and the radiance as three words: a warp's three loads cover its 384
// contiguous bytes, each sector once in L1 (staging the block's radiance
// through shared memory, so that each load instruction reads 128
// contiguous bytes, measured slower: it adds a barrier before any lane can
// issue its reductions).
#include "common.cuh"
#include "filter.cuh"

namespace {

constexpr int kThreads = 256;

template <int Kind>
__global__ void __launch_bounds__(kThreads)
    film_add_kernel(const float2* __restrict__ p_film, const float* __restrict__ rad,
                    const bool* __restrict__ valid, int n, float4* __restrict__ acc, int h,
                    int w, int x0, int y0, rt::FilterParams f, int nx, int ny, float max_lum) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    if (valid != nullptr && !valid[i]) return;
    float2 p = p_film[i];
    float r = rad[3 * i], g = rad[3 * i + 1], b = rad[3 * i + 2];
    if (isfinite(max_lum)) {
        float lum = r * 0.212671f + g * 0.715160f + b * 0.072169f;
        float scale = lum > max_lum ? max_lum / fmaxf(lum, 1e-20f) : 1.0f;
        r = r * scale;
        g = g * scale;
        b = b * scale;
    }
    int lo_x = (int)ceilf((p.x - 0.5f) - f.rx);
    int lo_y = (int)ceilf((p.y - 0.5f) - f.ry);
    for (int j = 0; j < ny; ++j) {
        for (int k = 0; k < nx; ++k) {
            int px = lo_x + k, py = lo_y + j;
            float dx = ((float)px + 0.5f) - p.x;
            float dy = ((float)py + 0.5f) - p.y;
            float fw = rt::filter_weight<Kind>(f, dx, dy);
            int ix = px - x0, iy = py - y0;
            if (ix < 0 || ix >= w || iy < 0 || iy >= h || !(fw > 0.0f)) continue;
            atomicAdd(acc + ((size_t)iy * w + ix), make_float4(fw * r, fw * g, fw * b, fw));
        }
    }
}

template <int Kind>
struct LaunchAdd {
    void operator()(const void* p_film, const void* rad, const void* valid, int n, void* rgb,
                    int h, int w, int x0, int y0, rt::FilterParams f, int nx, int ny,
                    float max_lum, cudaStream_t stream) {
        film_add_kernel<Kind><<<rt::blocks_for(n, kThreads), kThreads, 0, stream>>>(
            (const float2*)p_film, (const float*)rad, (const bool*)valid, n, (float4*)rgb, h, w,
            x0, y0, f, nx, ny, max_lum);
    }
};

}  // namespace

// rgb: the (H, W, 4) film's base, 16-byte aligned; wsum: the same buffer
// plus 3 floats (the (H, W, 3) and (H, W) views of the film state). Any
// other layout, or an unknown filter kind, is refused with
// cudaErrorInvalidValue. kind and p0..p7: Filter.kernel_params.
extern "C" int rt_film_add_samples(const void* p_film, const void* rad, const void* valid, int n,
                                   void* rgb, void* wsum, int h, int w, int x0, int y0, float rx,
                                   float ry, int nx, int ny, float max_lum, int kind, float p0,
                                   float p1, float p2, float p3, float p4, float p5, float p6,
                                   float p7, void* stream) {
    if ((uintptr_t)rgb % 16 || (float*)wsum != (float*)rgb + 3 || (uintptr_t)p_film % 8)
        return (int)cudaErrorInvalidValue;
    const float p8[8] = {p0, p1, p2, p3, p4, p5, p6, p7};
    return rt::dispatch_filter<LaunchAdd>(kind, p_film, rad, valid, n, rgb, h, w, x0, y0,
                                          rt::filter_params(rx, ry, p8), nx, ny, max_lum,
                                          (cudaStream_t)stream);
}

// the film layout this source takes: 4 floats a pixel in one buffer
extern "C" int rt_film_channels() { return 4; }
// the filter kinds this source takes (csrc/filter.cuh): box, triangle,
// Gaussian, Mitchell
extern "C" int rt_film_filter_kinds() { return 4; }
