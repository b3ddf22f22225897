// K4: filter-weighted splat of a sample batch into the film, one thread per
// sample, atomicAdd into the (H, W, 3) radiance and (H, W) weight sums.
//
// Replaces rustracer_tpu/render/film.py Film.add_samples (:67-111): the
// luminance clamp, the nx x ny filter footprint, the valid mask and the crop
// bounds. Only the box filter is ported (weight 1 inside its extent); the
// footprint loop is general. Sums are taken in no fixed order, so results
// agree with the plain version to float rounding, not bit for bit.
//
// Bound: atomics into device memory (4 per tap; one tap for box 0.5), with
// neighbouring samples of a tile landing on neighbouring pixels; the design
// reads each sample once and issues its taps without staging.
#include "common.cuh"

namespace {

__global__ void film_add_kernel(const float* __restrict__ p_film, const float* __restrict__ rad,
                                const bool* __restrict__ valid, int n, float* __restrict__ rgb,
                                float* __restrict__ wsum, int h, int w, int x0, int y0, float rx,
                                float ry, int nx, int ny, float max_lum) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (valid != nullptr && !valid[i]) return;
    float fx = p_film[2 * i], fy = p_film[2 * i + 1];
    float r = rad[3 * i], g = rad[3 * i + 1], b = rad[3 * i + 2];
    if (isfinite(max_lum)) {
        float lum = r * 0.212671f + g * 0.715160f + b * 0.072169f;
        float scale = lum > max_lum ? max_lum / fmaxf(lum, 1e-20f) : 1.0f;
        r = r * scale;
        g = g * scale;
        b = b * scale;
    }
    int lo_x = (int)ceilf((fx - 0.5f) - rx);
    int lo_y = (int)ceilf((fy - 0.5f) - ry);
    for (int j = 0; j < ny; ++j) {
        for (int k = 0; k < nx; ++k) {
            int px = lo_x + k, py = lo_y + j;
            float dx = ((float)px + 0.5f) - fx;
            float dy = ((float)py + 0.5f) - fy;
            // box filter: weight 1 within the filter extent
            float fw = (fabsf(dx) <= rx && fabsf(dy) <= ry) ? 1.0f : 0.0f;
            int ix = px - x0, iy = py - y0;
            if (ix < 0 || ix >= w || iy < 0 || iy >= h || !(fw > 0.0f)) continue;
            float* pix = rgb + 3 * ((size_t)iy * w + ix);
            atomicAdd(pix, fw * r);
            atomicAdd(pix + 1, fw * g);
            atomicAdd(pix + 2, fw * b);
            atomicAdd(wsum + (size_t)iy * w + ix, fw);
        }
    }
}

}  // namespace

extern "C" int rt_film_add_samples(const void* p_film, const void* rad, const void* valid, int n,
                                   void* rgb, void* wsum, int h, int w, int x0, int y0, float rx,
                                   float ry, int nx, int ny, float max_lum, void* stream) {
    constexpr int kThreads = 256;
    film_add_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)p_film, (const float*)rad, (const bool*)valid, n, (float*)rgb,
        (float*)wsum, h, w, x0, y0, rx, ry, nx, ny, max_lum);
    return (int)cudaGetLastError();
}
