// K4: filter-weighted splat of a sample batch into the film, one thread per
// sample, one 16-byte vector reduction per filter tap or, for a filter
// wider than the box in a warp of consecutive pixels, per pixel.
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
//
// The triangle, Gaussian and Mitchell filters (PBRT's radius 2: 16 taps a
// sample) are bound by their reductions, one a tap. Their design: each
// sample evaluates its nx x-weights and ny y-weights once, in registers
// (footprints up to kMaxAxisTaps an axis: filter.cuh's axis_taps, shared
// with K9), a tap's weight their product in filter_weight's order, so the
// weights are its bits. A renderer's warp
// holds 32 consecutive pixels of one row (render/renderer.py builds its
// lanes row-major); the warp checks that (a shuffle and a vote on the
// pixel row and on the pixel column minus the lane) and then, for each row
// its taps reach, sums across its lanes with shuffles the taps that land on
// one pixel (lane t takes lane t - d's radiance and x weight once, its row
// weight a row, and forms its tap) and issues one reduction a pixel: 32 a
// row and the few taps beyond the warp's columns, where the per-tap design
// issued 4 a lane a row. Any other warp (a shuffled order, the ends of a
// row, a footprint wider than kWin) adds tap by tap, each tap's weight from
// filter_weight, as the box does. The warp's sums fall
// in another order than the plain version's: within float rounding (1e-5
// relative).
//
// K4d (film_add_samples_det): the same splat with every pixel's sum in a
// stated fixed order, for the checkpointed render (render/renderer.py
// render_checkpointed), so that a render gives the same bits on every run
// and a resumed render those of an uninterrupted one for every filter (the
// JAX package's checkpointed render is deterministic, render/checkpoint.py
// there). It replaces rustracer_tpu/render/film.py Film.add_samples
// (:67-111) as K4 does: the same taps, filter_weight's weights, luminance
// clamp, valid mask and crop. It takes the renderer's lanes: a tile is a
// contiguous run of the row-major pixels of the film's sample bounds, one
// sample a lane, so the lanes that can reach a pixel are those of the
// pixels within the filter's tap window of it, and their lane index is
// arithmetic. One thread a film pixel of the rows the tile reaches gathers
// its taps from those lanes in ascending lane order (a lane has at most one
// tap on a pixel), sums them from 0 and adds the sum to the pixel once: no
// atomics, each pixel read and written at most once a launch. Its plain
// version (Film.add_samples_det_plain) sums in the same order, so the two
// agree bit for bit. Bound: bytes, as K4's (the samples in, each touched
// pixel read and written once); a lane's sample is read once a pixel of its
// window, from L1 or L2.
#include "common.cuh"
#include "filter.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// the warp sums take taps within kWin pixels of the lane's
constexpr int kWin = 2;

__device__ __forceinline__ float4 scaled(float fw, float r, float g, float b) {
    return make_float4(fw * r, fw * g, fw * b, fw);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float shfl1(float v, int delta) {
    // lane t gets lane t - delta's v (its own outside the warp)
    return delta > 0 ? __shfl_up_sync(kFull, v, delta) : __shfl_down_sync(kFull, v, -delta);
}

// one reduction a tap that lands (inside the crop, weight above 0), the
// weight of each from filter_weight: the box, and any warp of a wider
// filter that cannot sum its taps across its lanes
template <int Kind>
__device__ __forceinline__ void splat_taps(float2 p, float r, float g, float b, float4* acc,
                                           int h, int w, int x0, int y0,
                                           const rt::FilterParams& f, int nx, int ny) {
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
            atomicAdd(acc + ((size_t)iy * w + ix), scaled(fw, r, g, b));
        }
    }
}

template <int Kind>
__global__ void __launch_bounds__(kThreads)
    film_add_kernel(const float2* __restrict__ p_film, const float* __restrict__ rad,
                    const bool* __restrict__ valid, int n, float4* __restrict__ acc, int h,
                    int w, int x0, int y0, rt::FilterParams f, int nx, int ny, float max_lum) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    const bool in = i < n;
    if (Kind == rt::kBox && !in) return;
    const bool live = in && (valid == nullptr || valid[i]);
    if (Kind == rt::kBox && !live) return;
    float2 p = in ? p_film[i] : make_float2(0.0f, 0.0f);
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (in) {
        r = rad[3 * i];
        g = rad[3 * i + 1];
        b = rad[3 * i + 2];
    }
    if (isfinite(max_lum)) {
        float lum = r * 0.212671f + g * 0.715160f + b * 0.072169f;
        float scale = lum > max_lum ? max_lum / fmaxf(lum, 1e-20f) : 1.0f;
        r = r * scale;
        g = g * scale;
        b = b * scale;
    }
    if (Kind == rt::kBox) {
        splat_taps<Kind>(p, r, g, b, acc, h, w, x0, y0, f, nx, ny);
        return;
    }
    // a filter wider than the box: a warp whose lanes hold consecutive
    // pixels of one row, each footprint of at most kMaxAxisTaps taps an axis
    // and within kWin pixels of its own, sums the taps that land on one
    // pixel across its lanes; any other warp adds tap by tap
    const int lo_x = (int)ceilf((p.x - 0.5f) - f.rx);
    const int lo_y = (int)ceilf((p.y - 0.5f) - f.ry);
    const int lane = threadIdx.x & 31;
    const int pix_x = (int)floorf(p.x), pix_y = (int)floorf(p.y);
    const int sx = lo_x - pix_x, sy = lo_y - pix_y;
    const int row = __shfl_sync(kFull, pix_y, 0), col0 = __shfl_sync(kFull, pix_x - lane, 0);
    const bool fits = in && nx <= rt::kMaxAxisTaps && ny <= rt::kMaxAxisTaps &&
                      pix_y == row && pix_x - lane == col0 && sx >= -kWin &&
                      sx + nx - 1 <= kWin && sy >= -kWin && sy + ny - 1 <= kWin;
    if (!__all_sync(kFull, fits)) {
        if (live) splat_taps<Kind>(p, r, g, b, acc, h, w, x0, y0, f, nx, ny);
        return;
    }
    // each axis's weights once a sample (0 outside the footprint and the
    // extent), a tap's weight wx.at(k) * wy.at(j), the product
    // filter_weight forms, bit for bit
    const rt::AxisTaps wx = rt::axis_taps<Kind, 0>(f, lo_x, p.x, nx);
    const rt::AxisTaps wy = rt::axis_taps<Kind, 1>(f, lo_y, p.y, ny);
    // lane t adds, on its own pixel column, the tap of lane t - d at column
    // offset d, for d = -kWin .. kWin: lane t - d's x weight at that offset
    // and its radiance, fetched once (o = d + kWin), and its row weight,
    // fetched a row; the tap's weight is their product, as lane t - d would
    // form it. A lane's tap on a column beyond the warp's 32 goes alone.
    float wo[2 * kWin + 1], nwo[2 * kWin + 1], nr[2 * kWin + 1], ng[2 * kWin + 1],
        nb[2 * kWin + 1];
#pragma unroll
    for (int o = 0; o <= 2 * kWin; ++o) {
        const int d = o - kWin;
        wo[o] = wx.at(d - sx);
        nwo[o] = d == 0 ? wo[o] : shfl1(wo[o], d);
        nr[o] = d == 0 ? r : shfl1(r, d);
        ng[o] = d == 0 ? g : shfl1(g, d);
        nb[o] = d == 0 ? b : shfl1(b, d);
    }
    const int ix = col0 + lane - x0;
#pragma unroll
    for (int q = -kWin; q <= kWin; ++q) {
        const float wq = live ? wy.at(q - sy) : 0.0f;
        const int iy = row + q - y0;
        if (iy < 0 || iy >= h || !__any_sync(kFull, wq != 0.0f)) continue;
        float4* acc_row = acc + (size_t)iy * w;
        float4 tot = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int o = 0; o <= 2 * kWin; ++o) {
            const int d = o - kWin;
            const float fw = nwo[o] * (d == 0 ? wq : shfl1(wq, d));
            if (lane - d >= 0 && lane - d < 32 && fw > 0.0f)
                tot = add4(tot, scaled(fw, nr[o], ng[o], nb[o]));
            if (d != 0 && (lane + d < 0 || lane + d >= 32)) {
                const float own = wo[o] * wq;
                if (own > 0.0f && ix + d >= 0 && ix + d < w)
                    atomicAdd(acc_row + ix + d, scaled(own, r, g, b));
            }
        }
        if (tot.w > 0.0f && ix >= 0 && ix < w) atomicAdd(acc_row + ix, tot);
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

// one thread a film pixel (iy, ix) of rows [row0, row0 + rows): the taps
// of the lanes whose pixel lies within the window [olx, ohx] x [oly, ohy]
// of offsets from it, in ascending lane order (descending offset), summed
// from 0 and added to the pixel once
template <int Kind>
__global__ void __launch_bounds__(kThreads)
    film_add_det_kernel(const float2* __restrict__ p_film, const float* __restrict__ rad,
                        const bool* __restrict__ valid, int n, float4* __restrict__ acc, int h,
                        int w, int x0, int y0, rt::FilterParams f, int nx, int ny, float max_lum,
                        int first, int sx0, int sy0, int sw, int sh, int olx, int ohx, int oly,
                        int ohy, int row0, int rows) {
    const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (t >= (long long)rows * w) return;
    const int iy = row0 + (int)(t / w), ix = (int)(t % w);
    const int X = ix + x0, Y = iy + y0;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool any = false;
    for (int oy = ohy; oy >= oly; --oy) {
        const int ly = Y - oy - sy0;
        if (ly < 0 || ly >= sh) continue;
        for (int ox = ohx; ox >= olx; --ox) {
            const int lx = X - ox - sx0;
            if (lx < 0 || lx >= sw) continue;
            const long long lane = (long long)ly * sw + lx - first;
            if (lane < 0 || lane >= n || (valid != nullptr && !valid[lane])) continue;
            const float2 p = p_film[lane];
            const int k = X - (int)ceilf((p.x - 0.5f) - f.rx);
            const int j = Y - (int)ceilf((p.y - 0.5f) - f.ry);
            if (k < 0 || k >= nx || j < 0 || j >= ny) continue;
            const float fw = rt::filter_weight<Kind>(f, ((float)X + 0.5f) - p.x,
                                                     ((float)Y + 0.5f) - p.y);
            if (!(fw > 0.0f)) continue;
            float r = rad[3 * lane], g = rad[3 * lane + 1], b = rad[3 * lane + 2];
            if (isfinite(max_lum)) {
                float lum = r * 0.212671f + g * 0.715160f + b * 0.072169f;
                float scale = lum > max_lum ? max_lum / fmaxf(lum, 1e-20f) : 1.0f;
                r = r * scale;
                g = g * scale;
                b = b * scale;
            }
            sum = add4(sum, scaled(fw, r, g, b));
            any = true;
        }
    }
    if (any) {
        float4* a = acc + ((size_t)iy * w + ix);
        *a = add4(*a, sum);
    }
}

template <int Kind>
struct LaunchDet {
    void operator()(const void* p_film, const void* rad, const void* valid, int n, void* rgb,
                    int h, int w, int x0, int y0, rt::FilterParams f, int nx, int ny,
                    float max_lum, int first, int sx0, int sy0, int sw, int sh, int olx, int ohx,
                    int oly, int ohy, int row0, int rows, cudaStream_t stream) {
        const long long threads = (long long)rows * w;
        const int blocks = (int)((threads + kThreads - 1) / kThreads);
        film_add_det_kernel<Kind><<<blocks, kThreads, 0, stream>>>(
            (const float2*)p_film, (const float*)rad, (const bool*)valid, n, (float4*)rgb, h, w,
            x0, y0, f, nx, ny, max_lum, first, sx0, sy0, sw, sh, olx, ohx, oly, ohy, row0, rows);
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

// K4d: the arguments of rt_film_add_samples, then the lanes' layout (first:
// lane 0's row-major index in the sample bounds, whose first column and row
// are sx0, sy0 and size sw x sh), the window of offsets of a target pixel
// from a lane's pixel that holds every tap, and the film rows [row0, row0 +
// rows) the launch covers (rows 0 launches nothing)
extern "C" int rt_film_add_samples_det(const void* p_film, const void* rad, const void* valid,
                                       int n, void* rgb, void* wsum, int h, int w, int x0,
                                       int y0, float rx, float ry, int nx, int ny, float max_lum,
                                       int kind, float p0, float p1, float p2, float p3,
                                       float p4, float p5, float p6, float p7, int first,
                                       int sx0, int sy0, int sw, int sh, int olx, int ohx,
                                       int oly, int ohy, int row0, int rows, void* stream) {
    if ((uintptr_t)rgb % 16 || (float*)wsum != (float*)rgb + 3 || (uintptr_t)p_film % 8 ||
        rows < 0 || row0 < 0 || row0 + rows > h)
        return (int)cudaErrorInvalidValue;
    if (rows == 0 || w == 0) return (int)cudaSuccess;
    const float p8[8] = {p0, p1, p2, p3, p4, p5, p6, p7};
    return rt::dispatch_filter<LaunchDet>(kind, p_film, rad, valid, n, rgb, h, w, x0, y0,
                                          rt::filter_params(rx, ry, p8), nx, ny, max_lum, first,
                                          sx0, sy0, sw, sh, olx, ohx, oly, ohy, row0, rows,
                                          (cudaStream_t)stream);
}

// the film layout this source takes: 4 floats a pixel in one buffer
extern "C" int rt_film_channels() { return 4; }
// the filter kinds this source takes (csrc/filter.cuh): box, triangle,
// Gaussian, Mitchell
extern "C" int rt_film_filter_kinds() { return 4; }
