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
// arithmetic. Each film pixel of the rows the tile reaches gathers its taps
// from those lanes in ascending lane order (a lane has at most one tap on
// a pixel), sums them from 0 and adds the sum to the pixel once: no
// atomics, each pixel read and written at most once a launch. Its plain
// version (Film.add_samples_det_plain) sums in the same order, so the two
// agree bit for bit. Bound: bytes, as K4's (the samples in, each touched
// pixel read and written once).
//
// Its design (footprints up to kMaxAxisTaps an axis): a block takes a
// kDetW x kDetH tile of film pixels and first stages, with coalesced
// loads, the lanes whose pixels lie within the window of the tile (for
// PBRT's radius 2, a 7 x 7 window: 38 x 22 lanes for 32 x 16 pixels) in
// shared memory, each lane's invariants computed once there: its clamped
// radiance, its footprint origin as the first tap index of the window's
// first offset, and its two AxisTaps (filter.cuh axis_taps: a tap's weight
// wx.at(k) * wy.at(j), filter_weight's product bit for bit). The block
// takes the range of those origins, so its pixels walk only the window
// steps a tap can come from (5 x 5 of the 7 x 7 for radius 2), in the
// order above, unrolled, reading shared memory only: a word to test the
// footprint, and for a tap two weights and the radiance. A footprint wider
// than kMaxAxisTaps takes film_add_det_kernel: one thread a pixel reading
// each lane of its window from global memory, the footprint, clamp and
// filter_weight computed again for each pixel a sample reaches.
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

// footprints wider than kMaxAxisTaps: one thread a film pixel (iy, ix) of
// rows [row0, row0 + rows), the taps of the lanes whose pixel lies within
// the window [olx, ohx] x [oly, ohy] of offsets from it, in ascending lane
// order (descending offset), summed from 0 and added to the pixel once
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

// K4d's tile: kDetW x kDetH film pixels a block (one thread each), the
// lanes of a window of at most kDetWin x kDetWin offsets around it staged
// in shared memory, each array padded to a multiple of 32 entries (a
// weight at tap k of entry s sits at k * kDetPad + s: the threads of a
// warp, on consecutive entries, read distinct banks whatever their k)
constexpr int kDetW = 32, kDetH = 16, kDetThreads = kDetW * kDetH;
constexpr int kDetWin = rt::kMaxAxisTaps + 3;
constexpr int kDetSW = kDetW + kDetWin - 1, kDetSH = kDetH + kDetWin - 1;
constexpr int kDetPad = (kDetSW * kDetSH + 31) / 32 * 32;
// a staged entry's footprint code: the first tap index, on each axis, of
// the window's first offset (x in the high half, y in the low; a tap at
// window step (dx, dy) is (kx - dx, ky - dy)); kDetNone for a lane that
// splats nothing (beyond the lanes, invalid, outside the sample bounds)
constexpr int kDetNone = (int)0x80008000u;

// blockIdx (bx, by): film pixels [32 bx, 32 bx + 32) x [row0 + 16 by, +16);
// the window [olx, ohx] x [oly, ohy] is at most kDetWin wide on each axis
// and the footprint at most kMaxAxisTaps
template <int Kind>
__global__ void __launch_bounds__(kDetThreads)
    film_add_det_tile_kernel(const float2* __restrict__ p_film, const float* __restrict__ rad,
                             const bool* __restrict__ valid, int n, float4* __restrict__ acc,
                             int h, int w, int x0, int y0, rt::FilterParams f, int nx, int ny,
                             float max_lum, int first, int sx0, int sy0, int sw, int sh, int olx,
                             int ohx, int oly, int ohy, int row0, int rows) {
    __shared__ int s_code[kDetPad];
    __shared__ float s_wx[rt::kMaxAxisTaps * kDetPad], s_wy[rt::kMaxAxisTaps * kDetPad];
    __shared__ float4 s_rgb[kDetPad];
    // the block's taps reach window steps [dx0, dx1] x [dy0, dy1]: the
    // least and most first tap indices of its lanes (ranges of 2 for
    // PBRT's radius 2: 5 x 5 of the 7 x 7 window)
    __shared__ int s_range[4];
    const int ww = ohx - olx + 1, wh = ohy - oly + 1;
    const int tsw = kDetW + ww - 1, tsh = kDetH + wh - 1;
    const int ix0 = blockIdx.x * kDetW, iy0 = row0 + blockIdx.y * kDetH;
    // the staged entry (sx, sy) is the lane of pixel (LX0 + sx, LY0 + sy):
    // the pixel the window's first offset (ohx, ohy) reaches the tile's
    // first pixel from
    const int LX0 = ix0 + x0 - ohx, LY0 = iy0 + y0 - ohy;
    if (threadIdx.x < 4) s_range[threadIdx.x] = threadIdx.x % 2 ? -1024 : 1024;
    __syncthreads();
    int kx_lo = 1024, kx_hi = -1024, ky_lo = 1024, ky_hi = -1024;
    for (int e = threadIdx.x; e < tsw * tsh; e += kDetThreads) {
        const int sy = e / tsw, sx = e - sy * tsw;
        const int gx = LX0 + sx - sx0, gy = LY0 + sy - sy0;
        const long long lane = (long long)gy * sw + gx - first;
        const int s = sy * kDetSW + sx;
        if (gx < 0 || gx >= sw || gy < 0 || gy >= sh || lane < 0 || lane >= n ||
            (valid != nullptr && !valid[lane])) {
            s_code[s] = kDetNone;
            continue;
        }
        const float2 p = p_film[lane];
        float r = rad[3 * lane], g = rad[3 * lane + 1], b = rad[3 * lane + 2];
        if (isfinite(max_lum)) {
            float lum = r * 0.212671f + g * 0.715160f + b * 0.072169f;
            float scale = lum > max_lum ? max_lum / fmaxf(lum, 1e-20f) : 1.0f;
            r = r * scale;
            g = g * scale;
            b = b * scale;
        }
        const int lo_x = (int)ceilf((p.x - 0.5f) - f.rx);
        const int lo_y = (int)ceilf((p.y - 0.5f) - f.ry);
        // the tap index of offset ohx from this lane's pixel: its x minus
        // lo_x; a lane's pixel x is LX0 + sx (clamped: a lane beyond the
        // window's reach keeps no tap)
        const int kx = min(max((LX0 + sx + ohx) - lo_x, -1024), 1024);
        const int ky = min(max((LY0 + sy + ohy) - lo_y, -1024), 1024);
        s_code[s] = (int)(((unsigned)kx << 16) | ((unsigned)ky & 0xffffu));
        kx_lo = min(kx_lo, kx);
        kx_hi = max(kx_hi, kx);
        ky_lo = min(ky_lo, ky);
        ky_hi = max(ky_hi, ky);
        const rt::AxisTaps wx = rt::axis_taps<Kind, 0>(f, lo_x, p.x, nx);
        const rt::AxisTaps wy = rt::axis_taps<Kind, 1>(f, lo_y, p.y, ny);
        s_wx[s] = wx.v0;
        s_wx[kDetPad + s] = wx.v1;
        s_wx[2 * kDetPad + s] = wx.v2;
        s_wx[3 * kDetPad + s] = wx.v3;
        s_wy[s] = wy.v0;
        s_wy[kDetPad + s] = wy.v1;
        s_wy[2 * kDetPad + s] = wy.v2;
        s_wy[3 * kDetPad + s] = wy.v3;
        s_rgb[s] = make_float4(r, g, b, 0.0f);
    }
    kx_lo = __reduce_min_sync(0xffffffffu, kx_lo);
    kx_hi = __reduce_max_sync(0xffffffffu, kx_hi);
    ky_lo = __reduce_min_sync(0xffffffffu, ky_lo);
    ky_hi = __reduce_max_sync(0xffffffffu, ky_hi);
    if ((threadIdx.x & 31) == 0) {
        atomicMin(s_range, kx_lo);
        atomicMax(s_range + 1, kx_hi);
        atomicMin(s_range + 2, ky_lo);
        atomicMax(s_range + 3, ky_hi);
    }
    __syncthreads();
    const int tx = threadIdx.x % kDetW, ty = threadIdx.x / kDetW;
    const int ix = ix0 + tx, iy = iy0 + ty;
    if (ix >= w || iy >= row0 + rows) return;
    // a tap at step dx has k = kx - dx in [0, nx): dx in [kx - nx + 1, kx]
    const int dx0 = max(s_range[0] - nx + 1, 0), dx1 = min(s_range[1], ww - 1);
    const int dy0 = max(s_range[2] - ny + 1, 0), dy1 = min(s_range[3], wh - 1);
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool any = false;
    // offsets (ohx - dx, ohy - dy): descending offset, ascending lane
#pragma unroll
    for (int dy = 0; dy < kDetWin; ++dy) {
        if (dy < dy0 || dy > dy1) continue;
#pragma unroll
        for (int dx = 0; dx < kDetWin; ++dx) {
            if (dx < dx0 || dx > dx1) continue;
            const int s = (ty + dy) * kDetSW + tx + dx;
            const int c = s_code[s];
            const int k = (c >> 16) - dx, j = (int)(short)(c & 0xffff) - dy;
            if ((unsigned)k >= (unsigned)nx || (unsigned)j >= (unsigned)ny) continue;
            const float fw = s_wx[k * kDetPad + s] * s_wy[j * kDetPad + s];
            if (!(fw > 0.0f)) continue;
            const float4 v = s_rgb[s];
            sum = add4(sum, scaled(fw, v.x, v.y, v.z));
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
        if (nx <= rt::kMaxAxisTaps && ny <= rt::kMaxAxisTaps && ohx - olx < kDetWin &&
            ohy - oly < kDetWin) {
            const dim3 blocks((w + kDetW - 1) / kDetW, (rows + kDetH - 1) / kDetH);
            film_add_det_tile_kernel<Kind><<<blocks, kDetThreads, 0, stream>>>(
                (const float2*)p_film, (const float*)rad, (const bool*)valid, n, (float4*)rgb,
                h, w, x0, y0, f, nx, ny, max_lum, first, sx0, sy0, sw, sh, olx, ohx, oly, ohy,
                row0, rows);
            return;
        }
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
