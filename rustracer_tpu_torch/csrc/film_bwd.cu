// K9: backward of the film splat K4, the gradient of each sample's
// radiance from the gradient of the (H, W, 4) film buffer.
//
// Transposes K4 (csrc/film.cu; the reference's Film.add_samples,
// rustracer_tpu/render/film.py:67-111, differentiated by JAX's autodiff),
// for every filter K4 takes (the weights of csrc/filter.cuh, one build per
// kind).
// A splat adds fw * radiance into each tap's pixel, so the radiance's
// gradient is the sum over the sample's taps of fw times the rgb gradient
// of the tap's pixel: a gather, no atomics. One thread a sample sums its
// footprint in the plain version's order (Film.taps: rows, then columns).
// A tap that does not land (invalid sample, outside the crop, weight 0)
// adds 0 * g of the clamped pixel, as the plain version does, so the sum
// is the plain version's bit for bit. Then the VJP of the
// max_sample_luminance clamp (Film.clamp_vjp), op for op.
//
// Bound: bytes. The samples are read once (p_film 8 bytes, valid 1, the
// radiance 12 where the clamp is on), the gradient written once (12
// bytes), and each pixel a tap lands on read once (16 bytes).
//
// The box (one tap a sample) and footprints wider than kMaxAxisTaps walk
// the taps with filter_weight (film_add_bwd_kernel), reading each tap's
// pixel as one 16-byte load. The triangle, Gaussian and Mitchell filters
// at PBRT's radius 2 (4 x 4 taps) take film_add_bwd_kernel_staged, whose
// design answers what held the tap-by-tap kernel there: each tap
// evaluated both 1-D weights again (32 divides a Mitchell sample, 32 exp a
// Gaussian one), and the 16 taps' loads of a sample were the bulk of its
// time, not the weights. A block takes 8 rows of 32 samples of the
// renderer's layout (row-major over the film's sample bounds, ``stride``
// samples a row, sample 0's pixel giving its origin) and first stages in
// shared memory, as three planes r, g and b, the 36 x 12 gradient pixels
// their footprints can reach (each pixel row read by 1.5 blocks, not by
// the 5 whose footprints reach it). Each sample then evaluates each axis's
// weights once (filter.cuh axis_taps, shared with K4, with the crop folded
// in), a tap's weight their product, so every tap has filter_weight's bits,
// and reads its taps as 32-bit shared loads: a warp's 16-byte loads of
// one tap hit the same bank group for many lanes (the lanes' footprints
// start one row or column apart), a planar word load far fewer. A sample
// whose footprint the box does not hold (another order of the samples, an
// invalid sample) reads its taps from global memory: the layout decides
// the speed, never the result.
#include <climits>

#include "common.cuh"
#include "filter.cuh"

namespace {

constexpr int kThreads = 256;
// the staged kernel: kRows layout rows of 32 samples a block (a warp a
// row), and the box of gradient pixels their footprints can reach, kBoxW x
// kBoxH (three planes of floats: 5 KB)
constexpr int kRows = kThreads / 32;
constexpr int kBoxW = 32 + rt::kMaxAxisTaps, kBoxH = kRows + rt::kMaxAxisTaps;
constexpr float kLumW0 = 0.212671f, kLumW1 = 0.715160f, kLumW2 = 0.072169f;

__device__ __forceinline__ float3 add_tap(float3 s, float fw, float4 g) {
    return make_float3(s.x + fw * g.x, s.y + fw * g.y, s.z + fw * g.z);
}

// the VJP of the max_sample_luminance clamp of sample i, then the store
__device__ __forceinline__ void store_grad(float3 s, const float* __restrict__ rad, long long i,
                                           float max_lum, float* __restrict__ g_rad) {
    float gr = s.x, gg = s.y, gb = s.z;
    if (isfinite(max_lum)) {
        float r = rad[3 * i], g = rad[3 * i + 1], b = rad[3 * i + 2];
        float lum = r * kLumW0 + g * kLumW1 + b * kLumW2;
        bool over = lum > max_lum;
        float cl = fmaxf(lum, 1e-20f);
        // max_lum / cl as torch evaluates a number over a tensor
        float scale = over ? (1.0f / cl) * max_lum : 1.0f;
        float dot = gr * r + gg * g + gb * b;
        float d_lum = (over && lum >= 1e-20f) ? -(dot * max_lum) / (cl * cl) : 0.0f;
        gr = gr * scale + d_lum * kLumW0;
        gg = gg * scale + d_lum * kLumW1;
        gb = gb * scale + d_lum * kLumW2;
    }
    g_rad[3 * i] = gr;
    g_rad[3 * i + 1] = gg;
    g_rad[3 * i + 2] = gb;
}

// any filter and footprint: tap by tap, each weight from filter_weight
template <int Kind>
__global__ void __launch_bounds__(kThreads)
    film_add_bwd_kernel(const float2* __restrict__ p_film, const float* __restrict__ rad,
                        const bool* __restrict__ valid, int n, const float4* __restrict__ g_acc,
                        int h, int w, int x0, int y0, rt::FilterParams f, int nx, int ny,
                        float max_lum, float* __restrict__ g_rad) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const bool v = valid == nullptr || valid[i];
    const float2 p = p_film[i];
    const int lo_x = (int)ceilf((p.x - 0.5f) - f.rx);
    const int lo_y = (int)ceilf((p.y - 0.5f) - f.ry);
    float3 s = make_float3(0.0f, 0.0f, 0.0f);
    for (int j = 0; j < ny; ++j) {
        for (int k = 0; k < nx; ++k) {
            int px = lo_x + k, py = lo_y + j;
            float dx = ((float)px + 0.5f) - p.x;
            float dy = ((float)py + 0.5f) - p.y;
            float fw = rt::filter_weight<Kind>(f, dx, dy);
            int ix = px - x0, iy = py - y0;
            bool ok = v && ix >= 0 && ix < w && iy >= 0 && iy < h && fw > 0.0f;
            fw = ok ? fw : 0.0f;
            int iyc = min(max(iy, 0), h - 1), ixc = min(max(ix, 0), w - 1);
            s = add_tap(s, fw, __ldg(g_acc + ((size_t)iyc * w + ixc)));
        }
    }
    store_grad(s, rad, i, max_lum, g_rad);
}

// the weights of axis Axis at the footprint's taps (axis_taps), 0 where
// the tap's pixel row or column lies outside the crop [0, size), and
// everywhere unless ok. A tap's weight is then wx.at(k) * wy.at(j):
// filter_weight's where it lands, +-0 where it does not, and fw * g adds
// the same as the plain version's 0 * g there (a sum that starts at +0 is
// never -0)
template <int Kind, int Axis>
__device__ __forceinline__ rt::AxisTaps crop_taps(const rt::FilterParams& f, int lo, float p,
                                                  int n, int origin, int size, bool ok) {
    const rt::AxisTaps t = rt::axis_taps<Kind, Axis>(f, lo, p, n);
    const int i = lo - origin;
    return {ok && i >= 0 && i < size ? t.v0 : 0.0f, ok && i >= -1 && i + 1 < size ? t.v1 : 0.0f,
            ok && i >= -2 && i + 2 < size ? t.v2 : 0.0f,
            ok && i >= -3 && i + 3 < size ? t.v3 : 0.0f};
}

// a tap's weight: the product of its axes' (crop_taps), less than 0 only
// for Mitchell's lobes, which the plain version drops (fw > 0)
template <int Kind>
__device__ __forceinline__ float tap_weight(float wx, float wy) {
    const float fw = wx * wy;
    return Kind == rt::kMitchell ? fmaxf(fw, 0.0f) : fw;
}

// a footprint of at most kMaxAxisTaps x kMaxAxisTaps taps of a filter
// wider than the box, staged as the header says: N x N taps (PBRT's
// radius 2: N = kMaxAxisTaps), or with N = 0 nx x ny known at run time.
// Block (x, y) takes layout rows 8y to 8y + 7, columns 32x to 32x + 31;
// its box is where those pixels' footprints fall in that layout
template <int Kind, int N>
__global__ void __launch_bounds__(kThreads)
    film_add_bwd_kernel_staged(const float2* __restrict__ p_film, const float* __restrict__ rad,
                               const bool* __restrict__ valid, int n,
                               const float4* __restrict__ g_acc, int h, int w, int x0, int y0,
                               rt::FilterParams f, int nx, int ny, float max_lum,
                               float* __restrict__ g_rad, int stride, int sx0) {
    __shared__ float box[3][kBoxW * kBoxH];
    if (N) nx = ny = N;
    // sample 0's pixel: the layout column of sample 0 (0 for a position
    // outside the layout) and the pixel row of layout row 0
    const float2 p0 = __ldg(p_film);
    int o = (int)floorf(p0.x) - sx0;
    o = o >= 0 && o < stride ? o : 0;
    const int col = (int)blockIdx.x * 32 + (threadIdx.x & 31);
    const int i = ((int)blockIdx.y * kRows + (threadIdx.x >> 5)) * stride + col - o;
    const bool in = col < stride && i >= 0 && i < n;
    const bool v = in && (valid == nullptr || valid[i]);
    const float2 p = in ? p_film[i] : make_float2(0.0f, 0.0f);
    // the box: the lowest footprint corner of a pixel (x, y) is
    // (x, y) + ceil(-0.5 - r), the highest one more
    const int bx0 = sx0 + (int)blockIdx.x * 32 + (int)ceilf(-0.5f - f.rx);
    const int by0 = (int)floorf(p0.y) + (int)blockIdx.y * kRows + (int)ceilf(-0.5f - f.ry);
#pragma unroll
    for (int m = 0; m < (kBoxW * kBoxH + kThreads - 1) / kThreads; ++m) {
        const int e = (int)threadIdx.x + m * kThreads;
        if (e < kBoxW * kBoxH) {
            const int r = e / kBoxW, c = e - r * kBoxW;
            const float4 g = __ldg(g_acc + (size_t)min(max(by0 + r - y0, 0), h - 1) * w +
                                   min(max(bx0 + c - x0, 0), w - 1));
            box[0][e] = g.x;
            box[1][e] = g.y;
            box[2][e] = g.z;
        }
    }
    __syncthreads();
    if (!in) return;
    const int lo_x = (int)ceilf((p.x - 0.5f) - f.rx);
    const int lo_y = (int)ceilf((p.y - 0.5f) - f.ry);
    const rt::AxisTaps wx = crop_taps<Kind, 0>(f, lo_x, p.x, nx, x0, w, true);
    const rt::AxisTaps wy = crop_taps<Kind, 1>(f, lo_y, p.y, ny, y0, h, v);
    // the footprint's corner in the box
    const int ox = lo_x - bx0, oy = lo_y - by0;
    float3 s = make_float3(0.0f, 0.0f, 0.0f);
    if (v && ox >= 0 && ox + nx <= kBoxW && oy >= 0 && oy + ny <= kBoxH) {
        const int b = oy * kBoxW + ox;
#pragma unroll
        for (int j = 0; j < rt::kMaxAxisTaps; ++j) {
#pragma unroll
            for (int k = 0; k < rt::kMaxAxisTaps; ++k) {
                const int e = b + j * kBoxW + k;
                if (j < ny && k < nx)
                    s = add_tap(s, tap_weight<Kind>(wx.at(k), wy.at(j)),
                                make_float4(box[0][e], box[1][e], box[2][e], 0.0f));
            }
        }
    } else {
#pragma unroll 1
        for (int j = 0; j < ny; ++j) {
            const float wj = wy.at(j);
            const float4* g_row = g_acc + (size_t)min(max(lo_y + j - y0, 0), h - 1) * w;
            for (int k = 0; k < nx; ++k)
                s = add_tap(s, tap_weight<Kind>(wx.at(k), wj),
                            __ldg(g_row + min(max(lo_x + k - x0, 0), w - 1)));
        }
    }
    store_grad(s, rad, i, max_lum, g_rad);
}

template <int Kind>
struct LaunchBwd {
    void operator()(const void* p_film, const void* rad, const void* valid, int n,
                    const void* g_acc, int h, int w, int x0, int y0, rt::FilterParams f, int nx,
                    int ny, float max_lum, void* g_rad, int stride, int sx0,
                    cudaStream_t stream) {
        const auto* p2 = (const float2*)p_film;
        const auto* r3 = (const float*)rad;
        const auto* ok = (const bool*)valid;
        const auto* g4 = (const float4*)g_acc;
        if constexpr (Kind != rt::kBox) {
            // a layout row of at least a warp; rows enough for any column
            // of sample 0
            stride = stride < 32 ? 32 : stride;
            const long long rows = ((long long)n + stride - 1) / stride + 1;
            const dim3 grid((stride + 31) / 32, (unsigned)((rows + kRows - 1) / kRows));
            if (nx <= rt::kMaxAxisTaps && ny <= rt::kMaxAxisTaps && grid.y <= 65535 &&
                (rows + kRows) * stride < INT_MAX) {
                if (nx == rt::kMaxAxisTaps && ny == rt::kMaxAxisTaps)
                    film_add_bwd_kernel_staged<Kind, rt::kMaxAxisTaps>
                        <<<grid, kThreads, 0, stream>>>(p2, r3, ok, n, g4, h, w, x0, y0, f, nx,
                                                        ny, max_lum, (float*)g_rad, stride, sx0);
                else
                    film_add_bwd_kernel_staged<Kind, 0><<<grid, kThreads, 0, stream>>>(
                        p2, r3, ok, n, g4, h, w, x0, y0, f, nx, ny, max_lum, (float*)g_rad,
                        stride, sx0);
                return;
            }
        }
        film_add_bwd_kernel<Kind><<<rt::blocks_for(n, kThreads), kThreads, 0, stream>>>(
            p2, r3, ok, n, g4, h, w, x0, y0, f, nx, ny, max_lum, (float*)g_rad);
    }
};

}  // namespace

// g_acc: the gradient of the (H, W, 4) film buffer, 16-byte aligned;
// g_rad: the (n, 3) radiance gradient written; kind and p0..p7:
// Filter.kernel_params; stride and sx0: the width and first column of the
// film's sample bounds, the renderer's layout of the samples (a hint:
// any order gives the same result).
extern "C" int rt_film_add_samples_bwd(const void* p_film, const void* rad, const void* valid,
                                       int n, const void* g_acc, int h, int w, int x0, int y0,
                                       float rx, float ry, int nx, int ny, float max_lum, int kind,
                                       float p0, float p1, float p2, float p3, float p4, float p5,
                                       float p6, float p7, void* g_rad, int stride, int sx0,
                                       void* stream) {
    if ((uintptr_t)g_acc % 16 || (uintptr_t)p_film % 8) return (int)cudaErrorInvalidValue;
    const float p8[8] = {p0, p1, p2, p3, p4, p5, p6, p7};
    return rt::dispatch_filter<LaunchBwd>(kind, p_film, rad, valid, n, g_acc, h, w, x0, y0,
                                          rt::filter_params(rx, ry, p8), nx, ny, max_lum, g_rad,
                                          stride, sx0, (cudaStream_t)stream);
}

// the sample layout K9 takes (stride and sx0 in its arguments)
extern "C" int rt_film_bwd_layout() { return 1; }
