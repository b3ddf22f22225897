// K9: backward of the film splat K4, the gradient of each sample's
// radiance from the gradient of the (H, W, 4) film buffer.
//
// Transposes K4 (csrc/film.cu; the reference's Film.add_samples,
// rustracer_tpu/render/film.py:67-111, differentiated by JAX's autodiff),
// for every filter K4 takes (the weights of csrc/filter.cuh, one build per
// kind).
// A splat adds fw * radiance into each tap's pixel, so the radiance's
// gradient is the sum over the sample's taps of fw times the rgb gradient
// of the tap's pixel: a gather, no atomics. One thread a sample walks the
// footprint in the plain version's order (Film.taps: rows, then columns)
// and reads each tap's pixel as one 16-byte load (r, g, b and the weight's
// gradient, which it drops: the weight sum depends on p_film only). A tap
// that does not land (invalid sample, outside the crop, weight 0) adds
// 0 * g of the clamped pixel, as the plain version does, so the sum is the
// plain version's bit for bit. Then the VJP of the max_sample_luminance
// clamp (Film.clamp_vjp), op for op.
//
// Bound: bytes. The samples are read once (p_film 8, radiance 12, valid 1
// byte), the gradient written once (12 bytes), and each pixel a tap lands
// on read once (16 bytes).
#include "common.cuh"
#include "filter.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLumW0 = 0.212671f, kLumW1 = 0.715160f, kLumW2 = 0.072169f;

template <int Kind>
__global__ void __launch_bounds__(kThreads)
    film_add_bwd_kernel(const float2* __restrict__ p_film, const float* __restrict__ rad,
                        const bool* __restrict__ valid, int n, const float4* __restrict__ g_acc,
                        int h, int w, int x0, int y0, rt::FilterParams f, int nx, int ny,
                        float max_lum, float* __restrict__ g_rad) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const bool v = valid == nullptr || valid[i];
    float2 p = p_film[i];
    int lo_x = (int)ceilf((p.x - 0.5f) - f.rx);
    int lo_y = (int)ceilf((p.y - 0.5f) - f.ry);
    float gr = 0.0f, gg = 0.0f, gb = 0.0f;
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
            float4 g = __ldg(g_acc + ((size_t)iyc * w + ixc));
            gr = gr + fw * g.x;
            gg = gg + fw * g.y;
            gb = gb + fw * g.z;
        }
    }
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

template <int Kind>
struct LaunchBwd {
    void operator()(const void* p_film, const void* rad, const void* valid, int n,
                    const void* g_acc, int h, int w, int x0, int y0, rt::FilterParams f, int nx,
                    int ny, float max_lum, void* g_rad, cudaStream_t stream) {
        film_add_bwd_kernel<Kind><<<rt::blocks_for(n, kThreads), kThreads, 0, stream>>>(
            (const float2*)p_film, (const float*)rad, (const bool*)valid, n,
            (const float4*)g_acc, h, w, x0, y0, f, nx, ny, max_lum, (float*)g_rad);
    }
};

}  // namespace

// g_acc: the gradient of the (H, W, 4) film buffer, 16-byte aligned;
// g_rad: the (n, 3) radiance gradient written; kind and p0..p7:
// Filter.kernel_params.
extern "C" int rt_film_add_samples_bwd(const void* p_film, const void* rad, const void* valid,
                                       int n, const void* g_acc, int h, int w, int x0, int y0,
                                       float rx, float ry, int nx, int ny, float max_lum, int kind,
                                       float p0, float p1, float p2, float p3, float p4, float p5,
                                       float p6, float p7, void* g_rad, void* stream) {
    if ((uintptr_t)g_acc % 16 || (uintptr_t)p_film % 8) return (int)cudaErrorInvalidValue;
    const float p8[8] = {p0, p1, p2, p3, p4, p5, p6, p7};
    return rt::dispatch_filter<LaunchBwd>(kind, p_film, rad, valid, n, g_acc, h, w, x0, y0,
                                          rt::filter_params(rx, ry, p8), nx, ny, max_lum, g_rad,
                                          (cudaStream_t)stream);
}
