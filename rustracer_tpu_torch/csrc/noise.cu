// K18: fbm and turbulence of hash-lattice Perlin noise, one thread a lane.
//
// Replaces rustracer_tpu/core/noise.py noise3 (:28), fbm (:52) and
// turbulence (:72), with the lattice hash of rustracer_tpu/core/rng.py
// hash_u32 (:27, common.cuh rt::hash3). The plain versions are
// rustracer_tpu_torch/core/noise.py fbm_plain and turbulence_plain; with
// -fmad=false the kernel repeats their float32 operations in their order,
// so lattice corners, hashes and octave counts are bit for bit and the sums
// differ only where log2f differs from torch.log2 (the octave count at an
// integer) or the order of the reference's 3-term sum of squares does.
//
// The reference keeps lam = 1.99^i and o = omega^i as Python floats
// (double) and rounds each to float32 where it meets a tensor: the kernel
// accumulates them in double and rounds the same way. It walks the lane's
// active octaves only (the reference adds zeros past them) and the partial
// octave at lam = 1.99^max_octaves, o = omega^max_octaves.
//
// Bound: operations. A lane reads 36 bytes and writes 4; an octave is a
// noise3 (8 hashes of 3 words, about 8 x 22 integer operations, and some
// 60 float operations), so a lane of a 1024^2 render's footprint does a
// few thousand operations. The design keeps everything in registers.
#include "common.cuh"

namespace {

__device__ __forceinline__ float grad(uint32_t h, float x, float y, float z) {
    h &= 15u;
    float u = h < 8u ? x : y;
    float v = h < 4u ? y : ((h == 12u || h == 14u) ? x : z);
    u = (h & 1u) ? -u : u;
    v = (h & 2u) ? -v : v;
    return u + v;
}

__device__ __forceinline__ float smooth(float t) {
    return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f);
}

__device__ __forceinline__ float lerp(float t, float a, float b) { return a + t * (b - a); }

__device__ float noise3(float px, float py, float pz) {
    float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
    float x = px - fx, y = py - fy, z = pz - fz;
    uint32_t ix = (uint32_t)(int)fx, iy = (uint32_t)(int)fy, iz = (uint32_t)(int)fz;
    float u = smooth(x), v = smooth(y), w = smooth(z);
    auto g = [&](uint32_t dx, uint32_t dy, uint32_t dz) {
        return grad(rt::hash3(ix + dx, iy + dy, iz + dz), x - (float)dx, y - (float)dy,
                    z - (float)dz);
    };
    float x00 = lerp(u, g(0, 0, 0), g(1, 0, 0));
    float x10 = lerp(u, g(0, 1, 0), g(1, 1, 0));
    float x01 = lerp(u, g(0, 0, 1), g(1, 0, 1));
    float x11 = lerp(u, g(0, 1, 1), g(1, 1, 1));
    return lerp(w, lerp(v, x00, x10), lerp(v, x01, x11));
}

template <bool TURB>
__global__ void fbm_kernel(const float* __restrict__ p, const float* __restrict__ dpdx,
                           const float* __restrict__ dpdy, int n, double omega, int max_octaves,
                           float* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    rt::V3 q = rt::load3(p + 3 * i);
    rt::V3 dx = rt::load3(dpdx + 3 * i);
    rt::V3 dy = rt::load3(dpdy + 3 * i);
    float len2 = fmaxf(dx.x * dx.x + dx.y * dx.y + dx.z * dx.z,
                       dy.x * dy.x + dy.y * dy.y + dy.z * dy.z);
    float oct = -1.0f - 0.5f * log2f(fmaxf(len2, 1e-24f));
    oct = fminf(fmaxf(oct, 0.0f), (float)max_octaves);
    float n_int = floorf(oct);
    float sum = 0.0f;
    double lam = 1.0, o = 1.0;
    for (int k = 0; k < max_octaves; ++k) {
        if ((float)k < n_int) {
            float lf = (float)lam;
            float v = noise3(q.x * lf, q.y * lf, q.z * lf);
            sum = sum + (float)o * (TURB ? fabsf(v) : v);
        }
        lam *= 1.99;
        o *= omega;
    }
    float lf = (float)lam;
    float v = smooth(oct - n_int) * noise3(q.x * lf, q.y * lf, q.z * lf);
    out[i] = sum + (float)o * (TURB ? fabsf(v) : v);
}

}  // namespace

extern "C" int rt_noise_fbm(const void* p, const void* dpdx, const void* dpdy, int n,
                            double omega, int max_octaves, int turbulence, void* out,
                            void* stream) {
    constexpr int kThreads = 128;
    auto s = (cudaStream_t)stream;
    int blocks = rt::blocks_for(n, kThreads);
    if (turbulence)
        fbm_kernel<true><<<blocks, kThreads, 0, s>>>((const float*)p, (const float*)dpdx,
                                                     (const float*)dpdy, n, omega, max_octaves,
                                                     (float*)out);
    else
        fbm_kernel<false><<<blocks, kThreads, 0, s>>>((const float*)p, (const float*)dpdx,
                                                      (const float*)dpdy, n, omega, max_octaves,
                                                      (float*)out);
    return (int)cudaGetLastError();
}
