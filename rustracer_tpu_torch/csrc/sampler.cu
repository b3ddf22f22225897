// K3: stateless scrambled (0,2)-sequence samples, one thread per lane.
//
// Replaces rustracer_tpu/render/sampler.py get_1d (:34) and get_2d (:40)
// with the hash of rustracer_tpu/core/rng.py and the van der Corput /
// Sobol' pair of rustracer_tpu/core/lowdiscrepancy.py. Bit-exact with the
// plain versions in rustracer_tpu_torch/render/sampler.py. The word hash
// (rt::hash4) is common.cuh's, shared with K18 (noise.cu).
//
// K3r (sample_random_1d, sample_random_2d): the "random" sampler's branches
// of the same functions (rustracer_tpu/render/sampler.py:35-36 and :41-44):
// hash_float(seed, p, s, dim) for 1D, hash_float(seed, p, s, dim, k) for
// k = 0, 1 for 2D (rt::hash4, rt::hash5), bit for bit with core/rng.py.
//
// Bound: memory traffic (two int64 loads and one or two float stores per
// lane against a few dozen integer operations); the design keeps the whole
// chain in registers so each lane touches device memory once each way.
#include "common.cuh"

namespace {

__constant__ uint32_t kPascalCols[32] = {
    0x80000000u, 0xc0000000u, 0xa0000000u, 0xf0000000u, 0x88000000u, 0xcc000000u,
    0xaa000000u, 0xff000000u, 0x80800000u, 0xc0c00000u, 0xa0a00000u, 0xf0f00000u,
    0x88880000u, 0xcccc0000u, 0xaaaa0000u, 0xffff0000u, 0x80008000u, 0xc000c000u,
    0xa000a000u, 0xf000f000u, 0x88008800u, 0xcc00cc00u, 0xaa00aa00u, 0xff00ff00u,
    0x80808080u, 0xc0c0c0c0u, 0xa0a0a0a0u, 0xf0f0f0f0u, 0x88888888u, 0xccccccccu,
    0xaaaaaaaau, 0xffffffffu};

// uint32 -> float32 rounding to nearest even (astype(float32)), * 2^-32,
// clamped below 1
__device__ __forceinline__ float bits_to_float(uint32_t bits) {
    return fminf(__uint2float_rn(bits) * 0x1p-32f, 0x1.fffffep-1f);
}

__device__ __forceinline__ uint32_t sobol_bits(uint32_t index) {
    uint32_t out = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k)
        if ((index >> k) & 1u) out ^= kPascalCols[k];
    return out;
}

template <bool TWO_D>
__global__ void sample_kernel(const long long* __restrict__ pixel,
                              const long long* __restrict__ sample, int n, uint32_t seed,
                              uint32_t dim, float* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t p = static_cast<uint32_t>(pixel[i]);
    uint32_t s = static_cast<uint32_t>(sample[i]);
    if (!TWO_D) {
        out[i] = bits_to_float(__brev(s) ^ rt::hash4(seed, p, dim, 0x1Du));
    } else {
        out[2 * i] = bits_to_float(__brev(s) ^ rt::hash4(seed, p, dim, 0x2D0u));
        out[2 * i + 1] = bits_to_float(sobol_bits(s) ^ rt::hash4(seed, p, dim, 0x2D1u));
    }
}

template <bool TWO_D>
__global__ void random_kernel(const long long* __restrict__ pixel,
                              const long long* __restrict__ sample, int n, uint32_t seed,
                              uint32_t dim, float* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t p = static_cast<uint32_t>(pixel[i]);
    uint32_t s = static_cast<uint32_t>(sample[i]);
    if (!TWO_D) {
        out[i] = bits_to_float(rt::hash4(seed, p, s, dim));
    } else {
        out[2 * i] = bits_to_float(rt::hash5(seed, p, s, dim, 0u));
        out[2 * i + 1] = bits_to_float(rt::hash5(seed, p, s, dim, 1u));
    }
}

template <bool TWO_D, bool RANDOM>
int launch(const void* pixel, const void* sample, int n, uint32_t seed, uint32_t dim, void* out,
           void* stream) {
    constexpr int kThreads = 256;
    auto kernel = RANDOM ? random_kernel<TWO_D> : sample_kernel<TWO_D>;
    kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)pixel, (const long long*)sample, n, seed, dim, (float*)out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_sample_1d(const void* pixel, const void* sample, int n, uint32_t seed,
                            uint32_t dim, void* out, void* stream) {
    return launch<false, false>(pixel, sample, n, seed, dim, out, stream);
}

extern "C" int rt_sample_2d(const void* pixel, const void* sample, int n, uint32_t seed,
                            uint32_t dim, void* out, void* stream) {
    return launch<true, false>(pixel, sample, n, seed, dim, out, stream);
}

extern "C" int rt_sample_random_1d(const void* pixel, const void* sample, int n, uint32_t seed,
                                   uint32_t dim, void* out, void* stream) {
    return launch<false, true>(pixel, sample, n, seed, dim, out, stream);
}

extern "C" int rt_sample_random_2d(const void* pixel, const void* sample, int n, uint32_t seed,
                                   uint32_t dim, void* out, void* stream) {
    return launch<true, true>(pixel, sample, n, seed, dim, out, stream);
}
