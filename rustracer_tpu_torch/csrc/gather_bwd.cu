// K11: backward of the row gather K8, the table gradient
// g_table[r, :] = sum over lanes i with idx[i] == r of g[i, :].
//
// Transposes K8 (csrc/gather.cu, itself the port of
// tools/bench_gather_pallas.py pallas_gather). In the render K8 gathers
// the per-material parameter rows (scene/materials.py MaterialSet.shade):
// 2^18 lanes land on 3-5 rows of 16 floats, so global atomics straight
// from the lanes would all hit 48-80 addresses. Each block instead sums
// its share of the lanes into an R x W copy of the gradient in shared
// memory (shared-memory atomics: neighbouring threads take neighbouring
// columns, so a warp's adds go to distinct addresses), and then adds each
// nonzero sum into the output with one global atomic. The sums are taken
// in no fixed order: the result agrees with index_add_ to float rounding.
//
// Bound: bytes. The gradient rows and the indices are read once, the
// table gradient written once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    row_gather_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx, long long n,
                          int rows, int width, float* __restrict__ out) {
    extern __shared__ float s_sum[];
    const int cells = rows * width;
    for (int e = threadIdx.x; e < cells; e += kThreads) s_sum[e] = 0.0f;
    __syncthreads();
    const long long total = n * width;
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < total; j += stride) {
        long long lane = j / width;
        int k = (int)(j - lane * width);
        atomicAdd(s_sum + __ldg(idx + lane) * width + k, __ldg(g + j));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < cells; e += kThreads) {
        float v = s_sum[e];
        if (v != 0.0f) atomicAdd(out + e, v);
    }
}

}  // namespace

// out: the (rows, width) gradient, zeroed by the caller; rows * width
// floats must fit in 48 KB of shared memory.
extern "C" int rt_row_gather_bwd(const void* g, const void* idx, int n, int rows, int width,
                                 void* out, void* stream) {
    size_t smem = (size_t)rows * width * sizeof(float);
    if (rows <= 0 || width <= 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long total = (long long)n * width;
    // a few blocks on every SM; each block's flush costs rows * width atomics
    long long want = (total + kThreads * 16 - 1) / (kThreads * 16);
    long long cap = (long long)sms * 4;
    int blocks = (int)(want < cap ? want : cap);
    if (blocks < 1) blocks = 1;
    row_gather_bwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)g, (const int*)idx, (long long)n, rows, width, (float*)out);
    return (int)cudaGetLastError();
}
