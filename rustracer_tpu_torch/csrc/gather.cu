// K8: row gather out[i, :] = table[idx[i], :] of float32 rows whose width
// is a multiple of 4 floats.
//
// Replaces tools/bench_gather_pallas.py pallas_gather (:26, the
// pl.pallas_call at :62): one async HBM->VMEM DMA per 512-byte BVH row with
// `nslot` DMAs in flight. In the render it also serves the per-material
// parameter-row gather of scene/materials.py MaterialSet.shade.
//
// Bound: device-memory bytes. Every row is read once at a random address
// and written once in order; there is no arithmetic. The design makes each
// access a 16-byte float4 and keeps neighbouring threads on neighbouring
// addresses: thread j of the flat float4 index copies float4 (j % c) of
// row idx[j / c], c = width / 4. For the 128-float (512-byte) BVH rows that
// is one warp per row, one coalesced 512-byte read and write per warp. The
// Pallas DMA window has no counterpart: the card hides the row latency with
// the number of resident warps, so the grid is sized to keep every SM full
// and strides over the rest. Output is written with streaming stores so it
// does not evict the table from L2.
#include "common.cuh"

namespace {

__global__ void row_gather_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                                  long long n4, int c, float4* __restrict__ out) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n4; j += stride) {
        long long row = j / c;
        int k = (int)(j - row * c);
        int r = __ldg(idx + row);
        __stcs(out + j, __ldg(table + (long long)r * c + k));
    }
}

}  // namespace

extern "C" int rt_row_gather(const void* table, const void* idx, int n, int width, void* out,
                             void* stream) {
    constexpr int kThreads = 256;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int c = width / 4;
    long long n4 = (long long)n * c;
    long long want = (n4 + kThreads - 1) / kThreads;
    // 8 blocks of 256 threads (64 warps, the SM's maximum) on every SM
    long long cap = (long long)sms * 8;
    int blocks = (int)(want < cap ? want : cap);
    if (blocks < 1) blocks = 1;
    row_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)table, (const int*)idx, n4, c, (float4*)out);
    return (int)cudaGetLastError();
}
