// K11: backward of the row gather K8, the table gradient
// g_table[r, :] = sum over lanes i with idx[i] == r of g[i, :].
//
// Transposes K8 (csrc/gather.cu, itself the port of
// tools/bench_gather_pallas.py pallas_gather). In the render K8 gathers
// the per-material parameter rows (scene/materials.py MaterialSet.shade):
// 2^18 lanes land on 3-5 rows of 16 floats, so adds straight from the
// lanes, to device memory or to one shared copy of the table, all meet on
// 48-80 addresses.
//
// Bound: bytes. The gradient rows and the indices are read once, the
// table gradient written once. The design, for Hopper, is a reduction
// without contention:
//  (a) a table of at most kRReg rows, each a power of two of float4s up to
//      kMaxChunks, is summed in registers: C = width / 4 neighbouring
//      threads take one lane's row, a float4 each (16-byte loads,
//      neighbouring threads on neighbouring addresses, no division), and
//      each thread keeps a float4 for every table row, the row chosen by
//      an unrolled compare (no dynamic register index; ptxas keeps the
//      sums of up to 7 rows in registers, and puts 8 rows' on the stack).
//      A persistent grid (one block an SM) walks the lanes, kUnroll loads
//      in flight a thread;
//  (b) a block folds its threads' sums through shuffles within each warp,
//      then across its warps in shared memory, into one partial table in
//      device memory;
//  (c) the last block to finish (a counter the launch leaves at 0) folds
//      the partials and writes each entry of the table gradient once.
//      Every sum is taken in a fixed order, so the result is the same bits
//      from launch to launch on one card (the grid is the card's SM count);
//  (d) a larger table takes the shared-copy path: each block sums its share
//      of the lanes into an R x W copy in shared memory with shared
//      atomics, then adds each nonzero entry into the output with one
//      global atomic. Its sums go in no fixed order.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;  // threads of a block of the register path
constexpr int kRReg = 8;        // table rows the register path takes
constexpr int kMaxChunks = 8;   // float4s of a row the register path takes
constexpr int kUnroll = 2;      // lanes a thread loads before it adds
constexpr int kSharedThreads = 256;

__device__ __forceinline__ void add4(float4& a, float4 b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
}

__device__ __forceinline__ void xor_add4(float4& a, int off) {
    a.x += __shfl_xor_sync(0xffffffffu, a.x, off);
    a.y += __shfl_xor_sync(0xffffffffu, a.y, off);
    a.z += __shfl_xor_sync(0xffffffffu, a.z, off);
    a.w += __shfl_xor_sync(0xffffffffu, a.w, off);
}

// R table rows of C float4s each; partials: gridDim.x x R * C * 4 floats;
// counter: 0 at launch, left at 0
template <int R, int C>
__global__ void __launch_bounds__(kThreads, 1)
    row_gather_bwd_kernel(const float4* __restrict__ g, const int* __restrict__ idx, long long n,
                          float* __restrict__ partials, unsigned* counter,
                          float* __restrict__ out) {
    constexpr int E = R * C * 4;           // entries of the table
    constexpr int kLanes = kThreads / C;   // lanes a block takes a round
    constexpr int kWarps = kThreads / 32;
    constexpr int S = kThreads / E;        // threads an entry in the last fold
    __shared__ float s_part[kWarps][E];
    __shared__ float s_fold[E * S];
    __shared__ bool s_last;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, c = tid % C;

    // (a) a float4 for each table row
    float4 acc[R];
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const long long stride = (long long)gridDim.x * kLanes;
    for (long long l0 = (long long)blockIdx.x * kLanes + tid / C; l0 < n; l0 += kUnroll * stride) {
        float4 v[kUnroll];
        int r[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            long long l = l0 + u * stride;
            bool ok = l < n;
            v[u] = ok ? __ldg(g + l * C + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            r[u] = ok ? __ldg(idx + l) : -1;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int q = 0; q < R; ++q)
                if (r[u] == q) add4(acc[q], v[u]);
    }

    // (b) the warp's sums, then the block's, into its partial table
#pragma unroll
    for (int off = 16; off >= C; off >>= 1)
#pragma unroll
        for (int q = 0; q < R; ++q) xor_add4(acc[q], off);
    if (lane < C) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
            float* p = &s_part[warp][q * C * 4 + 4 * c];
            p[0] = acc[q].x;
            p[1] = acc[q].y;
            p[2] = acc[q].z;
            p[3] = acc[q].w;
        }
    }
    __syncthreads();
    if (tid < E) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += s_part[w][tid];
        partials[(long long)blockIdx.x * E + tid] = sum;
    }

    // (c) the last block folds the partials, S threads an entry
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const int e = tid / S, s = tid % S;
    if (e < E) {
        float sum = 0.0f;
#pragma unroll 4
        for (int b = s; b < (int)gridDim.x; b += S) sum += __ldcg(partials + (long long)b * E + e);
        s_fold[e * S + s] = sum;
    }
    __syncthreads();
    if (tid < E) {
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < S; ++j) sum += s_fold[tid * S + j];
        out[tid] = sum;
    }
    if (tid == 0) *counter = 0u;
}

__global__ void __launch_bounds__(kSharedThreads)
    row_gather_bwd_shared_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                                 long long n, int rows, int width, float* __restrict__ out) {
    extern __shared__ float s_sum[];
    const int cells = rows * width;
    for (int e = threadIdx.x; e < cells; e += kSharedThreads) s_sum[e] = 0.0f;
    __syncthreads();
    const long long total = n * width;
    const long long stride = (long long)gridDim.x * kSharedThreads;
    for (long long j = (long long)blockIdx.x * kSharedThreads + threadIdx.x; j < total;
         j += stride) {
        long long lane = j / width;
        int k = (int)(j - lane * width);
        atomicAdd(s_sum + __ldg(idx + lane) * width + k, __ldg(g + j));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < cells; e += kSharedThreads) {
        float v = s_sum[e];
        if (v != 0.0f) atomicAdd(out + e, v);
    }
}

int sm_count() {
    static int sms[16] = {0};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 16) return 0;
    if (!sms[dev]) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    return sms[dev];
}

bool register_path(int rows, int width) {
    int chunks = width / 4;
    return rows >= 1 && rows <= kRReg && width % 4 == 0 && chunks >= 1 &&
           chunks <= kMaxChunks && (chunks & (chunks - 1)) == 0;
}

template <int R, int C>
void launch_rows(int blocks, const void* g, const void* idx, long long n, void* partials,
                 void* counter, void* out, cudaStream_t stream) {
    row_gather_bwd_kernel<R, C><<<blocks, kThreads, 0, stream>>>(
        (const float4*)g, (const int*)idx, n, (float*)partials, (unsigned*)counter, (float*)out);
}

template <int C>
void launch_chunks(int rows, int blocks, const void* g, const void* idx, long long n,
                   void* partials, void* counter, void* out, cudaStream_t stream) {
    switch (rows) {
        case 1: launch_rows<1, C>(blocks, g, idx, n, partials, counter, out, stream); break;
        case 2: launch_rows<2, C>(blocks, g, idx, n, partials, counter, out, stream); break;
        case 3: launch_rows<3, C>(blocks, g, idx, n, partials, counter, out, stream); break;
        case 4: launch_rows<4, C>(blocks, g, idx, n, partials, counter, out, stream); break;
        case 5: launch_rows<5, C>(blocks, g, idx, n, partials, counter, out, stream); break;
        case 6: launch_rows<6, C>(blocks, g, idx, n, partials, counter, out, stream); break;
        case 7: launch_rows<7, C>(blocks, g, idx, n, partials, counter, out, stream); break;
        default: launch_rows<8, C>(blocks, g, idx, n, partials, counter, out, stream); break;
    }
}

}  // namespace

// Blocks of the register path for n lanes into a (rows, width) table (at
// least 1), so the caller can size its partials (blocks * rows * width
// floats); 0 where the table takes the shared-copy path.
extern "C" int rt_row_gather_bwd_blocks(int n, int rows, int width) {
    if (!register_path(rows, width)) return 0;
    long long want = ((long long)n * (width / 4) + kThreads - 1) / kThreads;
    int sms = sm_count();
    int blocks = (int)(want < sms ? want : sms);
    return blocks > 1 ? blocks : 1;
}

// out: the (rows, width) gradient, written (not added into). partials:
// rt_row_gather_bwd_blocks(n, rows, width) * rows * width floats; counter:
// one word, 0 before the launch and left at 0 by it. A table beyond the
// register path must fit in 48 KB of shared memory.
extern "C" int rt_row_gather_bwd(const void* g, const void* idx, int n, int rows, int width,
                                 void* out, void* partials, void* counter, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int blocks = rt_row_gather_bwd_blocks(n, rows, width);
    if (blocks > 0) {
        switch (width / 4) {
            case 1: launch_chunks<1>(rows, blocks, g, idx, n, partials, counter, out, st); break;
            case 2: launch_chunks<2>(rows, blocks, g, idx, n, partials, counter, out, st); break;
            case 4: launch_chunks<4>(rows, blocks, g, idx, n, partials, counter, out, st); break;
            default: launch_chunks<8>(rows, blocks, g, idx, n, partials, counter, out, st); break;
        }
        return (int)cudaGetLastError();
    }
    size_t smem = (size_t)rows * width * sizeof(float);
    if (rows <= 0 || width <= 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(out, 0, smem, st);
    if (err != cudaSuccess) return (int)err;
    int sms = sm_count();
    long long total = (long long)n * width;
    // a few blocks on every SM; each block's flush costs rows * width atomics
    long long want = (total + kSharedThreads * 16 - 1) / (kSharedThreads * 16);
    long long cap = (long long)sms * 4;
    int grid = (int)(want < cap ? want : cap);
    if (grid < 1) grid = 1;
    row_gather_bwd_shared_kernel<<<grid, kSharedThreads, smem, st>>>(
        (const float*)g, (const int*)idx, (long long)n, rows, width, (float*)out);
    return (int)cudaGetLastError();
}
