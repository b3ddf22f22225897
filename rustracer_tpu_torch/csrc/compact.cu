// K6: the stable alive-first partition of a wavefront, and K7: the moves of
// the path state into and out of an alive-first slab.
//
// K6 replaces the order/rank/count of rustracer_tpu/integrators/path.py
// _run (:382-384): order = argsort(~alive) (stable), rank = argsort(order)
// and n_alive = sum(alive). It is a prefix sum over the alive flags, not a
// sort: (1) each block counts the alive lanes of its 1024-lane chunk with
// warp ballots; (2) one block scans the chunk counts into chunk offsets and
// the total; (3) each block recomputes its chunk's in-block prefix and
// writes every lane's position, alive lanes first in lane order, dead lanes
// after them in lane order: rank[i] = pos, order[pos] = i.
//
// K7 replaces the forward passes of perm_take (:65) and perm_put (:87) and
// the int/bool takes (:392-403): one launch moves every lane field of the
// path state (ray o/d/t_max, L, beta, alive, prev_pdf, prev_spec, prev_p,
// pixel_idx, sample_idx) between the full width and the w-slab selected by
// order[:w], where the plain version issues one indexing launch per field.
//
// Bound: both are small streaming passes (a few bytes per lane for K6,
// about 90 bytes per lane for K7) whose cost on the render step is the
// launch count; the design spends three launches on K6 and one on each K7
// move. Within a chunk K6 touches each flag twice from L2; K7 reads the
// order once per lane and copies each field with one to three aligned
// word accesses.
#include "common.cuh"

namespace {

constexpr int kScanThreads = 256;
constexpr int kChunk = 1024;  // lanes per block in K6 passes 1 and 3
constexpr int kPerThread = kChunk / kScanThreads;

__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int s = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            int y = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s += y;
        }
        warp_sums[lane] = s;  // inclusive over warps
    }
    __syncthreads();
    int before = warp > 0 ? warp_sums[warp - 1] : 0;
    if (total != nullptr) *total = warp_sums[(blockDim.x >> 5) - 1];
    return before + x - v;
}

// lanes [base, base + kChunk) of thread t: base + t * kPerThread + j
__device__ __forceinline__ int chunk_flags(const bool* alive, int n, int base, bool* f) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
        int i = base + threadIdx.x * kPerThread + j;
        f[j] = i < n && alive[i];
        c += f[j];
    }
    return c;
}

__global__ void count_kernel(const bool* __restrict__ alive, int n, int* __restrict__ counts) {
    __shared__ int warp_sums[32];
    bool f[kPerThread];
    int c = chunk_flags(alive, n, blockIdx.x * kChunk, f);
    int total;
    block_exclusive_scan(c, warp_sums, &total);
    if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// one block: exclusive scan of the chunk counts in place, total to *n_alive
__global__ void scan_counts_kernel(int* __restrict__ counts, int n_chunks, int* __restrict__ n_alive) {
    __shared__ int warp_sums[32];
    int carry = 0;
    for (int base = 0; base < n_chunks; base += blockDim.x) {
        int i = base + threadIdx.x;
        int v = i < n_chunks ? counts[i] : 0;
        int total;
        int ex = block_exclusive_scan(v, warp_sums, &total);
        if (i < n_chunks) counts[i] = carry + ex;
        carry += total;
        __syncthreads();
    }
    if (threadIdx.x == 0) *n_alive = carry;
}

__global__ void place_kernel(const bool* __restrict__ alive, int n, const int* __restrict__ offsets,
                             const int* __restrict__ n_alive, int* __restrict__ order,
                             int* __restrict__ rank) {
    __shared__ int warp_sums[32];
    bool f[kPerThread];
    int base = blockIdx.x * kChunk;
    int c = chunk_flags(alive, n, base, f);
    int alive_before = offsets[blockIdx.x] + block_exclusive_scan(c, warp_sums, nullptr);
    int total = *n_alive;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
        int i = base + threadIdx.x * kPerThread + j;
        if (i >= n) break;
        int pos = f[j] ? alive_before : total + (i - alive_before);
        alive_before += f[j];
        rank[i] = pos;
        order[pos] = i;
    }
}

constexpr int kMaxFields = 16;

struct Fields {
    const char* src[kMaxFields];
    char* dst[kMaxFields];
    int bytes[kMaxFields];  // per lane: 1, 4, 8 or 12
    int n;
};

__device__ __forceinline__ void copy_lane(const char* src, char* dst, int bytes, long long s,
                                          long long d) {
    switch (bytes) {
        case 1:
            dst[d] = src[s];
            break;
        case 4:
            reinterpret_cast<int*>(dst)[d] = reinterpret_cast<const int*>(src)[s];
            break;
        case 8:
            reinterpret_cast<long long*>(dst)[d] = reinterpret_cast<const long long*>(src)[s];
            break;
        default: {  // 12: three words
            const int* a = reinterpret_cast<const int*>(src) + 3 * s;
            int* b = reinterpret_cast<int*>(dst) + 3 * d;
            b[0] = a[0];
            b[1] = a[1];
            b[2] = a[2];
        }
    }
}

// PUT = false: dst[j] = src[order[j]] (take); PUT = true: dst[order[j]] = src[j]
template <bool PUT>
__global__ void slab_kernel(const int* __restrict__ order, int w, Fields f) {
    int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= w) return;
    int o = order[j];
    long long s = PUT ? j : o, d = PUT ? o : j;
    for (int k = 0; k < f.n; ++k) copy_lane(f.src[k], f.dst[k], f.bytes[k], s, d);
}

int slab_move(bool put, const void* order, int w, int n_fields, const long long* src,
              const long long* dst, const int* bytes, void* stream) {
    if (n_fields > kMaxFields) return (int)cudaErrorInvalidValue;
    Fields f;
    f.n = n_fields;
    for (int k = 0; k < n_fields; ++k) {
        f.src[k] = reinterpret_cast<const char*>(src[k]);
        f.dst[k] = reinterpret_cast<char*>(dst[k]);
        f.bytes[k] = bytes[k];
    }
    constexpr int kThreads = 256;
    auto kernel = put ? slab_kernel<true> : slab_kernel<false>;
    kernel<<<rt::blocks_for(w, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)order, w, f);
    return (int)cudaGetLastError();
}

}  // namespace

// scratch: ceil(n / 1024) ints for the chunk counts
extern "C" int rt_alive_first_order(const void* alive, int n, void* order, void* rank,
                                    void* n_alive, void* scratch, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int n_chunks = rt::blocks_for(n, kChunk);
    count_kernel<<<n_chunks, kScanThreads, 0, s>>>((const bool*)alive, n, (int*)scratch);
    scan_counts_kernel<<<1, 1024, 0, s>>>((int*)scratch, n_chunks, (int*)n_alive);
    place_kernel<<<n_chunks, kScanThreads, 0, s>>>((const bool*)alive, n, (const int*)scratch,
                                                   (const int*)n_alive, (int*)order, (int*)rank);
    return (int)cudaGetLastError();
}

// src, dst: host arrays of n_fields device addresses; bytes: per-lane sizes
extern "C" int rt_slab_take(const void* order, int w, int n_fields, const long long* src,
                            const long long* dst, const int* bytes, void* stream) {
    return slab_move(false, order, w, n_fields, src, dst, bytes, stream);
}

extern "C" int rt_slab_put(const void* order, int w, int n_fields, const long long* src,
                           const long long* dst, const int* bytes, void* stream) {
    return slab_move(true, order, w, n_fields, src, dst, bytes, stream);
}
