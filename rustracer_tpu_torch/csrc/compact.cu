// K6: the stable alive-first partition of a wavefront, and K7: the moves of
// the path state into and out of an alive-first slab.
//
// K6 replaces the order/rank/count of rustracer_tpu/integrators/path.py
// _run (:382-384): order = argsort(~alive) (stable), rank = argsort(order)
// and n_alive = sum(alive). It is a prefix sum over the alive flags, not a
// sort, in one cooperative launch whose blocks are all resident at once:
// (1) each block counts the alive lanes of its tiles of kTileLanes lanes
// (8 flags a thread from one 64-bit load) and publishes each count,
// flagged, in a status array; (2) it waits until every tile's count is
// published, then scans the counts: its tiles' prefixes and the total;
// (3) it writes every lane's position, alive lanes first in lane order,
// dead lanes after them in lane order: rank[i] = pos, order[pos] = i. The
// last block to have read the counts sets the status array back to 0, so
// the next launch on the stream needs no fill. A mask of more tiles than
// the card holds blocks is walked with a tile-stride loop; no block ever
// waits on a block that is not resident.
//
// K7 replaces the forward passes of perm_take (:65) and perm_put (:87) and
// the int/bool takes (:392-403): one launch moves every lane field of the
// path state (ray o/d/t_max, L, beta, alive, prev_pdf, prev_spec, prev_p,
// pixel_idx, sample_idx) between the full width and the w-slab selected by
// order[:w], where the plain version issues one indexing launch per field.
//
// Bound: K6 is a small streaming pass (a few bytes per lane) whose cost on
// the render step is launch and tail latency, not bytes: hence one launch.
// It reads the flags twice (the second time from L2) and stages each tile's
// positions in shared memory, so that rank, and order within each run of
// alive or dead lanes, are written by consecutive threads on consecutive
// words. K7 reads and writes 86 bytes a lane, 11 MB for a 2^16-lane slab:
// it fits in one wave of blocks on the card, so its time is the memory
// latency of each thread's chain of accesses plus the bytes. A thread that
// copied field after field, each load waiting for the store before it (21
// dependent round trips to L2 through char pointers the compiler could not
// tell apart), took twice the bytes' time. Here each thread issues every
// load of its lane's fields before its first store: one round trip. (A
// block that staged its lanes' order entries in shared memory and walked
// the slab side of each field with consecutive threads on consecutive
// words, so that the take's stores and the put's loads were whole sectors
// an instruction, was measured slower: its shared-memory reads and barrier
// cost more than the sectors it saved, which L2 merges anyway.)
#include "common.cuh"

namespace {

constexpr int kOrderThreads = 256;
constexpr int kFlagsPerThread = 8;  // one 64-bit load of bools
constexpr int kTileLanes = kOrderThreads * kFlagsPerThread;
constexpr unsigned kPublished = 0x80000000u;

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

// the flags of this thread's lanes i0 .. i0 + 7 as bits 0 .. 7 (lanes >= n
// are dead); vec: alive starts on an 8-byte boundary, so a thread's flags
// load as one 64-bit word
__device__ __forceinline__ unsigned thread_flags(const unsigned char* alive, long long n,
                                                 long long i0, bool vec) {
    unsigned bits = 0;
    if (vec && i0 + kFlagsPerThread <= n) {
        uint2 w = __ldg(reinterpret_cast<const uint2*>(alive + i0));
#pragma unroll
        for (int b = 0; b < kFlagsPerThread; ++b)
            bits |= (unsigned)((((b < 4 ? w.x : w.y) >> (8 * (b % 4))) & 0xffu) != 0) << b;
    } else {
        for (int j = 0; j < kFlagsPerThread && i0 + j < n; ++j)
            bits |= (unsigned)(alive[i0 + j] != 0) << j;
    }
    return bits;
}

// status: n_tiles published counts, then the count of blocks that have read
// them; all 0 between launches. tile_prefix: dynamic shared memory, one int
// for each tile of this block.
__global__ void __launch_bounds__(kOrderThreads)
    alive_first_kernel(const unsigned char* __restrict__ alive, int n, int n_tiles, int vec,
                       int* __restrict__ order, int* __restrict__ rank, int* __restrict__ n_alive,
                       unsigned* status) {
    extern __shared__ int tile_prefix[];
    __shared__ int warp_sums[32];
    __shared__ __align__(16) int s_pos[kTileLanes];  // the tile's positions, in lane order
    __shared__ bool last;
    volatile unsigned* vstatus = status;
    const long long lanes = n;

    // 1. count and publish this block's tiles
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        long long i0 = (long long)t * kTileLanes + threadIdx.x * kFlagsPerThread;
        int total;
        block_exclusive_scan(__popc(thread_flags(alive, lanes, i0, vec)), warp_sums, &total);
        if (threadIdx.x == 0) atomicExch(status + t, kPublished | (unsigned)total);
        __syncthreads();
    }
    // 2. every tile's count, once published: this block's prefixes, the total
    int carry = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += kOrderThreads) {
        int t = t0 + threadIdx.x;
        int c = 0;
        if (t < n_tiles) {
            unsigned s;
            while (!((s = vstatus[t]) & kPublished)) {
            }
            c = (int)(s & ~kPublished);
        }
        int total;
        int ex = block_exclusive_scan(c, warp_sums, &total);
        if (t < n_tiles && t % gridDim.x == blockIdx.x) tile_prefix[t / gridDim.x] = carry + ex;
        carry += total;
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        if (blockIdx.x == 0) *n_alive = carry;
        __threadfence();
        last = atomicAdd(status + n_tiles, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (last) {  // every block has read every count
        for (int t = threadIdx.x; t < n_tiles; t += kOrderThreads) status[t] = 0;
        if (threadIdx.x == 0) status[n_tiles] = 0;
    }
    // 3. place this block's lanes: positions staged in shared memory, then
    // rank and order written by consecutive threads on consecutive lanes
    for (int t = blockIdx.x, j = 0; t < n_tiles; t += gridDim.x, ++j) {
        long long base = (long long)t * kTileLanes;
        long long i0 = base + threadIdx.x * kFlagsPerThread;
        unsigned bits = thread_flags(alive, lanes, i0, vec);
        int alive_before =
            tile_prefix[j] + block_exclusive_scan(__popc(bits), warp_sums, nullptr);
        int pos[kFlagsPerThread];
#pragma unroll
        for (int q = 0; q < kFlagsPerThread; ++q) {
            bool f = (bits >> q) & 1u;
            pos[q] = f ? alive_before : carry + (int)(i0 + q - alive_before);
            alive_before += f;
        }
#pragma unroll
        for (int q = 0; q < kFlagsPerThread / 4; ++q)
            reinterpret_cast<int4*>(s_pos)[threadIdx.x * (kFlagsPerThread / 4) + q] =
                make_int4(pos[4 * q], pos[4 * q + 1], pos[4 * q + 2], pos[4 * q + 3]);
        __syncthreads();
        int in_tile = (int)min((long long)kTileLanes, lanes - base);
        for (int k = threadIdx.x; k < in_tile; k += kOrderThreads) {
            int pos = s_pos[k];
            rank[base + k] = pos;
            order[pos] = (int)(base + k);
        }
        __syncthreads();  // s_pos and warp_sums are written again by the next tile
    }
}

constexpr int kMaxFields = 16;
constexpr int kSlabThreads = 256;

struct Fields {
    const void* src[kMaxFields];
    void* dst[kMaxFields];
    int bytes[kMaxFields];  // per lane: 1, 4, 8 or 12
    int n;
};

// PUT = false: dst[j] = src[order[j]] (take); PUT = true: dst[order[j]] =
// src[j]. One thread a slab lane: it loads the lane's words of every field
// into registers (a byte, a word, a long or three words a field; the field
// loop unrolled to kMaxFields) and only then stores them, so all of its
// loads are in flight at once.
template <bool PUT>
__global__ void __launch_bounds__(kSlabThreads) slab_kernel(const int* __restrict__ order, int w,
                                                            const Fields f) {
    const int j = blockIdx.x * kSlabThreads + threadIdx.x;
    if (j >= w) return;
    const long long o = __ldg(order + j);
    const long long s = PUT ? j : o, d = PUT ? o : j;
    uint32_t v[kMaxFields][3];
#pragma unroll
    for (int k = 0; k < kMaxFields; ++k) {
        if (k >= f.n) break;
        const int b = f.bytes[k];
        if (b == 12) {
            const uint32_t* __restrict__ p = static_cast<const uint32_t*>(f.src[k]) + 3 * s;
            v[k][0] = __ldg(p);
            v[k][1] = __ldg(p + 1);
            v[k][2] = __ldg(p + 2);
        } else if (b == 8) {
            uint2 x = __ldg(static_cast<const uint2*>(f.src[k]) + s);
            v[k][0] = x.x;
            v[k][1] = x.y;
        } else if (b == 4) {
            v[k][0] = __ldg(static_cast<const uint32_t*>(f.src[k]) + s);
        } else {
            v[k][0] = __ldg(static_cast<const uint8_t*>(f.src[k]) + s);
        }
    }
#pragma unroll
    for (int k = 0; k < kMaxFields; ++k) {
        if (k >= f.n) break;
        const int b = f.bytes[k];
        if (b == 12) {
            uint32_t* __restrict__ p = static_cast<uint32_t*>(f.dst[k]) + 3 * d;
            p[0] = v[k][0];
            p[1] = v[k][1];
            p[2] = v[k][2];
        } else if (b == 8) {
            static_cast<uint2*>(f.dst[k])[d] = make_uint2(v[k][0], v[k][1]);
        } else if (b == 4) {
            static_cast<uint32_t*>(f.dst[k])[d] = v[k][0];
        } else {
            static_cast<uint8_t*>(f.dst[k])[d] = (uint8_t)v[k][0];
        }
    }
}

int slab_move(bool put, const void* order, int w, int n_fields, const long long* src,
              const long long* dst, const int* bytes, void* stream) {
    if (n_fields < 0 || n_fields > kMaxFields) return (int)cudaErrorInvalidValue;
    Fields f;
    f.n = n_fields;
    for (int k = 0; k < n_fields; ++k) {
        if (bytes[k] != 1 && bytes[k] != 4 && bytes[k] != 8 && bytes[k] != 12)
            return (int)cudaErrorInvalidValue;
        f.src[k] = reinterpret_cast<const void*>(src[k]);
        f.dst[k] = reinterpret_cast<void*>(dst[k]);
        f.bytes[k] = bytes[k];
    }
    auto kernel = put ? slab_kernel<true> : slab_kernel<false>;
    kernel<<<rt::blocks_for(w, kSlabThreads), kSlabThreads, 0, (cudaStream_t)stream>>>(
        (const int*)order, w, f);
    return (int)cudaGetLastError();
}

}  // namespace

// status: ceil(n / kTileLanes) + 1 words, 0 before the first launch on a
// stream; each launch leaves them at 0
extern "C" int rt_alive_first_order(const void* alive, int n, void* order, void* rank,
                                    void* n_alive, void* status, void* stream) {
    int n_tiles = rt::blocks_for(n, kTileLanes);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // a tile-stride loop over the tiles: every block must be resident
    size_t smem_cap = sizeof(int) * (size_t)rt::blocks_for(n_tiles, sms);
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, alive_first_kernel, kOrderThreads, smem_cap);
    if (err != cudaSuccess) return (int)err;
    int grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
    if (grid < 1) return (int)cudaErrorInvalidConfiguration;
    size_t smem = sizeof(int) * (size_t)rt::blocks_for(n_tiles, grid);
    const unsigned char* a = (const unsigned char*)alive;
    int vec = ((uintptr_t)alive % kFlagsPerThread) == 0;
    void* args[] = {(void*)&a,    (void*)&n,    (void*)&n_tiles, (void*)&vec,
                    (void*)&order, (void*)&rank, (void*)&n_alive, (void*)&status};
    return (int)cudaLaunchCooperativeKernel((const void*)alive_first_kernel, grid, kOrderThreads,
                                            args, smem, (cudaStream_t)stream);
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
