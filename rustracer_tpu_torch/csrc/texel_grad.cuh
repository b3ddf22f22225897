// Device code shared by the texel-gradient kernels K10 (atlas_bwd.cu) and
// K20 (mipmap_bwd.cu): a warp's adds into one (T, 3) gradient array, summed
// in registers by texel before any global atomic.
#pragma once

#include <cuda_runtime.h>

namespace rt_grad {

// adds (r, g, b) into texel `key` of g_tex (key < 0: nothing); every lane
// of the warp calls it. The lanes with the same key find each other
// (__match_any_sync) and sum their values in a tree of shuffles; the first
// of them adds the sum with one atomic a channel (an add of exactly 0 is
// left out: it would change no bit, the gradient starts at +0)
__device__ __forceinline__ void add_texel(float* g_tex, int key, float r, float g, float b) {
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    unsigned rel = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
    // peers above it; lanes without a texel sum nothing
    unsigned higher = key < 0 ? 0u : peers & ~((2u << lane) - 1u);
    // each round a lane adds its next remaining peer's partial sum, then
    // the lanes at odd positions drop out; the first lane ends with all
    while (__any_sync(0xffffffffu, higher)) {
        int next = __ffs(higher);
        float tr = __shfl_sync(0xffffffffu, r, (next - 1) & 31);
        float tg = __shfl_sync(0xffffffffu, g, (next - 1) & 31);
        float tb = __shfl_sync(0xffffffffu, b, (next - 1) & 31);
        if (next) {
            r += tr;
            g += tg;
            b += tb;
        }
        higher &= ~__ballot_sync(0xffffffffu, rel & 1u);
        rel >>= 1;
    }
    if (lane != __ffs(peers) - 1 || key < 0) return;
    float* p = g_tex + 3 * (long long)key;
    if (r != 0.0f) atomicAdd(p, r);
    if (g != 0.0f) atomicAdd(p + 1, g);
    if (b != 0.0f) atomicAdd(p + 2, b);
}

}  // namespace rt_grad
