// K12 and K13: the spatial light grid (scene/lightdistrib.py).
//
// K12 spatial_grid_contrib replaces chunk_contrib of
// rustracer_tpu/scene/lightdistrib.py build_spatial_grid (:91-107): for each
// voxel of the scene's bounds and each light, the sum over 128 Halton probes
// (the point vox_lo + h[0:3] * ext in the voxel, the light sample h[3:5]) of
// y(li) / pdf where pdf > 0, li and pdf from the area-light triangle
// sample of scene/lights.py sample_li, op for op (-fmad=false). One thread a
// (voxel, light). A probe's point on the light and its normal depend on
// the probe and the light only, so each block (blockIdx.y the light) first
// computes the 128 light samples into shared memory; each thread then walks
// the probes in order and sums them in one register (the reference's XLA
// reduce sums in another order: the sums agree to float rounding). Bound:
// operations, about K12_PROBE_OPS (scene/lightdistrib.py) a probe; the
// bytes (voxel corners in, one float a (voxel, light) out) are a few MB.
//
// K13 spatial_light_pick and spatial_pmf_lookup replace sample_light and
// pmf_lookup (:141-170): one thread a lane computes its voxel in the
// reference's float order, (p - lo) * inv_ext * n_voxels, truncated and
// clipped; the pick counts the cdf entries of the voxel's row at or below u
// (a count, not a search: at ties a search answers otherwise) and gathers
// the pmf of the light picked; the lookup gathers the pmf of a given light.
// Bound: bytes (a lane's point, u or light id, one cdf row and one pmf
// entry in, its id and pmf out).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxProbes = 128;

struct Grid {
    float lo[3], inv_ext[3];
    int nv[3], strides[3];
};

__global__ void __launch_bounds__(kThreads)
    grid_contrib_kernel(const float* __restrict__ vox_lo, int n_vox, float ext_x, float ext_y,
                        float ext_z, const float* __restrict__ halton, int n_probes,
                        const float* __restrict__ tri_p, const bool* __restrict__ tri_rev,
                        const bool* __restrict__ twosided, const float* __restrict__ emit,
                        const float* __restrict__ area, int n_lights,
                        float* __restrict__ out) {
    __shared__ rt::V3 s_p[kMaxProbes], s_n[kMaxProbes];
    const int j = blockIdx.y;
    for (int s = threadIdx.x; s < n_probes; s += kThreads) {
        // triangle_sample (ops/triangle.py) at u = halton[s, 3:5]
        float u0 = halton[5 * s + 3], u1 = halton[5 * s + 4];
        float su0 = sqrtf(u0);
        float b0 = 1.0f - su0;
        float b1 = u1 * su0;
        float b2 = (1.0f - b0) - b1;
        rt::V3 p0 = rt::load3(tri_p + 9 * j), p1 = rt::load3(tri_p + 9 * j + 3),
               p2 = rt::load3(tri_p + 9 * j + 6);
        s_p[s] = (b0 * p0 + b1 * p1) + b2 * p2;
        rt::V3 ng = rt::normalize(rt::cross(p1 - p0, p2 - p0));
        s_n[s] = tri_rev[j] ? -ng : ng;
    }
    __syncthreads();
    const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (v >= n_vox) return;
    const bool two = twosided[j];
    const float ar = area[j];
    // Spectrum::y of the emission; a probe that faces away sees li = 0
    const float y = 0.212671f * emit[3 * j] + 0.715160f * emit[3 * j + 1] +
                    0.072169f * emit[3 * j + 2];
    const rt::V3 lo = rt::load3(vox_lo + 3 * v);
    float sum = 0.0f;
    for (int s = 0; s < n_probes; ++s) {
        rt::V3 p = {lo.x + halton[5 * s] * ext_x, lo.y + halton[5 * s + 1] * ext_y,
                    lo.z + halton[5 * s + 2] * ext_z};
        rt::V3 d = s_p[s] - p;
        float dist2 = fmaxf(rt::dot(d, d), 1e-12f);
        rt::V3 wi = d * rt::rsqrt_rn(fmaxf(dist2, 1e-20f));
        float cos_l = rt::dot(s_n[s], -wi);
        bool facing = two ? fabsf(cos_l) > 1e-7f : cos_l > 1e-7f;
        float pdf = facing ? dist2 / fmaxf(fabsf(cos_l) * ar, 1e-12f) : 0.0f;
        float yl = facing ? y : 0.0f;
        sum = sum + (pdf > 0.0f ? yl / fmaxf(pdf, 1e-20f) : 0.0f);
    }
    out[v * n_lights + j] = sum;
}

__device__ __forceinline__ int voxel_of(const Grid& g, const float* p) {
    int flat = 0;
    for (int a = 0; a < 3; ++a) {
        float f = ((p[a] - g.lo[a]) * g.inv_ext[a]) * (float)g.nv[a];
        // saturating truncation toward zero (NaN to 0), then the clip
        int vi = (int)truncf(fminf(fmaxf(f, -1.0f), (float)g.nv[a]));
        vi = min(max(vi, 0), g.nv[a] - 1);
        flat += vi * g.strides[a];
    }
    return flat;
}

__global__ void __launch_bounds__(kThreads)
    light_pick_kernel(const float* __restrict__ p, const float* __restrict__ u, int n, Grid g,
                      const float* __restrict__ cdf, const float* __restrict__ pmf,
                      int n_lights, int* __restrict__ lid_out, float* __restrict__ pmf_out) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const long long row = (long long)voxel_of(g, p + 3 * i) * n_lights;
    const float ui = u[i];
    int count = 0;
    for (int k = 0; k < n_lights; ++k) count += ui >= cdf[row + k] ? 1 : 0;
    const int lid = min(count, n_lights - 1);
    lid_out[i] = lid;
    pmf_out[i] = pmf[row + lid];
}

__global__ void __launch_bounds__(kThreads)
    pmf_lookup_kernel(const float* __restrict__ p, const int* __restrict__ lid, int n, Grid g,
                      const float* __restrict__ pmf, int n_lights,
                      float* __restrict__ pmf_out) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const long long row = (long long)voxel_of(g, p + 3 * i) * n_lights;
    pmf_out[i] = pmf[row + min(max(lid[i], 0), n_lights - 1)];
}

Grid make_grid(const float* lo, const float* inv_ext, const int* nv) {
    Grid g;
    for (int a = 0; a < 3; ++a) {
        g.lo[a] = lo[a];
        g.inv_ext[a] = inv_ext[a];
        g.nv[a] = nv[a];
    }
    g.strides[0] = nv[1] * nv[2];
    g.strides[1] = nv[2];
    g.strides[2] = 1;
    return g;
}

}  // namespace

// vox_lo (n_vox, 3), halton (n_probes, 5) with n_probes <= 128, the light
// tables of n_lights area lights on triangles (tri_p (L, 3, 3), tri_rev,
// twosided (L,) bool, emit (L, 3), area (L,)) -> out (n_vox, n_lights).
extern "C" int rt_spatial_grid_contrib(const void* vox_lo, int n_vox, float ext_x, float ext_y,
                                       float ext_z, const void* halton, int n_probes,
                                       const void* tri_p, const void* tri_rev,
                                       const void* twosided, const void* emit, const void* area,
                                       int n_lights, void* out, void* stream) {
    if (n_probes < 0 || n_probes > kMaxProbes || n_lights <= 0 || n_lights > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid(rt::blocks_for(n_vox, kThreads), n_lights);
    grid_contrib_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)vox_lo, n_vox, ext_x, ext_y, ext_z, (const float*)halton, n_probes,
        (const float*)tri_p, (const bool*)tri_rev, (const bool*)twosided, (const float*)emit,
        (const float*)area, n_lights, (float*)out);
    return (int)cudaGetLastError();
}

// p (n, 3), u (n,) -> lid (n,) int32, pmf (n,); the grid: lo, inv_ext (3,)
// and nv (3,) host values, cdf and pmf (V, n_lights) on the card
extern "C" int rt_spatial_light_pick(const void* p, const void* u, int n, float lo_x, float lo_y,
                                     float lo_z, float ie_x, float ie_y, float ie_z, int nv_x,
                                     int nv_y, int nv_z, const void* cdf, const void* pmf,
                                     int n_lights, void* lid_out, void* pmf_out, void* stream) {
    const float lo[3] = {lo_x, lo_y, lo_z}, ie[3] = {ie_x, ie_y, ie_z};
    const int nv[3] = {nv_x, nv_y, nv_z};
    if (n <= 0) return (int)cudaSuccess;
    light_pick_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)p, (const float*)u, n, make_grid(lo, ie, nv), (const float*)cdf,
        (const float*)pmf, n_lights, (int*)lid_out, (float*)pmf_out);
    return (int)cudaGetLastError();
}

// p (n, 3), lid (n,) int32 (clipped to [0, n_lights)) -> pmf (n,)
extern "C" int rt_spatial_pmf_lookup(const void* p, const void* lid, int n, float lo_x,
                                     float lo_y, float lo_z, float ie_x, float ie_y, float ie_z,
                                     int nv_x, int nv_y, int nv_z, const void* pmf, int n_lights,
                                     void* pmf_out, void* stream) {
    const float lo[3] = {lo_x, lo_y, lo_z}, ie[3] = {ie_x, ie_y, ie_z};
    const int nv[3] = {nv_x, nv_y, nv_z};
    if (n <= 0) return (int)cudaSuccess;
    pmf_lookup_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)p, (const int*)lid, n, make_grid(lo, ie, nv), (const float*)pmf, n_lights,
        (float*)pmf_out);
    return (int)cudaGetLastError();
}
