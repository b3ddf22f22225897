// K12 and K13: the spatial light grid (scene/lightdistrib.py).
//
// K12 spatial_grid_contrib replaces chunk_contrib of
// rustracer_tpu/scene/lightdistrib.py build_spatial_grid (:91-107): for each
// voxel of the scene's bounds and each light, the sum over 128 Halton probes
// (the point vox_lo + h[0:3] * ext in the voxel, the light sample h[3:5]) of
// y(li) / pdf where pdf > 0, li and pdf from the area-light triangle
// sample of scene/lights.py sample_li. One launch covers the whole grid:
// one thread a (voxel, light), blockIdx.y the light, so the Cornell box's
// 64 x 63 x 64 grid and 2 lights are 2,016 blocks of 256, several waves on
// 132 SMs. A thread finds its voxel's lower corner from its flat index
// (flat = (ix * ny + iy) * nz + iz; corner = lo + float(i) * ext, the float
// multiply then add of voxels(), so under -fmad=false the same bits), so
// the host builds and copies no corner array. What depends on the probe and
// the light only is computed once a block into shared memory: each probe's
// point on the light, the light's normal negated, and h[0:3] * ext (the
// product the reference forms for every voxel, the same bits). The
// threads of a warp then read the same probe at once: broadcasts.
//
// Bound: operations, K12_PROBE_OPS (scene/lightdistrib.py) a probe; the
// bytes (the tables in, one float a (voxel, light) out) are a few MB. So a
// probe issues no correctly rounded square root or divide: with
// rs = rsqrtf(dist2) (the approximate reciprocal square root, within 2 ulp),
// cos_l = dot(-n, d) * rs, and a facing probe adds
// y * min(max(|cos_l| * area, 1e-12) * rs * rs, 1e20), which is
// y / max(pdf, 1e-20) with pdf = dist2 / max(|cos_l| * area, 1e-12) and
// 1 / dist2 = rs * rs: each of the reference's clamps is kept, its 1e-20
// floor on the pdf as a 1e20 ceiling on 1 / pdf. Its other clamps bind in
// no case: dist2 >= 1e-12, so the 1e-20 under the square root never does,
// and a facing probe's pdf is above 0 (dist2 over a number in [1e-12,
// area]), so its pdf > 0 test passes for every facing probe, as here. The
// probes are summed in order in one register; the plain version's sums
// agree within a few float roundings a probe (1e-6 relative).
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

// the block's light j = blockIdx.y, its voxels blockIdx.x * kThreads + tid
__global__ void __launch_bounds__(kThreads)
    grid_contrib_kernel(float lo_x, float lo_y, float lo_z, float ext_x, float ext_y,
                        float ext_z, int ny, int nz, int n_vox, const float* __restrict__ halton,
                        int n_probes, const float* __restrict__ tri_p,
                        const bool* __restrict__ tri_rev, const bool* __restrict__ twosided,
                        const float* __restrict__ emit, const float* __restrict__ area,
                        int n_lights, float* __restrict__ out) {
    // a probe's light point, the light's normal negated, and h[0:3] * ext
    __shared__ float4 s_p[kMaxProbes], s_nn[kMaxProbes], s_h[kMaxProbes];
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
        rt::V3 p = (b0 * p0 + b1 * p1) + b2 * p2;
        rt::V3 ng = rt::normalize(rt::cross(p1 - p0, p2 - p0));
        rt::V3 nn = tri_rev[j] ? ng : -ng;
        s_p[s] = make_float4(p.x, p.y, p.z, 0.0f);
        s_nn[s] = make_float4(nn.x, nn.y, nn.z, 0.0f);
        s_h[s] = make_float4(halton[5 * s] * ext_x, halton[5 * s + 1] * ext_y,
                             halton[5 * s + 2] * ext_z, 0.0f);
    }
    __syncthreads();
    const int v = blockIdx.x * kThreads + threadIdx.x;
    if (v >= n_vox) return;
    const int iz = v % nz, iy = (v / nz) % ny, ix = v / (nz * ny);
    const float cx = lo_x + (float)ix * ext_x, cy = lo_y + (float)iy * ext_y,
                cz = lo_z + (float)iz * ext_z;
    const bool two = twosided[j];
    const float ar = area[j];
    // Spectrum::y of the emission; a probe that faces away adds 0
    const float y = 0.212671f * emit[3 * j] + 0.715160f * emit[3 * j + 1] +
                    0.072169f * emit[3 * j + 2];
    float sum = 0.0f;
#pragma unroll 4
    for (int s = 0; s < n_probes; ++s) {
        const float4 h = s_h[s], lp = s_p[s], nn = s_nn[s];
        const float dx = lp.x - (cx + h.x), dy = lp.y - (cy + h.y), dz = lp.z - (cz + h.z);
        const float dist2 = fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f);
        const float rs = rsqrtf(dist2);
        const float cos_l = (nn.x * dx + nn.y * dy + nn.z * dz) * rs;
        const float ac = fabsf(cos_l);
        const bool facing = (two ? ac : cos_l) > 1e-7f;
        const float c = y * fminf(fmaxf(ac * ar, 1e-12f) * rs * rs, 1e20f);
        sum = sum + (facing ? c : 0.0f);
    }
    out[(long long)v * n_lights + j] = sum;
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

// the grid: lower corner lo, voxel extent ext and nv voxels an axis, all
// nv_x * nv_y * nv_z of them at once; halton (n_probes, 5) with n_probes <=
// 128, the light tables of n_lights area lights on triangles (tri_p (L, 3,
// 3), tri_rev, twosided (L,) bool, emit (L, 3), area (L,)) -> out
// (n_vox, n_lights), voxels in C order.
extern "C" int rt_spatial_grid_contrib(float lo_x, float lo_y, float lo_z, float ext_x,
                                       float ext_y, float ext_z, int nv_x, int nv_y, int nv_z,
                                       const void* halton, int n_probes, const void* tri_p,
                                       const void* tri_rev, const void* twosided,
                                       const void* emit, const void* area, int n_lights,
                                       void* out, void* stream) {
    const long long n_vox = (long long)nv_x * nv_y * nv_z;
    if (n_probes < 0 || n_probes > kMaxProbes || n_lights <= 0 || n_lights > 65535 ||
        nv_x <= 0 || nv_y <= 0 || nv_z <= 0 || n_vox > (1LL << 30))
        return (int)cudaErrorInvalidValue;
    dim3 grid(rt::blocks_for((int)n_vox, kThreads), n_lights);
    grid_contrib_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        lo_x, lo_y, lo_z, ext_x, ext_y, ext_z, nv_y, nv_z, (int)n_vox, (const float*)halton,
        n_probes, (const float*)tri_p, (const bool*)tri_rev, (const bool*)twosided,
        (const float*)emit, (const float*)area, n_lights, (float*)out);
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
