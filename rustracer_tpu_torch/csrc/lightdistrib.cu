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
// K12's lights kernel spatial_grid_contrib_lights computes the same sums for
// a table of any light types (scene/lights.py LightTables), the reference's
// sample_li for each (rustracer_tpu/scene/lights.py:415-509). Nothing is
// read back to the host: a call launches K12's kernel itself over every
// row, a block a row, for the triangle lights (the same bits and
// registers; a block of another branch's row returns at once), then one
// grid_contrib_lights_kernel<M> a set M of the other branches (LightSets:
// quadric, full sphere, point, and the uniform rows of distant and
// infinite lights), one wave of blocks that take the items (a row, 256
// voxels) of the set's rows from a queue an SM (next_item), so that the
// items of one branch spread evenly over the SMs. A quadric's
// uniform-area point and normal of each probe are computed once an item
// into shared memory; a full sphere seen from a probe point outside it
// takes the cone instead (lights.cuh cone_sample), per (voxel, probe),
// with cosf and sinf of its phi, which depend on the probe alone, computed
// once a probe in the staging, and the area pdf only where the cone does
// not apply. A point light's contribution needs the probe point (e / dist2
// as one divide and three products). A distant or infinite light's
// depends on the probe alone: the block computes the 128 contributions
// once (an infinite light's Distribution2D sample and map lookup,
// lights.cuh), one thread sums them in order (four a shared load), and
// every thread writes the sum. Each probe is computed as the plain
// version's sample_li computes it, operation for operation, with 1/sqrtf
// for torch.rsqrt and CUDA's sinf and cosf, so the sums agree within a few
// float roundings a probe; every sum but a point light's has the bits of
// the one-kernel design before it. Bound: operations
// (tools/light_work.py k12_light_work), except the distant and infinite
// branches (bytes: a float a voxel out).
//
// K13 spatial_light_pick and spatial_pmf_lookup replace sample_light and
// pmf_lookup (:141-170): one thread a lane computes its voxel in the
// reference's float order, (p - lo) * inv_ext * n_voxels, truncated and
// clipped; the pick counts the cdf entries of the voxel's row at or below u
// (a count, not a search: at ties a search answers otherwise) and gathers
// the pmf of the light picked; the lookup gathers the pmf of a given light.
// Bound: bytes (a lane's point, u or light id, one cdf row and one pmf
// entry in, its id and pmf out).
#include <algorithm>
#include <climits>
#include <type_traits>

#include "lights.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxProbes = 128;

struct Grid {
    float lo[3], inv_ext[3];
    int nv[3], strides[3];
};

// A triangle light's probe: its point on the light, the light's normal
// negated (tri_p (3, 3) of light j), at u = halton[s, 3:5] (triangle_sample,
// ops/triangle.py)
__device__ __forceinline__ void tri_probe(const float* __restrict__ halton, int s,
                                          const float* __restrict__ tri_p,
                                          const bool* __restrict__ tri_rev, int j, float4* lp,
                                          float4* nn_out) {
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
    *lp = make_float4(p.x, p.y, p.z, 0.0f);
    *nn_out = make_float4(nn.x, nn.y, nn.z, 0.0f);
}

// The triangle light's sum over the probes at the voxel corner c
__device__ __forceinline__ float tri_sum(const float4* s_p, const float4* s_nn, const float4* s_h,
                                         int n_probes, float cx, float cy, float cz, bool two,
                                         float ar, float y) {
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
    return sum;
}

constexpr int kPoint = 0, kDistant = 1, kArea = 2, kInfinite = 3;

// the block's light j = blockIdx.y, its voxels blockIdx.x * kThreads + tid.
// For K12's lights kernel (kRows), the tables are a light table's, of
// every light type (type, q_type: scene/lights.py LightTables), and a
// block whose row is not a triangle light returns at once.
template <bool kRows>
__global__ void __launch_bounds__(kThreads)
    grid_contrib_kernel(float lo_x, float lo_y, float lo_z, float ext_x, float ext_y,
                        float ext_z, int ny, int nz, int n_vox, const float* __restrict__ halton,
                        int n_probes, const float* __restrict__ tri_p,
                        const bool* __restrict__ tri_rev, const bool* __restrict__ twosided,
                        const float* __restrict__ emit, const float* __restrict__ area,
                        int n_lights, const int* __restrict__ type,
                        const int* __restrict__ q_type, float* __restrict__ out) {
    // a probe's light point, the light's normal negated, and h[0:3] * ext
    __shared__ float4 s_p[kMaxProbes], s_nn[kMaxProbes], s_h[kMaxProbes];
    const int j = blockIdx.y;
    if (kRows && !(type[j] == kArea && q_type[j] < 0)) return;
    for (int s = threadIdx.x; s < n_probes; s += kThreads) {
        tri_probe(halton, s, tri_p, tri_rev, j, s_p + s, s_nn + s);
        s_h[s] = make_float4(halton[5 * s] * ext_x, halton[5 * s + 1] * ext_y,
                             halton[5 * s + 2] * ext_z, 0.0f);
    }
    __syncthreads();
    const int v = blockIdx.x * kThreads + threadIdx.x;
    if (v >= n_vox) return;
    const int iz = v % nz, iy = (v / nz) % ny, ix = v / (nz * ny);
    const float cx = lo_x + (float)ix * ext_x, cy = lo_y + (float)iy * ext_y,
                cz = lo_z + (float)iz * ext_z;
    // Spectrum::y of the emission; a probe that faces away adds 0
    const float y = 0.212671f * emit[3 * j] + 0.715160f * emit[3 * j + 1] +
                    0.072169f * emit[3 * j + 2];
    out[(long long)v * n_lights + j] =
        tri_sum(s_p, s_nn, s_h, n_probes, cx, cy, cz, twosided[j], area[j], y);
}

// The light table of spatial_grid_contrib_lights (scene/lights.py
// LightTables): every row's type, position or direction, emission,
// two-sidedness and area; a triangle light's vertices; an area light's
// quadric; each row's infinite light and their flat table.
struct LightRows {
    const int* type;
    const float *pos, *emit;
    const bool* twosided;
    const float *area, *tri_p;
    const bool* tri_rev;
    const int* q_type;
    const float *q_o2w, *q_w2o, *q_params;
    const bool *q_rev, *cone;
    const int* row_inf;
    const float* inf_flat;
    const int* inf_desc;
    const float* inf_l2w;
};

// contribution y(li) / pdf of a probe where pdf > 0 (scene/lightdistrib.py
// _y_over_pdf)
__device__ __forceinline__ float y_over_pdf(float y, float pdf) {
    return pdf > 0.0f ? y / fmaxf(pdf, 1e-20f) : 0.0f;
}

// The branches of the lights kernel: a triangle light (K12's kernel
// itself, grid_contrib_kernel<true>), an area light on a quadric (kQuad),
// a full sphere's (the cone from a probe point outside it, kCone), a point
// light, and the lights whose contribution does not depend on the voxel
// (distant and infinite lights, and a dummy row's zeros: kUniform).
enum Branch : int { kTri, kQuad, kCone, kPointRow, kUniform };
__host__ __device__ constexpr int bit(int b) { return 1 << b; }

__device__ __forceinline__ int branch_of(const LightRows& L, int j) {
    const int t = L.type[j];
    return t == kArea    ? (L.q_type[j] < 0 ? kTri : L.cone[j] ? kCone : kQuad)
           : t == kPoint ? kPointRow
                         : kUniform;
}

// The queues of the lights kernel's items: an SM's blocks take the items
// of its own queue first (next[q] the position of the next one), then those
// of the queues that still hold some. Reset before each launch.
constexpr int kMaxQueues = 1024;
__device__ unsigned g_next[kMaxQueues];

__device__ __forceinline__ unsigned sm_id() {
#ifdef __CUDA_ARCH__
    unsigned id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    return id;
#else
    return 0;
#endif
}

// queue q of n_queues holds the items q, q + n_queues, ... below n_items
__device__ __forceinline__ long long queue_len(int q, int n_queues, long long n_items) {
    return q < n_items ? (n_items - q + n_queues - 1) / n_queues : 0;
}

// the rows whose branches a block of the lights kernel holds in shared
// memory
constexpr int kRowCache = 512;

// (thread 0) the next item of queue q whose row's branch is in the set M
// -> its row, its chunk and the row's branch in *item, or false where the
// queue holds no more: the rest of a row of another branch in the queue is
// passed over at once. br: the first kRowCache rows' branches.
template <int M>
__device__ bool next_item(const LightRows& L, const unsigned char* br, unsigned* next, int q,
                          int n_queues, int n_vox, int n_lights, int3* item) {
    const int chunks = (n_vox + kThreads - 1) / kThreads;
    const long long len = queue_len(q, n_queues, (long long)chunks * n_lights);
    for (;;) {
        const unsigned p = atomicAdd(next + q, 1u);
        if (p >= len) return false;
        const long long i = q + (long long)p * n_queues;
        const int j = (int)(i / chunks);
        const int b = j < kRowCache ? br[j] : branch_of(L, j);
        if (M & bit(b)) {
            *item = make_int3(j, (int)(i - (long long)j * chunks), b);
            return true;
        }
        const long long end = (long long)(j + 1) * chunks;
        atomicMax(next + q, (unsigned)((end - q + n_queues - 1) / n_queues));
    }
}

// A launch covers every row of the table as items (light j, voxels chunk
// * kThreads + tid), j outer, item i in queue i % n_queues, and holds one
// wave of blocks (lights_wave) that take the items from the queues
// (next_item), each block from its SM's queue first. The items of one
// branch are consecutive, so each queue holds an equal share of them, and
// no SM runs more of them at once than that share. (A grid of an item a
// block, or blocks that walk the items in a fixed order, let the blocks
// of the items of other branches, which return at once, leave their slots
// to working blocks: the block scheduler hands a wave out several
// consecutive blocks an SM, so some SMs ran 4 or 5 sphere items at once
// where 3 an SM was the even share.) A launch of one branch compiles that
// branch alone, with its own registers. What depends on the probe and the
// light only is computed once an item into shared memory: a quadric's
// uniform-area point and normal, cosf and sinf of the cone's phi, and a
// distant or infinite light's whole contribution, whose in-order sum over
// the probes one thread takes and every thread writes.
template <int M>
__global__ void __launch_bounds__(kThreads)
    grid_contrib_lights_kernel(float lo_x, float lo_y, float lo_z, float ext_x, float ext_y,
                               float ext_z, int ny, int nz, int n_vox,
                               const float* __restrict__ halton, int n_probes, LightRows L,
                               int n_lights, int n_queues, unsigned* __restrict__ next,
                               float* __restrict__ out) {
    constexpr bool kQuadrics = (M & (bit(kQuad) | bit(kCone))) != 0;
    constexpr bool kPoints = (M & bit(kPointRow)) != 0;
    constexpr bool kUniforms = (M & bit(kUniform)) != 0;
    __shared__ float4 s_p[kQuadrics ? kMaxProbes : 1], s_n[kQuadrics ? kMaxProbes : 1];
    __shared__ float4 s_h[kQuadrics || kPoints ? kMaxProbes : 1];
    __shared__ float2 s_cs[(M & bit(kCone)) ? kMaxProbes : 1];
    __shared__ float4 s_c[kUniforms ? kMaxProbes / 4 : 1];
    __shared__ float s_sum;
    // the block's queue and item (its row, chunk and branch; a row of -1:
    // the queue is empty), held here, not in registers across the item
    __shared__ int s_q, s_steal, s_rows;
    __shared__ int3 s_item;
    // the first kRowCache rows' branches, and how many of them are in M (a
    // launch with none returns at once)
    __shared__ unsigned char s_br[kRowCache];
    if (threadIdx.x == 0) {
        s_q = (int)(sm_id() % (unsigned)n_queues);
        s_rows = n_lights > kRowCache ? 1 : 0;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < min(n_lights, kRowCache); r += kThreads) {
        const int b = branch_of(L, r);
        s_br[r] = (unsigned char)b;
        if (M & bit(b)) atomicAdd(&s_rows, 1);
    }
    __syncthreads();
    if (s_rows == 0) return;
    for (;;) {
        // the previous item's reads of s_item, s_steal and the staging are
        // done
        __syncthreads();
        if (threadIdx.x == 0 &&
            !next_item<M>(L, s_br, next, s_q, n_queues, n_vox, n_lights, &s_item))
            s_item.x = -1;
        __syncthreads();
        if (s_item.x < 0) {
            // the first queue after the own one that still holds items
            if (threadIdx.x == 0) s_steal = INT_MAX;
            __syncthreads();
            const int own = (int)(sm_id() % (unsigned)n_queues);
            const long long n_items =
                (long long)((n_vox + kThreads - 1) / kThreads) * n_lights;
            for (int k = threadIdx.x; k < n_queues - 1; k += kThreads) {
                const int r = (own + 1 + k) % n_queues;
                if (*(volatile unsigned*)(next + r) < queue_len(r, n_queues, n_items))
                    atomicMin(&s_steal, k);
            }
            __syncthreads();
            if (s_steal == INT_MAX) return;
            if (threadIdx.x == 0) s_q = (own + 1 + s_steal) % n_queues;
            continue;
        }
        const int j = s_item.x, b = s_item.z;
        // the row is of branch B (a constant in a launch of one branch)
        const auto is = [b](int B) { return (M & bit(B)) != 0 && (M == bit(B) || b == B); };
        const rt::V3 e = rt::load3(L.emit + 3 * j);
        const float y = 0.212671f * e.x + 0.715160f * e.y + 0.072169f * e.z;
        const rt::QLight Q{L.q_type[j], L.q_o2w + 16 * j, L.q_w2o + 16 * j,
                           rt::QParams{L.q_params[4 * j], L.q_params[4 * j + 1],
                                       L.q_params[4 * j + 2], L.q_params[4 * j + 3]},
                           L.q_rev[j]};
        for (int s = threadIdx.x; s < n_probes; s += kThreads) {
            const float u0 = halton[5 * s + 3], u1 = halton[5 * s + 4];
            if (!is(kUniform))
                s_h[s] = make_float4(halton[5 * s] * ext_x, halton[5 * s + 1] * ext_y,
                                     halton[5 * s + 2] * ext_z, 0.0f);
            if (is(kQuad) || is(kCone)) {
                rt::V3 p, n;
                rt::quadric_sample(Q, u0, u1, &p, &n);
                s_p[s] = make_float4(p.x, p.y, p.z, u0);
                s_n[s] = make_float4(n.x, n.y, n.z, u1);
                if (is(kCone)) {
                    const float phi = u1 * 2.0f * rt::kPi;
                    s_cs[s] = make_float2(cosf(phi), sinf(phi));
                }
            } else if (is(kUniform)) {
                const int type = L.type[j];
                float c = 0.0f;
                if (type == kDistant) {
                    c = y_over_pdf(y, 1.0f);
                } else if (type == kInfinite) {
                    const int k = L.row_inf[j];
                    const rt::InfLight I = rt::inf_light(L.inf_flat, L.inf_desc, k);
                    float uv0, uv1, map_pdf, st;
                    rt::sample_2d(I, u0, u1, &uv0, &uv1, &map_pdf);
                    rt::inf_uv_to_dir(L.inf_l2w + 16 * k, uv0, uv1, &st);
                    const rt::V3 v = rt::bilerp_repeat(I.map, I.h, I.w, uv0, uv1);
                    c = y_over_pdf(rt::lum(rt::V3{v.x * e.x, v.y * e.y, v.z * e.z}),
                                   rt::inf_pdf(map_pdf, st));
                }
                reinterpret_cast<float*>(s_c)[s] = c;
            }
        }
        __syncthreads();
        const int v = s_item.y * kThreads + threadIdx.x;
        if (is(kUniform)) {
            // the probes' in-order sum, once an item: four probes a shared
            // load, eight loads in flight
            if (threadIdx.x == 0) {
                float sum = 0.0f;
                int s = 0;
#pragma unroll 8
                for (; s + 4 <= n_probes; s += 4) {
                    const float4 c = s_c[s / 4];
                    sum = sum + c.x;
                    sum = sum + c.y;
                    sum = sum + c.z;
                    sum = sum + c.w;
                }
                for (; s < n_probes; ++s) sum = sum + reinterpret_cast<const float*>(s_c)[s];
                s_sum = sum;
            }
            __syncthreads();
            if (v < n_vox) out[(long long)v * n_lights + j] = s_sum;
            continue;
        }
        if (v >= n_vox) continue;
        const int iz = v % nz, iy = (v / nz) % ny, ix = v / (nz * ny);
        const float cx = lo_x + (float)ix * ext_x, cy = lo_y + (float)iy * ext_y,
                    cz = lo_z + (float)iz * ext_z;
        float sum = 0.0f;
        if (is(kQuad) || is(kCone)) {
            const bool two = L.twosided[j], cone = is(kCone);
            const float ar = L.area[j];
            for (int s = 0; s < n_probes; ++s) {
                const float4 h = s_h[s], lp = s_p[s], ln = s_n[s];
                const rt::V3 p{cx + h.x, cy + h.y, cz + h.z};
                rt::V3 pa{lp.x, lp.y, lp.z}, na{ln.x, ln.y, ln.z};
                float pdf = 0.0f;
                bool in_cone = false;
                if (cone) {
                    const float2 cs = s_cs[s];
                    in_cone = rt::cone_sample(Q, p, lp.w, cs.x, cs.y, &pa, &na, &pdf);
                }
                const rt::V3 d = pa - p;
                const float dist2 = fmaxf(rt::dot(d, d), 1e-12f);
                const rt::V3 wi = d * rt::rsqrt_rn(fmaxf(dist2, 1e-20f));
                const float cos_l = rt::dot(na, -wi);
                const bool facing = two ? fabsf(cos_l) > 1e-7f : cos_l > 1e-7f;
                // the area pdf only where the cone does not apply
                if (!in_cone) pdf = dist2 / fmaxf(fabsf(cos_l) * ar, 1e-12f);
                sum = sum + y_over_pdf(y, facing ? pdf : 0.0f);
            }
        } else if (is(kPointRow)) {
            const rt::V3 pos = rt::load3(L.pos + 3 * j);
            for (int s = 0; s < n_probes; ++s) {
                const float4 h = s_h[s];
                const rt::V3 d = pos - rt::V3{cx + h.x, cy + h.y, cz + h.z};
                const float r = 1.0f / fmaxf(rt::dot(d, d), 1e-12f);
                sum = sum + y_over_pdf(rt::lum(rt::V3{e.x * r, e.y * r, e.z * r}), 1.0f);
            }
        }
        out[(long long)v * n_lights + j] = sum;
    }
}

// The wave of a launch of grid_contrib_lights_kernel<M>: the SMs times the
// blocks an SM holds at once, and a queue an SM (device queries, once a
// process and instantiation).
template <int M>
cudaError_t lights_wave(int* blocks, int* queues) {
    static int sms = 0, per_sm = 0;
    if (sms == 0) {
        int dev = 0, n = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, grid_contrib_lights_kernel<M>, kThreads, 0);
        if (err != cudaSuccess) return err;
        sms = std::max(n, 1);
    }
    *queues = std::min(sms, kMaxQueues);
    *blocks = sms * std::max(per_sm, 1);
    return cudaSuccess;
}

// The launches of the lights kernel beside K12's kernel on the triangle
// rows: one a set of branches (each a set of Branch bits)
template <int... Ms>
struct Sets {};
using LightSets = Sets<bit(kQuad) | bit(kCone) | bit(kPointRow) | bit(kUniform)>;

template <int... Ms, class F>
cudaError_t each_set(Sets<Ms...>, F launch) {
    cudaError_t err = cudaSuccess;
    ((err = err == cudaSuccess ? launch(std::integral_constant<int, Ms>{}) : err), ...);
    return err;
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
    grid_contrib_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        lo_x, lo_y, lo_z, ext_x, ext_y, ext_z, nv_y, nv_z, (int)n_vox, (const float*)halton,
        n_probes, (const float*)tri_p, (const bool*)tri_rev, (const bool*)twosided,
        (const float*)emit, (const float*)area, n_lights, nullptr, nullptr, (float*)out);
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

// The grid as spatial_grid_contrib's, over a table of any light types
// (LightRows, scene/lights.py LightTables) -> out (n_vox, n_lights): K12's
// kernel over every row for the triangle lights, then a launch over every
// row a set of the other branches (LightSets), a block of another branch's
// row returning at once; nothing is read back to the host.
extern "C" int rt_spatial_grid_contrib_lights(
    float lo_x, float lo_y, float lo_z, float ext_x, float ext_y, float ext_z, int nv_x,
    int nv_y, int nv_z, const void* halton, int n_probes, const void* l_type,
    const void* l_pos, const void* l_emit, const void* l_twosided, const void* l_area,
    const void* tri_p, const void* tri_rev, const void* q_type, const void* q_o2w,
    const void* q_w2o, const void* q_params, const void* q_rev, const void* cone,
    const void* row_inf, const void* inf_flat, const void* inf_desc, const void* inf_l2w,
    int n_lights, void* out, void* stream) {
    const long long n_vox = (long long)nv_x * nv_y * nv_z;
    if (n_probes < 0 || n_probes > kMaxProbes || n_lights <= 0 || n_lights > 65535 ||
        nv_x <= 0 || nv_y <= 0 || nv_z <= 0 || n_vox > (1LL << 30))
        return (int)cudaErrorInvalidValue;
    const LightRows L{(const int*)l_type,     (const float*)l_pos,    (const float*)l_emit,
                      (const bool*)l_twosided, (const float*)l_area,   (const float*)tri_p,
                      (const bool*)tri_rev,    (const int*)q_type,     (const float*)q_o2w,
                      (const float*)q_w2o,     (const float*)q_params, (const bool*)q_rev,
                      (const bool*)cone,       (const int*)row_inf,    (const float*)inf_flat,
                      (const int*)inf_desc,    (const float*)inf_l2w};
    const cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid(rt::blocks_for((int)n_vox, kThreads), n_lights);
    grid_contrib_kernel<true><<<grid, kThreads, 0, st>>>(
        lo_x, lo_y, lo_z, ext_x, ext_y, ext_z, nv_y, nv_z, (int)n_vox, (const float*)halton,
        n_probes, L.tri_p, L.tri_rev, L.twosided, L.emit, L.area, n_lights, L.type, L.q_type,
        (float*)out);
    cudaError_t err = cudaGetLastError();
    unsigned* next = nullptr;
    if (err == cudaSuccess) err = cudaGetSymbolAddress((void**)&next, g_next);
    if (err != cudaSuccess) return (int)err;
    // the queues are reset before each launch, in the stream's order (calls
    // on two streams at once would share them)
    return (int)each_set(LightSets{}, [&](auto m) {
        constexpr int kM = decltype(m)::value;
        int blocks = 0, queues = 0;
        cudaError_t e = lights_wave<kM>(&blocks, &queues);
        if (e == cudaSuccess) e = cudaMemsetAsync(next, 0, sizeof(unsigned) * queues, st);
        if (e != cudaSuccess) return e;
        blocks = (int)std::min<long long>(blocks, (long long)grid.x * grid.y);
        grid_contrib_lights_kernel<kM><<<blocks, kThreads, 0, st>>>(
            lo_x, lo_y, lo_z, ext_x, ext_y, ext_z, nv_y, nv_z, (int)n_vox,
            (const float*)halton, n_probes, L, n_lights, queues, next, (float*)out);
        return cudaGetLastError();
    });
}
