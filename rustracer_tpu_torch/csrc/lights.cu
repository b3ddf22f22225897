// K15 and K16: the infinite lights (scene/lights.py).
//
// K15 infinite_sample replaces the infinite branch of
// rustracer_tpu/scene/lights.py sample_li (:461-482), with
// core/sampling.py Distribution2D.sample_continuous (:190) and
// ops/mipmap.py bilerp_level (:83): for each lane whose light row is
// infinite light k, the marginal's and the row's find_interval (integers
// bit for bit with the plain version's count), uv, the direction through
// l2w and sin theta, pdf = map pdf / (2 pi^2 sin theta) (0 where sin theta
// <= 1e-7), Le = the map's bilinear value (REPEAT) times the light's scale,
// and the shadow target p + 2 world_radius wi; zeros on the other lanes.
//
// K16 infinite_escape replaces infinite_le (:391) and infinite_le_mis
// (:593-614) with Distribution2D.pdf (:201): for each escaped lane (mask),
// over the scene's infinite lights in order, uv through w2l (acos, atan2),
// the bilinear Le, and, after a bounce, the power-heuristic weight of the
// BSDF pdf against the light's pdf times its selection pmf (weight 1 after
// a specular bounce); 0 on the other lanes.
//
// One thread a lane. Bound: bytes (a lane's inputs and outputs; the maps
// and their cdfs, 32 x 64 for the sky, stay in L1 and L2).
//
// K16's design: one instantiation a form (infinite_escape_kernel<
// kMis>), so that the camera rays' holds no sin theta, no map pdf and no
// stack frame (the MIS form keeps sinf, the bits of its pdf); each light's
// sides, table offsets, marginal integral, scale and w2l are read once a
// block into shared memory (EscLight, 8 at a time), while the lanes load
// their masks (and the escaped ones their directions), so that no lane's
// chain waits on them; the REPEAT wrap is a compare (lights.cuh
// wrap_repeat). The same bits as the design before. Two or four lanes a
// thread (a step's lanes in one wave) and registers capped for one wave
// ran slower (PERF.md section 6).
//
// K15's design: one thread a lane as K16, its searches the bisections of
// lights.cuh; u and p are loaded with the descriptor, off the lane's chain
// of dependent loads, and sinf and cosf are lights.cuh's sincos_bounded
// (no stack frame). A sky lane's time is that chain (its light row, the
// descriptor, the two bisections, four texels) in a single wave whose L1
// starts cold. Copying the tables into each block's shared memory, a
// persistent grid staging them once a block, prefetching their lines into
// L1, two rounds of independent loads a search, two lanes a thread and
// fewer registers each took longer (PERF.md, PR 22).
#include "lights.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    infinite_sample_kernel(const int* __restrict__ lid, const float* __restrict__ p,
                           const float* __restrict__ u, int n, const int* __restrict__ row_inf,
                           int n_lights, const float* __restrict__ emit,
                           const float* __restrict__ flat, const int* __restrict__ desc,
                           const float* __restrict__ l2w, float world_radius,
                           float* __restrict__ wi_out, float* __restrict__ pdf_out,
                           float* __restrict__ li_out, float* __restrict__ pt_out) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const int row = lid[i];
    const int k = row >= 0 && row < n_lights ? row_inf[row] : -1;
    if (k < 0) {
        const rt::V3 z{0.0f, 0.0f, 0.0f};
        rt::store3(wi_out + 3 * i, z);
        rt::store3(li_out + 3 * i, z);
        rt::store3(pt_out + 3 * i, z);
        pdf_out[i] = 0.0f;
        return;
    }
    const float u0 = u[2 * i], u1 = u[2 * i + 1];
    const rt::V3 pi = rt::load3(p + 3 * i);
    const rt::InfLight L = rt::inf_light(flat, desc, k);
    float uv0, uv1, map_pdf, st;
    rt::sample_2d(L, u0, u1, &uv0, &uv1, &map_pdf);
    const rt::V3 wi = rt::inf_uv_to_dir(l2w + 16 * k, uv0, uv1, &st);
    const rt::V3 le = rt::bilerp_repeat(L.map, L.h, L.w, uv0, uv1);
    const rt::V3 e = rt::load3(emit + 3 * row);
    rt::store3(wi_out + 3 * i, wi);
    pdf_out[i] = rt::inf_pdf(map_pdf, st);
    rt::store3(li_out + 3 * i, rt::V3{le.x * e.x, le.y * e.y, le.z * e.z});
    rt::store3(pt_out + 3 * i, pi + wi * (2.0f * world_radius));
}

// the lights K16 stages in a block's shared memory at a time
constexpr int kStagedLights = 8;

// One infinite light as K16 reads it: its map's sides, the offsets of the
// map and of the conditional rows' func in the flat table, the marginal's
// integral (the MIS form's), its scale, and w2l's rows and columns 0-2.
struct EscLight {
    int h, w, map, cfunc;
    float mint;
    float s[3];
    float m[9];
};

__device__ __forceinline__ EscLight esc_light(const float* __restrict__ flat,
                                              const int* __restrict__ desc,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ w2l, int k, bool mis) {
    const int* d = desc + rt::kDescWords * k;
    EscLight L;
    L.h = d[0];
    L.w = d[1];
    L.map = d[2];
    L.cfunc = d[3];
    L.mint = mis ? flat[d[8]] : 0.0f;
    for (int c = 0; c < 3; ++c) L.s[c] = scale[3 * k + c];
    for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) L.m[3 * r + c] = w2l[16 * k + 4 * r + c];
    return L;
}

// a lane's escaped direction d under light L: its Le, or in the MIS form
// its Le weighted by the power heuristic, added to acc
template <bool kMis>
__device__ __forceinline__ void escape_one(const EscLight& L, rt::V3 d,
                                           const float* __restrict__ flat, float pmf, float pdf,
                                           bool spec, rt::V3* acc) {
    float uv0, uv1;
    const float theta = rt::inf_dir_to_uv(L.m, d, &uv0, &uv1);
    const rt::V3 v = rt::bilerp_repeat(flat + L.map, L.h, L.w, uv0, uv1);
    const rt::V3 le{v.x * L.s[0], v.y * L.s[1], v.z * L.s[2]};
    if (!kMis) {
        *acc = *acc + le;
        return;
    }
    const float map_pdf = rt::pdf_2d(flat + L.cfunc, L.mint, L.h, L.w, uv0, uv1);
    const float light_pdf = rt::inf_pdf(map_pdf, sinf(theta)) * pmf;
    const float w = spec ? 1.0f : rt::power_heuristic(pdf, light_pdf);
    *acc = *acc + w * le;
}

template <bool kMis>
__global__ void __launch_bounds__(kThreads)
    infinite_escape_kernel(const float* __restrict__ d_in, const bool* __restrict__ mask,
                           const float* __restrict__ prev_pdf,
                           const bool* __restrict__ prev_spec, const float* __restrict__ pmf,
                           float pmf_const, int n, int n_inf, const float* __restrict__ scale,
                           const float* __restrict__ flat, const int* __restrict__ desc,
                           const float* __restrict__ w2l, float* __restrict__ out) {
    __shared__ EscLight s_l[kStagedLights];
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    const bool in = i < n;
    // the lane's mask (and an escaped lane's direction) while the block
    // reads the lights
    const bool live = in && mask[i];
    const rt::V3 d = live ? rt::load3(d_in + 3 * i) : rt::V3{0.0f, 0.0f, 0.0f};
    const float pdf = kMis && live ? prev_pdf[i] : 0.0f;
    const bool spec = kMis && live && prev_spec[i];
    rt::V3 acc{0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < n_inf; k0 += kStagedLights) {
        const int cnt = min(n_inf - k0, kStagedLights);
        if (k0 > 0) __syncthreads();
        if (threadIdx.x < cnt)
            s_l[threadIdx.x] = esc_light(flat, desc, scale, w2l, k0 + threadIdx.x, kMis);
        __syncthreads();
        if (!live) continue;
        for (int k = 0; k < cnt; ++k) {
            const float pk =
                kMis ? (pmf ? pmf[(long long)(k0 + k) * n + i] : pmf_const) : 0.0f;
            escape_one<kMis>(s_l[k], d, flat, pk, pdf, spec, &acc);
        }
    }
    if (in) rt::store3(out + 3 * i, acc);
}

}  // namespace

// lid (n,) int32 light rows, p (n, 3), u (n, 2); row_inf (n_lights,) the
// infinite light of each row (-1 elsewhere), emit (n_lights, 3), the
// infinite lights' flat table and descriptors (K, 9) (scene/lights.py
// INF_DESC), l2w (K, 4, 4), world_radius -> wi, pdf, li, p_target
extern "C" int rt_infinite_sample(const void* lid, const void* p, const void* u, int n,
                                  const void* row_inf, int n_lights, const void* emit,
                                  const void* flat, const void* desc, const void* l2w,
                                  float world_radius, void* wi, void* pdf, void* li, void* pt,
                                  void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    infinite_sample_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)lid, (const float*)p, (const float*)u, n, (const int*)row_inf, n_lights,
        (const float*)emit, (const float*)flat, (const int*)desc, (const float*)l2w,
        world_radius, (float*)wi, (float*)pdf, (float*)li, (float*)pt);
    return (int)cudaGetLastError();
}

// d (n, 3) escaped directions, mask (n,) bool; with mis != 0 the BSDF pdf
// and specular flag of the bounce (n,) and the selection pmfs (n_inf, n),
// or null for one pmf_const for all; scale (n_inf, 3), the flat table,
// descriptors and w2l (n_inf, 4, 4) -> out (n, 3)
extern "C" int rt_infinite_escape(const void* d, const void* mask, const void* prev_pdf,
                                  const void* prev_spec, const void* pmf, float pmf_const,
                                  int mis, int n, int n_inf, const void* scale, const void* flat,
                                  const void* desc, const void* w2l, void* out, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (n_inf <= 0 || (mis && (!prev_pdf || !prev_spec))) return (int)cudaErrorInvalidValue;
    const auto kernel = mis ? infinite_escape_kernel<true> : infinite_escape_kernel<false>;
    kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)d, (const bool*)mask, (const float*)prev_pdf, (const bool*)prev_spec,
        (const float*)pmf, pmf_const, n, n_inf, (const float*)scale, (const float*)flat,
        (const int*)desc, (const float*)w2l, (float*)out);
    return (int)cudaGetLastError();
}
