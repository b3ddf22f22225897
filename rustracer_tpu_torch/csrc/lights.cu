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
// and their cdfs, 32 x 64 for the sky, stay in L1 and L2). A lane's
// searches are bisections of the (H + 1) and (W + 1) cdf entries, about 12
// reads for the sky.
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
    const rt::InfLight L = rt::inf_light(flat, desc, k);
    float uv0, uv1, map_pdf, st;
    rt::sample_2d(L, u[2 * i], u[2 * i + 1], &uv0, &uv1, &map_pdf);
    const rt::V3 wi = rt::inf_uv_to_dir(l2w + 16 * k, uv0, uv1, &st);
    const rt::V3 le = rt::bilerp_repeat(L.map, L.h, L.w, uv0, uv1);
    const rt::V3 e = rt::load3(emit + 3 * row);
    rt::store3(wi_out + 3 * i, wi);
    pdf_out[i] = rt::inf_pdf(map_pdf, st);
    rt::store3(li_out + 3 * i, rt::V3{le.x * e.x, le.y * e.y, le.z * e.z});
    rt::store3(pt_out + 3 * i, rt::load3(p + 3 * i) + wi * (2.0f * world_radius));
}

__global__ void __launch_bounds__(kThreads)
    infinite_escape_kernel(const float* __restrict__ d_in, const bool* __restrict__ mask,
                           const float* __restrict__ prev_pdf,
                           const bool* __restrict__ prev_spec, const float* __restrict__ pmf,
                           float pmf_const, int mis, int n, int n_inf,
                           const float* __restrict__ scale, const float* __restrict__ flat,
                           const int* __restrict__ desc, const float* __restrict__ w2l,
                           float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    rt::V3 acc{0.0f, 0.0f, 0.0f};
    if (mask[i]) {
        const rt::V3 d = rt::load3(d_in + 3 * i);
        for (int k = 0; k < n_inf; ++k) {
            const rt::InfLight L = rt::inf_light(flat, desc, k);
            float uv0, uv1, st;
            rt::inf_dir_to_uv(w2l + 16 * k, d, &uv0, &uv1, &st);
            const rt::V3 v = rt::bilerp_repeat(L.map, L.h, L.w, uv0, uv1);
            const rt::V3 s = rt::load3(scale + 3 * k);
            const rt::V3 le{v.x * s.x, v.y * s.y, v.z * s.z};
            if (!mis) {
                acc = acc + le;
                continue;
            }
            const float light_pdf = rt::inf_pdf(rt::pdf_2d(L, uv0, uv1), st) *
                                    (pmf ? pmf[(long long)k * n + i] : pmf_const);
            const float w = prev_spec[i] ? 1.0f : rt::power_heuristic(prev_pdf[i], light_pdf);
            acc = acc + w * le;
        }
    }
    rt::store3(out + 3 * i, acc);
}

}  // namespace

// lid (n,) int32 light rows, p (n, 3), u (n, 2); row_inf (n_lights,) the
// infinite light of each row (-1 elsewhere), emit (n_lights, 3), the
// infinite lights' flat table and descriptors (K, 9) (scene/lights.py
// INF_DESC), l2w (K, 4, 4) -> wi, pdf, li, p_target
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
    infinite_escape_kernel<<<rt::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)d, (const bool*)mask, (const float*)prev_pdf, (const bool*)prev_spec,
        (const float*)pmf, pmf_const, mis, n, n_inf, (const float*)scale, (const float*)flat,
        (const int*)desc, (const float*)w2l, (float*)out);
    return (int)cudaGetLastError();
}
