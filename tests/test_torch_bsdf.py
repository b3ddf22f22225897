"""Port parity of the lobe engine against the JAX package, on the CPU: the
shading-space trigonometry, refract and the PBRT erf_inv; fr_dielectric
(both sides of the surface, total internal reflection), fr_conductor and
Schlick's approximation; every microfacet function for Beckmann and
Trowbridge-Reitz (isotropic and anisotropic alphas) with
distribution_sample_wh on seeded u; the Disney Fresnel (FR_DISNEY); each
non-specular lobe's f and pdf (Lambertian reflection and transmission,
Oren-Nayar, microfacet reflection and transmission, FresnelBlend and the
five Disney lobes); sample_lobe for every ported type, FresnelBlend's two
halves on u[0] below, at and above 0.5; and bsdf_f, bsdf_pdf and
bsdf_sample_f on seeded mixed stacks (M = 2, types drawn from the ported
set, some lobes inactive, wo on both sides, random shading frames) and on
Disney's stacks (M = 6, and M = 8 with ``thin``), where the index of the
sampled lobe is bit for bit the reference's. FOURIER lobes, beside each
of three other types, through the table set the stack carries: f and pdf
at given directions within 1e-5 of the largest magnitude (plus 1e-6),
and on the lanes that sample a FOURIER lobe the direction within 1e-5
and f and pdf as above.

Inputs are seeded numpy arrays handed to both packages. Tolerances:
floats within 1e-5 relative with a 1e-7 absolute floor, plus, on a lane
where the evaluation is ill-conditioned, 8 times the port's own float32
error there (its distance to the port's float64 evaluation of the same
inputs; the test prints how many values take that term). Sampled
directions: at least 90% of the lanes within 1e-5 relative and 1e-7, and
every lane within 5e-3 radians of the reference's. Heitz's slope inversion
subtracts two float32 numbers of up to about 1e4 where A clips at
+-0.9999, so an ulp of difference upstream (XLA's rsqrt) moves such a
lane's half vector by up to about 1e-3 radians (2e-3 once reflected), in
either package against a float64 evaluation; near grazing, where G1 is
small, most values of u[0] clip A. The f and pdf bsdf_sample_f returns are held to the
reference's bsdf_f and bsdf_pdf at the port's own sampled direction.
On the stacks with the new lobe types (every type drawn, and Disney's)
the conditioning term is 8 times the larger of the port's float32 error
and the reference's own (its distance to the JAX package's float64
evaluation of the same inputs): GTR1's D near a normal half vector divides
by 1 + (alpha^2 - 1) cos^2, which cancels to about alpha^2, so the one-ulp
difference of XLA's rsqrt and PyTorch's in cos^2 moves D by up to about
1e-4 relative there, and on such a lane the port can land nearer the
float64 value than the reference does. The index of the sampled lobe on
Disney's stacks is bit for bit.
Integer and bool outputs (refract's validity, the sampled flags,
``valid``, the chosen lobe's type) are bit-exact; FRESNEL_SPECULAR's
per-lane choice of reflection or refraction (``u[0] < F``) is counted apart
and must not flip on these inputs. XLA on the CPU flushes denormals to
zero; the tests run PyTorch's CPU ops with ``torch.set_flush_denormal(True)``
likewise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.core import math as JM
from rustracer_tpu.ops import bsdf as JB
from rustracer_tpu.ops import fresnel as JF
from rustracer_tpu.ops import microfacet as JMF
from rustracer_tpu_torch.core import math as PM
from rustracer_tpu_torch.ops import bsdf as PB
from rustracer_tpu_torch.ops import fresnel as PF
from rustracer_tpu_torch.ops import microfacet as PMF

torch.set_num_threads(1)

N = 4096
RTOL, ATOL = 1e-5, 1e-7
NONSPEC = (PB.LAMBERTIAN_REFL, PB.OREN_NAYAR, PB.MICROFACET_REFL,
           PB.MICROFACET_TRANS, PB.LAMBERTIAN_TRANS, PB.FRESNEL_BLEND,
           PB.DISNEY_DIFFUSE, PB.DISNEY_RETRO, PB.DISNEY_SHEEN,
           PB.DISNEY_CLEARCOAT, PB.DISNEY_FAKE_SS)
# the analytic lobe types: FOURIER reads a table set, its parity is in
# test_unported_type_refused_by_name's cases and tests/test_torch_fourier.py
PORTED = tuple(sorted(PB.PORTED_TYPES - {PB.FOURIER}))
# the types the first mixed stacks draw from (the glass and metal lobes)
FIRST = (PB.LAMBERTIAN_REFL, PB.OREN_NAYAR, PB.SPECULAR_REFL,
         PB.SPECULAR_TRANS, PB.FRESNEL_SPECULAR, PB.MICROFACET_REFL,
         PB.MICROFACET_TRANS)
# the lobe types whose params take more slots than the first ports' did
LAYERED = (PB.FRESNEL_BLEND,) + PB.DISNEY_TYPES
# Disney's rows (DisneyMaterial.lobe_rows), and with ``thin``
DISNEY_ROWS = (PB.DISNEY_DIFFUSE, PB.DISNEY_RETRO, PB.DISNEY_SHEEN,
               PB.MICROFACET_REFL, PB.DISNEY_CLEARCOAT, PB.MICROFACET_TRANS)
THIN_ROWS = DISNEY_ROWS + (PB.DISNEY_FAKE_SS, PB.LAMBERTIAN_TRANS)


# the port's float32 error on a lane, times this, is the allowance for an
# ill-conditioned lane
K_COND = 8


@pytest.fixture(autouse=True)
def flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def close(out, ref, msg="", out64=None, ref64=None):
    """out within RTOL |ref| + ATOL of ref, plus K_COND |out - out64| where
    the port's float64 result ``out64`` is given; with ``ref64``, the
    reference's own float64 result, K_COND times the larger of that and
    the reference's float32 error |ref - ref64|."""
    out, ref = _np(out), _np(ref)
    tol = RTOL * np.abs(ref) + ATOL
    if out64 is not None:
        extra = K_COND * np.abs(out - _np(out64))
        if ref64 is not None:
            extra = np.maximum(extra, K_COND * np.abs(ref - _np(ref64)))
        print(f"{msg}: {int((np.abs(out - ref) > tol).sum())} of "
              f"{out.size} values take the conditioning term")
        tol = tol + extra
    d = np.abs(out - ref)
    bad = ~((d <= tol) | (np.isnan(out) & np.isnan(ref)))
    assert not bad.any(), (f"{msg}: {int(bad.sum())} of {out.size} off, "
                           f"max {d[bad].max()}")


def close_dirs(out, ref, msg=""):
    """Unit directions: at least 90% of the lanes within RTOL and ATOL,
    every lane within 5e-3 radians. -> bool mask of the lanes within."""
    out, ref = _np(out), _np(ref)
    ok = (np.abs(out - ref) <= RTOL * np.abs(ref) + ATOL).all(-1)
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1)
                                 * np.linalg.norm(ref, axis=-1) + 1e-30)
    ang = np.arccos(np.clip(cos, -1.0, 1.0))
    print(f"{msg}: {int((~ok).sum())} of {len(ok)} lanes beyond the "
          f"tolerance, max angle {ang.max():.3g}")
    assert ok.mean() >= 0.9 and ang.max() <= 5e-3, (
        msg, int((~ok).sum()), ang.max())
    return ok


def in64(fn, *args):
    """fn on the float32 tensors ``args`` and on their float64 copies."""
    return fn(*args), fn(*[a.double() if a.is_floating_point() else a
                           for a in args])


def same(out, ref, msg=""):
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref), err_msg=msg)


def both(*arrays):
    """numpy arrays -> (jax arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def dirs(rs, n=N, upper=None):
    """Unit vectors, both hemispheres (upper True: z > 0)."""
    v = rs.normal(size=(n, 3))
    if upper is not None:
        v[:, 2] = np.abs(v[:, 2]) * (1 if upper else -1)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_shading_trig_refract_erf():
    rs = np.random.RandomState(0)
    w = dirs(rs)
    w[:16] = [0.0, 0.0, 1.0]           # sin theta 0: the phi fallbacks
    n = dirs(rs)
    eta = rs.uniform(0.4, 2.5, N).astype(np.float32)
    (jw, jn, je), (pw, pn, pe) = both(w, n, eta)
    for name in ("cos_theta", "cos2_theta", "abs_cos_theta", "sin2_theta",
                 "sin_theta", "tan_theta", "tan2_theta", "cos_phi",
                 "sin_phi", "cos2_phi", "sin2_phi"):
        close(getattr(PM, name)(pw), getattr(JM, name)(jw), name)
    same(PM.same_hemisphere(pw, pn), JM.same_hemisphere(jw, jn))
    close(PM.reflect(pw, pn), JM.reflect(jw, jn), "reflect")
    wt, ok = PM.refract(pw, pn, pe)
    jwt, jok = JM.refract(jw, jn, je)
    same(ok, jok)
    assert 0.05 < ok.float().mean() < 0.95    # TIR on some lanes
    close(wt[ok], np.asarray(jwt)[np.asarray(jok)], "refract")
    x = rs.uniform(-1.0, 1.0, N).astype(np.float32)
    x[:4] = [-1.0, 1.0, 0.0, 0.999999]
    close(PM.erf_inv(torch.from_numpy(x)), JM.erf_inv(jnp.asarray(x)),
          "erf_inv")
    y = rs.normal(size=N).astype(np.float32) * 2
    close(PM.erf(torch.from_numpy(y)), JM.erf(jnp.asarray(y)), "erf")


def test_fresnel():
    rs = np.random.RandomState(1)
    cos_i = rs.uniform(-1.0, 1.0, N).astype(np.float32)
    cos_i[:4] = [-1.0, 0.0, 1.0, -0.0]
    eta_t = rs.uniform(1.05, 2.5, N).astype(np.float32)
    (jc, je), (pc, pe) = both(cos_i, eta_t)
    ones = np.ones(N, np.float32)
    out = PF.fr_dielectric(pc, torch.ones(N), pe)
    close(out, JF.fr_dielectric(jc, jnp.asarray(ones), je), "dielectric")
    # leaving the medium past the critical angle: total internal reflection
    tir = (cos_i < 0) & (np.sqrt(1 - cos_i ** 2) * eta_t >= 1.0)
    assert tir.sum() > 100 and (out.numpy()[tir] == 1.0).all()
    eta = rs.uniform(0.1, 2.0, (N, 3)).astype(np.float32)
    k = rs.uniform(0.5, 5.0, (N, 3)).astype(np.float32)
    (jeta, jk), (peta, pk) = both(eta, k)
    close(PF.fr_conductor(pc, torch.ones(N, 3), peta, pk),
          JF.fr_conductor(jc, jnp.ones((N, 3)), jeta, jk), "conductor")
    r0 = rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    close(PF.schlick_fresnel(pc.abs()[:, None], torch.from_numpy(r0)),
          JF.schlick_fresnel(jnp.abs(jc)[:, None], jnp.asarray(r0)),
          "schlick")


def test_fresnel_disney():
    """_fresnel over every code, FR_DISNEY's metallic lerp included; with
    the static flag off (no Disney lobe in the scene) every other code is
    unchanged."""
    rs = np.random.RandomState(3)
    cos_i = rs.uniform(-1.0, 1.0, N).astype(np.float32)
    p = np.zeros((N, 16), np.float32)
    p[:, 3:6] = rs.uniform(0.1, 2.0, (N, 3))
    p[:, 6:9] = rs.uniform(0.02, 1.0, (N, 3))
    p[:, 9] = rs.uniform(1.2, 2.2, N)
    p[:, 14] = rs.uniform(0.0, 1.0, N)
    code = rs.randint(0, 4, N).astype(np.int32)
    (jc, jp, jcode), (pc, pp, pcode) = both(cos_i, p, code)
    ref = JB._fresnel(jcode, jc, jp)
    out, out64 = in64(lambda c, q: PB._fresnel(pcode, c, q, True), pc, pp)
    close(out, ref, "FR_DISNEY", out64)
    other = code != 3
    assert other.mean() < 0.8
    close(PB._fresnel(pcode, pc, pp)[other], np.asarray(ref)[other],
          "without the Disney flag")
    # the flag off leaves FR_DISNEY lanes at FR_NOOP's 1
    assert (PB._fresnel(pcode, pc, pp)[~other] == 1.0).all()


def _alphas(rs, aniso):
    ax = rs.uniform(0.02, 0.9, N).astype(np.float32)
    ay = rs.uniform(0.02, 0.9, N).astype(np.float32) if aniso else ax.copy()
    return ax, ay


@pytest.mark.parametrize("dist", [JMF.BECKMANN, JMF.TROWBRIDGE])
@pytest.mark.parametrize("aniso", [False, True])
def test_microfacet(dist, aniso):
    rs = np.random.RandomState(2 + dist * 2 + aniso)
    wo = dirs(rs)
    wh = dirs(rs)
    ax, ay = _alphas(rs, aniso)
    u = rs.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    d = np.full(N, dist, np.int32)
    (jwo, jwh, jax_, jay, ju, jd), (pwo, pwh, pax, pay, pu, pd) = both(
        wo, wh, ax, ay, u, d)
    close(PMF.distribution_d(pd, pwh, pax, pay),
          JMF.distribution_d(jd, jwh, jax_, jay), "D")
    close(PMF.distribution_lambda(pd, pwo, pax, pay),
          JMF.distribution_lambda(jd, jwo, jax_, jay), "Lambda")
    close(PMF.distribution_g1(pd, pwo, pax, pay),
          JMF.distribution_g1(jd, jwo, jax_, jay), "G1")
    close(PMF.distribution_g(pd, pwo, pwh, pax, pay),
          JMF.distribution_g(jd, jwo, jwh, jax_, jay), "G")
    close(PMF.distribution_pdf(pd, pwo, pwh, pax, pay),
          JMF.distribution_pdf(jd, jwo, jwh, jax_, jay), "pdf")
    sample = PMF.distribution_sample_wh(pd, pwo, pu, pax, pay)
    close_dirs(sample, JMF.distribution_sample_wh(jd, jwo, ju, jax_, jay),
               "sample_wh")
    # a sampled wh lies in wo's hemisphere
    assert (np.sign(sample.numpy()[:, 2]) == np.sign(wo[:, 2])).mean() > 0.99
    close_dirs(PMF._sample_tr_full(pu, pax, pay),
               JMF._sample_tr_full(ju, jax_, jay), "tr full")
    close_dirs(PMF._sample_beckmann_full(pu, pax, pay),
               JMF._sample_beckmann_full(ju, jax_, jay), "beckmann full")
    close_dirs(PMF._sample_gtr1(pu, pax), JMF._sample_gtr1(ju, jax_), "gtr1")
    rough = rs.uniform(0.0, 1.0, N).astype(np.float32)
    close(PMF.roughness_to_alpha(torch.from_numpy(rough)),
          JMF.roughness_to_alpha(jnp.asarray(rough)), "roughness_to_alpha")


def _params(rs, n, types):
    """Seeded (n, 16) params valid for each lane's lobe type."""
    p = np.zeros((n, 16), np.float32)
    p[:, 0:3] = rs.uniform(0.05, 1.0, (n, 3))
    p[:, 3:6] = rs.uniform(0.05, 1.0, (n, 3))
    p[:, 6:9] = rs.uniform(0.5, 4.0, (n, 3))
    p[:, 9] = rs.uniform(1.2, 2.2, n)
    p[:, 10] = rs.uniform(0.05, 0.6, n)
    p[:, 11] = np.where(rs.uniform(size=n) < 0.5, p[:, 10],
                        rs.uniform(0.05, 0.6, n))
    p[:, 12] = rs.randint(0, 2, n)
    p[:, 13] = rs.randint(0, 3, n)
    # Oren-Nayar's A and B from a sigma in (0, 40] degrees
    s2 = np.deg2rad(rs.uniform(1.0, 40.0, n)) ** 2
    on = types == PB.OREN_NAYAR
    p[on, 14] = 1.0 - s2[on] / (2.0 * (s2[on] + 0.33))
    p[on, 15] = 0.45 * s2[on] / (s2[on] + 0.09)
    # mirrors take no Fresnel, glass lobes the dielectric one
    p[types == PB.SPECULAR_REFL, 13] = rs.randint(
        0, 3, int((types == PB.SPECULAR_REFL).sum()))
    p[np.isin(types, [PB.MICROFACET_TRANS, PB.FRESNEL_SPECULAR]), 13] = 1
    if np.isin(types, LAYERED).any():
        # Disney's roughness (retro, fake SS) or metallic in slot 14, the
        # clearcoat's GTR1 alpha (the gloss remap's range) in slot 15, and
        # the Disney Fresnel on a third of the microfacet reflection lobes
        disney = np.isin(types, PB.DISNEY_TYPES)
        p[disney, 14] = rs.uniform(0.0, 1.0, int(disney.sum()))
        cc = types == PB.DISNEY_CLEARCOAT
        p[cc, 15] = rs.uniform(0.001, 0.1, int(cc.sum()))
        mr = (types == PB.MICROFACET_REFL) & (rs.uniform(size=n) < 1 / 3)
        p[mr, 13] = 3
        p[mr, 14] = rs.uniform(0.0, 1.0, int(mr.sum()))
    return p


@pytest.mark.parametrize("T", NONSPEC)
def test_f_and_pdf_one_type(T):
    rs = np.random.RandomState(10 + T)
    wo, wi = dirs(rs), dirs(rs)
    p = _params(rs, N, np.full(N, T))
    (jwo, jwi, jp), (pwo, pwi, pp) = both(wo, wi, p)
    f, f64 = in64(lambda *a: PB._f_one_type(T, *a), pp, pwo, pwi)
    pdf, pdf64 = in64(lambda *a: PB._pdf_one_type(T, *a), pp, pwo, pwi)
    close(f, JB._f_one_type(T, jp, jwo, jwi), "f", f64)
    close(pdf, JB._pdf_one_type(T, jp, jwo, jwi), "pdf", pdf64)
    nonzero = (f.sum(-1) > 0).float().mean()
    assert 0.1 < nonzero < 0.9, nonzero     # both sides of the surface


@pytest.mark.parametrize("u0", ["below", "at", "above"])
def test_sample_fresnel_blend_halves(u0):
    """FresnelBlend's u[0] picks the cosine half below 0.5 and the
    microfacet half from 0.5 on, each on u[0] stretched back to [0,
    0.9999]; the diffuse half lands on wo's side of the surface."""
    rs = np.random.RandomState(60)
    wo = dirs(rs)
    u = rs.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    u[:, 0] = {"below": rs.uniform(0.0, 0.5, N), "at": 0.5,
               "above": rs.uniform(0.5, 1.0, N)}[u0]
    u[:8, 0] = {"below": [0.0, 0.25, 0.4999, 0.49999997, 1e-8, 0.1, 0.3,
                          0.45],
                "at": 0.5, "above": [0.5, 0.50000006, 0.75, 0.99999,
                                     0.999999, 0.6, 0.9, 0.99995]}[u0]
    p = _params(rs, N, np.full(N, PB.FRESNEL_BLEND))
    lt = np.full(N, PB.FRESNEL_BLEND, np.int32)
    (jlt, jp, jwo, ju), (plt, pp, pwo, pu) = both(lt, p, wo, u)
    wi = PB.sample_lobe(plt, pp, pwo, pu, PORTED)[0]
    jwi = JB.sample_lobe(jlt, jp, jwo, ju, PORTED)[0]
    close_dirs(wi, jwi, f"FRESNEL_BLEND u[0] {u0} 0.5")
    if u0 == "below":
        assert (wi.numpy()[:, 2] * wo[:, 2] >= 0).all()
    # the two halves sample different directions from the same u[1]
    other = u.copy()
    other[:, 0] = np.where(u[:, 0] < 0.5, u[:, 0] + 0.5, u[:, 0] - 0.5)
    wi2 = PB.sample_lobe(plt, pp, pwo, torch.from_numpy(other), PORTED)[0]
    assert (np.abs(wi2.numpy() - wi.numpy()).max(-1) > 1e-3).mean() > 0.5


@pytest.mark.parametrize("T", PORTED)
def test_sample_lobe(T):
    rs = np.random.RandomState(20 + T)
    wo = dirs(rs)
    u = rs.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    p = _params(rs, N, np.full(N, T))
    lt = np.full(N, T, np.int32)
    (jlt, jp, jwo, ju), (plt, pp, pwo, pu) = both(lt, p, wo, u)
    (wi, f, pdf, spec), (_, f64, pdf64, _) = in64(
        lambda *a: PB.sample_lobe(*a, PORTED), plt, pp, pwo, pu)
    jwi, jf, jpdf, jspec = JB.sample_lobe(jlt, jp, jwo, ju, PORTED)
    same(spec, jspec)
    if T == PB.FRESNEL_SPECULAR:
        # the pick: reflection keeps wo's side of the surface
        refl = wi.numpy()[:, 2] * wo[:, 2] > 0
        flips = int((refl != (np.asarray(jwi)[:, 2] * wo[:, 2] > 0)).sum())
        print(f"FRESNEL_SPECULAR: {flips} of {N} lanes flip the pick")
        assert flips == 0 and 0.02 < refl.mean() < 0.98
    close_dirs(wi, jwi, "wi")
    close(f, jf, "specular f", f64)
    close(pdf, jpdf, "specular pdf", pdf64)


class Frame:
    """A seeded shading frame per lane; the geometric normal tilted off
    the shading normal."""

    def __init__(self, rs, n, lib):
        ns = dirs(rs, n)
        a = np.cross(ns, dirs(rs, n))
        ss = a / np.linalg.norm(a, axis=1, keepdims=True)
        ts = np.cross(ns, ss)
        g = ns + 0.2 * dirs(rs, n)
        g /= np.linalg.norm(g, axis=1, keepdims=True)
        conv = jnp.asarray if lib == "jax" else torch.from_numpy
        for k, v in dict(ss=ss, ts=ts, ns=ns, n=g).items():
            setattr(self, k, conv(np.ascontiguousarray(v, np.float32)))


def _stack(seed, n=N, drawn=FIRST):
    """Mixed M = 2 stacks: the types drawn from ``drawn``, a fifth of the
    lobes inactive, wo on both sides of each frame."""
    rs = np.random.RandomState(seed)
    types = rs.choice(drawn, (n, 2)).astype(np.int32)
    params = np.stack([_params(rs, n, types[:, j]) for j in range(2)], 1)
    active = rs.uniform(size=(n, 2)) > 0.2
    eta = params[:, 0, 9].copy()
    wo, wi = dirs(rs, n), dirs(rs, n)
    u_lobe = rs.uniform(0.0, 1.0, n).astype(np.float32)
    u2 = rs.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    st = np.random.RandomState(seed + 1000)
    jf, pf = Frame(st, n, "jax"), Frame(np.random.RandomState(seed + 1000),
                                       n, "torch")
    (jt, jp, ja, je, jwo, jwi, jul, ju2), (pt, pp, pa, pe, pwo, pwi, pul,
                                           pu2) = both(
        types, params, active, eta, wo, wi, u_lobe, u2)
    return (JB.LobeStack(type=jt, params=jp, active=ja, eta=je), jf, jwo,
            jwi, jul, ju2), (PB.LobeStack(type=pt, params=pp, active=pa,
                                          eta=pe), pf, pwo, pwi, pul, pu2)


def _double(lobes, frame, *vectors):
    """The port's stack, frame and vectors in float64."""
    f64 = Frame.__new__(Frame)
    for k in ("ss", "ts", "ns", "n"):
        setattr(f64, k, getattr(frame, k).double())
    return (lobes._replace(params=lobes.params.double(),
                           eta=lobes.eta.double()), f64,
            *[v.double() for v in vectors])


def _jax64(fn, lobes, frame, *vectors):
    """``fn`` of the JAX package on float64 copies of its stack, frame and
    vectors (its own float64 evaluation)."""
    with jax.enable_x64(True):
        def d(x):
            return jnp.asarray(np.asarray(x, np.float64))
        f = Frame.__new__(Frame)
        for k in ("ss", "ts", "ns", "n"):
            setattr(f, k, d(getattr(frame, k)))
        return np.asarray(fn(lobes._replace(params=d(lobes.params),
                                            eta=d(lobes.eta)), f,
                             *[d(v) for v in vectors]))


@pytest.mark.parametrize("seed", [0, 1])
def test_bsdf_f_pdf_mixed_stacks(seed):
    (jl, jf, jwo, jwi, _, _), (pl, pf, pwo, pwi, _, _) = _stack(30 + seed)
    pl64, pf64, pwo64, pwi64 = _double(pl, pf, pwo, pwi)
    for flags in (PB.ALL, PB.ALL & ~PB.SPECULAR, PB.REFLECTION | PB.GLOSSY):
        f = PB.bsdf_f(pl, pf, pwo, pwi, PORTED, flags)
        close(f, JB.bsdf_f(jl, jf, jwo, jwi, PORTED, flags), f"f {flags}",
              PB.bsdf_f(pl64, pf64, pwo64, pwi64, PORTED, flags))
        close(PB.bsdf_pdf(pl, pf, pwo, pwi, PORTED, flags),
              JB.bsdf_pdf(jl, jf, jwo, jwi, PORTED, flags), f"pdf {flags}",
              PB.bsdf_pdf(pl64, pf64, pwo64, pwi64, PORTED, flags))
        same(PB.num_matching(pl, flags), JB.num_matching(jl, flags))
    assert 0.05 < (f.sum(-1) > 0).float().mean() < 0.9


def check_sample_f(jax_stack, port_stack, ref64=False):
    """bsdf_sample_f of both packages on one stack -> (the port's
    sampled flags, valid); ``ref64``: close's term for the reference's
    own float32 error."""
    (jl, jf, jwo, _, jul, ju2), (pl, pf, pwo, _, pul, pu2) = \
        jax_stack, port_stack
    wi, f, pdf, flags, valid = PB.bsdf_sample_f(pl, pf, pwo, pul, pu2,
                                                PORTED)
    jwi, jff, jpdf, jflags, jvalid = JB.bsdf_sample_f(jl, jf, jwo, jul, ju2,
                                                      PORTED)
    same(flags, jflags)
    same(valid, jvalid)
    v = valid.numpy()
    close_dirs(wi[v], np.asarray(jwi)[v], "wi")
    # f and pdf: the specular lobes' own, the others' the reference's
    # bsdf_f and bsdf_pdf at the port's sampled direction
    spec = (flags.numpy() & PB.SPECULAR) != 0
    jwi_p = jnp.asarray(wi.numpy())
    ref_f = np.where((spec | ~v)[:, None], np.asarray(jff), np.asarray(
        JB.bsdf_f(jl, jf, jwo, jwi_p, PORTED)))
    ref_pdf = np.where(spec | ~v, np.asarray(jpdf), np.asarray(
        JB.bsdf_pdf(jl, jf, jwo, jwi_p, PORTED)))
    l64, f64_, wo64, wi64 = _double(pl, pf, pwo, wi)
    out64_f = torch.where(torch.from_numpy(spec | ~v)[:, None],
                          f.double(), PB.bsdf_f(l64, f64_, wo64, wi64, PORTED))
    out64_pdf = torch.where(torch.from_numpy(spec | ~v), pdf.double(),
                            PB.bsdf_pdf(l64, f64_, wo64, wi64, PORTED))
    ref64_f = ref64_pdf = None
    if ref64:
        keep = spec | ~v
        ref64_f = np.where(keep[:, None], ref_f, _jax64(
            lambda *a: JB.bsdf_f(*a, PORTED), jl, jf, jwo, wi))
        ref64_pdf = np.where(keep, ref_pdf, _jax64(
            lambda *a: JB.bsdf_pdf(*a, PORTED), jl, jf, jwo, wi))
    close(f, ref_f, "f", out64_f, ref64_f)
    close(pdf, ref_pdf, "pdf", out64_pdf, ref64_pdf)
    return flags, v


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bsdf_sample_f_mixed_stacks(seed):
    flags, v = check_sample_f(*_stack(40 + seed))
    assert 0.3 < v.mean() < 0.95
    # every type drawn is chosen on some valid lane
    chosen = set((flags.numpy()[v]).tolist())
    assert {int(PB.LOBE_FLAGS[T]) for T in FIRST} <= chosen


def check_f_pdf(jax_stack, port_stack, flag_sets):
    """bsdf_f and bsdf_pdf of both packages on one stack for each of
    ``flag_sets``, with close's term for the reference's own float32
    error. -> the port's last f."""
    (jl, jf, jwo, jwi, _, _), (pl, pf, pwo, pwi, _, _) = \
        jax_stack, port_stack
    pl64, pf64, pwo64, pwi64 = _double(pl, pf, pwo, pwi)
    for flags in flag_sets:
        f = PB.bsdf_f(pl, pf, pwo, pwi, PORTED, flags)
        close(f, JB.bsdf_f(jl, jf, jwo, jwi, PORTED, flags), f"f {flags}",
              PB.bsdf_f(pl64, pf64, pwo64, pwi64, PORTED, flags),
              _jax64(lambda *a: JB.bsdf_f(*a, PORTED, flags), jl, jf, jwo,
                     jwi))
        close(PB.bsdf_pdf(pl, pf, pwo, pwi, PORTED, flags),
              JB.bsdf_pdf(jl, jf, jwo, jwi, PORTED, flags), f"pdf {flags}",
              PB.bsdf_pdf(pl64, pf64, pwo64, pwi64, PORTED, flags),
              _jax64(lambda *a: JB.bsdf_pdf(*a, PORTED, flags), jl, jf, jwo,
                     jwi))
    return f


FLAG_SETS = (PB.ALL, PB.ALL & ~PB.SPECULAR, PB.REFLECTION | PB.GLOSSY)


@pytest.mark.parametrize("seed", [0, 1])
def test_bsdf_mixed_stacks_of_every_type(seed):
    """bsdf_f, bsdf_pdf and bsdf_sample_f on M = 2 stacks drawn from every
    ported type (FresnelBlend, the Disney lobes and Lambertian
    transmission among them)."""
    f = check_f_pdf(*_stack(80 + seed, drawn=PORTED), FLAG_SETS)
    assert 0.05 < (f.sum(-1) > 0).float().mean() < 0.9
    flags, v = check_sample_f(*_stack(90 + seed, drawn=PORTED),
                              ref64=True)
    assert 0.3 < v.mean() < 0.95
    chosen = set((flags.numpy()[v]).tolist())
    assert {int(PB.LOBE_FLAGS[T]) for T in PORTED} <= chosen


def _disney_stack(seed, rows, n=N):
    """Seeded stacks with Disney's rows in its order: its microfacet
    reflection lobe always active and on the Disney Fresnel, the others
    active on four lanes in five; wo on both sides of each frame."""
    rs = np.random.RandomState(seed)
    M = len(rows)
    types = np.tile(np.asarray(rows, np.int32), (n, 1))
    params = np.stack([_params(rs, n, types[:, j]) for j in range(M)], 1)
    mr = rows.index(PB.MICROFACET_REFL)
    params[:, mr, 13] = 3
    params[:, mr, 14] = rs.uniform(0.0, 1.0, n)          # metallic
    params[:, mr, 6:9] = rs.uniform(0.02, 1.0, (n, 3))   # cspec0
    params[:, :, 12] = 1                       # Trowbridge-Reitz
    active = rs.uniform(size=(n, M)) > 0.2
    active[:, mr] = True
    eta = params[:, mr, 9].copy()
    wo = dirs(rs, n)
    u_lobe = rs.uniform(0.0, 1.0, n).astype(np.float32)
    u2 = rs.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    jf = Frame(np.random.RandomState(seed + 1000), n, "jax")
    pf = Frame(np.random.RandomState(seed + 1000), n, "torch")
    (jt, jp, ja, je, jwo, jwi, jul, ju2), (pt, pp, pa, pe, pwo, pwi, pul,
                                           pu2) = both(
        types, params, active, eta, wo, dirs(rs, n), u_lobe, u2)
    return (JB.LobeStack(type=jt, params=jp, active=ja, eta=je), jf, jwo,
            jwi, jul, ju2), (PB.LobeStack(type=pt, params=pp, active=pa,
                                          eta=pe), pf, pwo, pwi, pul, pu2)


@pytest.mark.parametrize("thin", [False, True])
def test_bsdf_disney_stacks(thin):
    """bsdf_f and bsdf_pdf for three flag sets, bsdf_sample_f, and the
    index of the lobe it samples, bit for bit: the port's running count
    against the reference's cumsum rank, at M = 6 and 8."""
    rows = THIN_ROWS if thin else DISNEY_ROWS
    jax_stack, port_stack = _disney_stack(70 + thin, rows)
    (jl, jf, jwo, jwi, jul, _), (pl, pf, pwo, pwi, pul, _) = \
        jax_stack, port_stack
    check_f_pdf(jax_stack, port_stack, FLAG_SETS)
    for flags in FLAG_SETS:
        m, n, k = PB.lobe_pick(pl, pul, flags)
        index = torch.arange(len(rows), dtype=torch.int32).expand(
            pl.type.shape)
        idx, _ = PB.choose_lobe(pl._replace(type=index), m, k)
        jm = jl.active & JB._matches(jl.type, flags)
        jn = jnp.sum(jm.astype(jnp.int32), -1)
        jk = jnp.minimum((jul * jn.astype(jnp.float32)).astype(jnp.int32),
                         jnp.maximum(jn - 1, 0))
        rank = jnp.cumsum(jm.astype(jnp.int32), -1) - 1
        jidx = jnp.argmax(jm & (rank == jk[:, None]), -1)
        same(n, jn)
        same(idx, jidx.astype(jnp.int32), f"sampled lobe, flags {flags}")
        # every row is the sampled one on some lane
        assert set(idx.numpy()[n.numpy() > 0].tolist()) == set(
            range(len(rows))) or flags != PB.ALL
    sampled, v = check_sample_f(jax_stack, port_stack, ref64=True)
    assert v.mean() > 0.9
    assert len(set(sampled.numpy()[v].tolist())) == (4 if thin else 3)


def test_choose_lobe_is_the_kth_match():
    """The running count picks what the reference's cumsum rank picks,
    M = 3, with lanes whose k has no match (lobe 0)."""
    rs = np.random.RandomState(7)
    n = 512
    m = rs.uniform(size=(n, 3)) < 0.5
    k = rs.randint(0, 3, n).astype(np.int32)
    lobes = PB.LobeStack(type=torch.from_numpy(rs.randint(0, 8, (n, 3))
                                               .astype(np.int32)),
                         params=torch.from_numpy(rs.uniform(
                             size=(n, 3, 16)).astype(np.float32)),
                         active=torch.from_numpy(m), eta=torch.ones(n))
    ct, cp = PB.choose_lobe(lobes, torch.from_numpy(m), torch.from_numpy(k))
    rank = np.cumsum(m, -1) - 1
    idx = np.argmax(m & (rank == k[:, None]), -1)
    same(ct, lobes.type.numpy()[np.arange(n), idx])
    same(cp, lobes.params.numpy()[np.arange(n), idx])


def _fourier_stack(T, n=2048):
    """Mixed M = 2 stacks of ``T`` and FOURIER lobes (table ids 0-2 in slot
    15) with the table sets of tests/test_torch_fourier.py's three
    tables."""
    from rustracer_tpu.ops import fourier as JFO
    from rustracer_tpu_torch.ops import fourier as PFO
    from test_torch_fourier import _tables
    (jl, jf, jwo, jwi, jul, ju2), (pl, pf, pwo, pwi, pul, pu2) = _stack(
        50, n=n, drawn=(T, PB.FOURIER))
    tid = np.random.RandomState(51).randint(0, 3, (n, 2))
    params = np.array(pl.params)
    params[..., 15] = np.where(np.array(pl.type) == PB.FOURIER, tid,
                               params[..., 15])
    jl = jl._replace(params=jnp.asarray(params),
                     fourier=JFO.make_table_set(_tables()))
    pl = pl._replace(params=torch.from_numpy(params),
                     fourier=PFO.make_table_set(_tables()).to("cpu"))
    return (jl, jf, jwo, jwi, jul, ju2), (pl, pf, pwo, pwi, pul, pu2)


def _near(a, b, label):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = float(np.abs(a - b).max())
    scale = float(np.abs(b).max())
    print(f"{label}: max error {err:.3g} of {scale:.3g}")
    assert err <= 1e-5 * scale + 1e-6, label


@pytest.mark.parametrize("T", [PB.LAMBERTIAN_TRANS, PB.FRESNEL_BLEND,
                               PB.DISNEY_DIFFUSE, PB.FOURIER])
def test_unported_type_refused_by_name(T):
    """FOURIER lobes beside another type (alone too), through the stack's
    table set: bsdf_f and bsdf_pdf, and bsdf_sample_f on the lanes that
    sample a FOURIER lobe, match the reference; without a table set a
    FOURIER lobe raises (the reference would leave it black)."""
    (jl, jf, jwo, jwi, jul, ju2), (pl, pf, pwo, pwi, pul, pu2) = \
        _fourier_stack(T)
    types = tuple(sorted({T, PB.FOURIER}))
    _near(PB.bsdf_f(pl, pf, pwo, pwi, types),
          JB.bsdf_f(jl, jf, jwo, jwi, types), "f")
    _near(PB.bsdf_pdf(pl, pf, pwo, pwi, types),
          JB.bsdf_pdf(jl, jf, jwo, jwi, types), "pdf")
    wi, f, pdf, flags, valid = PB.bsdf_sample_f(pl, pf, pwo, pul, pu2, types)
    jw, jff, jpdf, jflags, jvalid = JB.bsdf_sample_f(jl, jf, jwo, jul, ju2,
                                                     types)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
    four = flags.numpy() == PB.LOBE_FLAGS[PB.FOURIER]
    assert four.sum() > 100
    _near(wi.numpy()[four], np.asarray(jw)[four], "sampled wi")
    _near(f.numpy()[four], np.asarray(jff)[four], "sampled f")
    _near(pdf.numpy()[four], np.asarray(jpdf)[four], "sampled pdf")
    with pytest.raises(ValueError, match="table set"):
        PB.bsdf_f(pl._replace(fourier=None), pf, pwo, pwi, types)


def test_check_types_refuses_only_fourier():
    """Every lobe type of the reference is ported, FOURIER included; only a
    code that is no lobe type raises."""
    assert PB.PORTED_TYPES == set(range(PB.N_LOBE_TYPES))
    PB.check_types(tuple(sorted(PB.PORTED_TYPES)))
    with pytest.raises(NotImplementedError, match="not a lobe type"):
        PB.check_types((PB.N_LOBE_TYPES,))
