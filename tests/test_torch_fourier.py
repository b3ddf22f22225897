"""Port parity of the Fourier BSDF (``rustracer_tpu_torch/ops/fourier.py``)
and its spline and series machinery (``core/interpolation.py``) against
the JAX package, on the CPU, on seeded numpy inputs handed to both.

Anchors are ``tests/test_fourier.py``'s: the Catmull-Rom weights on shared
and per-lane knots (offsets and validity bit for bit, weights within 1e-6),
the spline's host CDF (the same numpy code), its inversion, the cosine
series and its sampling, the 2D spline sampling with per-lane tables; the
.bsdf round trip and the stacking of tables of different sizes bit for
bit; and ``fourier_f``, ``fourier_pdf`` and ``fourier_sample_f`` on a set
of a Lambertian table, a multi-order 3-channel table with a transmission
lobe (eta 1.5) and a 1-channel table of 20 knots and orders up to 11.
Tolerances: f and pdf within 1e-5 relative of the largest magnitude
(f reaches about 11 near grazing, 1 / |muI|) with a 1e-6 floor; the
sampled direction, separately, within 1e-5 on every lane (the
bisection over the interpolated cdf picks the same column on these
inputs); the sampled f and pdf as f and pdf.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.core import interpolation as JI
from rustracer_tpu.ops import fourier as JF
from rustracer_tpu_torch.core import interpolation as PI
from rustracer_tpu_torch.ops import fourier as PF
from rustracer_tpu_torch.tools.texture_work import fourier_table

torch.set_num_threads(1)


def close(a, b, rtol=1e-5, atol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1.0)
    err = float(np.abs(a - b).max())
    assert err <= rtol * scale + atol, (err, scale)


def _knots(rs, n, lanes=None):
    shape = (n,) if lanes is None else (lanes, n)
    x = np.sort(rs.uniform(-1, 1, shape), -1)
    return np.cumsum(np.abs(np.diff(x, prepend=x[..., :1] - 0.1, axis=-1))
                     + 0.01, -1).astype(np.float32) - 1.0


@pytest.mark.parametrize("per_lane", [False, True])
def test_catmull_rom_weights(per_lane):
    rs = np.random.RandomState(1)
    n = 256
    nodes = _knots(rs, 12, n if per_lane else None)
    x = rs.uniform(-1.2, 2.0, n).astype(np.float32)
    jo, jw, jv = JI.catmull_rom_weights(jnp.asarray(nodes), jnp.asarray(x))
    po, pw, pv = PI.catmull_rom_weights(torch.from_numpy(nodes),
                                        torch.from_numpy(x))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    close(pw.numpy(), jw)


def test_spline_cdf_and_inversion():
    rs = np.random.RandomState(2)
    x = _knots(rs, 10)
    vals = rs.uniform(0.1, 1.0, (3, 10)).astype(np.float32)
    jc, jt = JI.integrate_catmull_rom_np(x, vals)
    pc, pt = PI.integrate_catmull_rom_np(x, vals)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pt, jt)
    u = rs.uniform(-0.1, 1.1 * jc[0, -1], 300).astype(np.float32)
    ref = JI.invert_catmull_rom(jnp.asarray(x), jnp.asarray(jc[0]),
                                jnp.asarray(u))
    out = PI.invert_catmull_rom(torch.from_numpy(x), torch.from_numpy(jc[0]),
                                torch.from_numpy(u))
    close(out.numpy(), ref)


def test_fourier_series_and_sampling():
    rs = np.random.RandomState(3)
    n, m = 300, 9
    ak = (rs.uniform(-0.3, 0.3, (n, m)) * 0.6 ** np.arange(m)).astype(
        np.float32)
    ak[:, 0] = rs.uniform(0.5, 1.0, n)
    ak[:7, :] = 0.0   # a zero series: pdf 0
    cos_phi = rs.uniform(-1.1, 1.1, n).astype(np.float32)
    close(PI.fourier(torch.from_numpy(ak), torch.from_numpy(cos_phi)),
          JI.fourier(jnp.asarray(ak), jnp.asarray(cos_phi)))
    u = rs.uniform(0, 1, n).astype(np.float32)
    u[:3] = [0.0, 0.5, 0.99999]
    ref = JI.sample_fourier(jnp.asarray(ak), jnp.asarray(u))
    out = PI.sample_fourier(torch.from_numpy(ak), torch.from_numpy(u))
    for a, b in zip(out, ref):
        close(a.numpy(), b)


def test_sample_catmull_rom_2d_per_lane_tables():
    """The reference takes each lane's (N1, N2) tables; the port the stack
    and each lane's row in it: the same samples."""
    rs = np.random.RandomState(4)
    t_n, n1, lanes = 3, 11, 400
    nodes = np.stack([_knots(rs, n1) for _ in range(t_n)])
    vals = rs.uniform(0.0, 1.0, (t_n, n1, n1)).astype(np.float32)
    vals[1, 4] = 0.0   # a row of zeros
    cdf = np.stack([JI.integrate_catmull_rom_np(nodes[t], vals[t])[0]
                    for t in range(t_n)])
    rows = rs.randint(0, t_n, lanes)
    alpha = rs.uniform(-1.1, 1.0, lanes).astype(np.float32)
    u = rs.uniform(0, 1, lanes).astype(np.float32)
    ref = JI.sample_catmull_rom_2d(
        jnp.asarray(nodes[rows]), jnp.asarray(nodes[rows]),
        jnp.asarray(vals[rows]), jnp.asarray(cdf[rows]), jnp.asarray(alpha),
        jnp.asarray(u))
    r = torch.from_numpy(rows)
    out = PI.sample_catmull_rom_2d(
        torch.from_numpy(nodes)[r], torch.from_numpy(nodes)[r],
        torch.from_numpy(vals), torch.from_numpy(cdf), torch.from_numpy(alpha),
        torch.from_numpy(u), rows=r)
    for a, b in zip(out, ref):
        close(a.numpy(), b)


def _tables():
    t1 = fourier_table(transmission=0.1, eta=1.5)
    t3 = fourier_table(n_mu=20, m_max=11, seed=9)
    t3["n_channels"] = 1
    return [JF.make_lambertian_table((0.6, 0.4, 0.2), n_mu=12), t1, t3]


def test_bsdf_file_round_trip_and_table_set(tmp_path):
    t = fourier_table(transmission=0.1, eta=1.5)
    path = str(tmp_path / "t.bsdf")
    PF.write_bsdf_table(path, t["mu"], t["a"], t["a_offset"], t["m"],
                        t["cdf"], eta=t["eta"], n_channels=3)
    back, ref = PF.read_bsdf_table(path), JF.read_bsdf_table(path)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(ref[k]))
    assert back["m_max"] == 8 and t["mu"].size == 16
    jts = JF.make_table_set(_tables())
    pts = PF.make_table_set(_tables())
    for k in PF.FourierTableSet._fields[:-1]:
        np.testing.assert_array_equal(getattr(pts, k),
                                      np.asarray(getattr(jts, k)))
    assert pts.m_pad == np.asarray(jts.k_pad).shape[-1] == 11


def _inputs(seed, n=3000):
    rs = np.random.RandomState(seed)

    def dirs():
        v = rs.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
            np.float32)
    return (rs.randint(0, 3, n).astype(np.int32), dirs(), dirs(),
            rs.uniform(size=(n, 2)).astype(np.float32))


@pytest.mark.parametrize("which", ["lambertian", "all"])
def test_fourier_bsdf_matches(which):
    tabs = _tables()
    jts = JF.make_table_set(tabs)
    pts = PF.make_table_set(tabs).to("cpu")
    tid, wo, wi, u = _inputs(7)
    if which == "lambertian":
        tid[:] = 0
    j = [jnp.asarray(x) for x in (tid, wo, wi, u)]
    p = [torch.from_numpy(x) for x in (tid, wo, wi, u)]
    close(PF.fourier_f(pts, p[0], p[1], p[2]).numpy(),
          JF.fourier_f(jts, j[0], j[1], j[2]))
    close(PF.fourier_pdf(pts, p[0], p[1], p[2]).numpy(),
          JF.fourier_pdf(jts, j[0], j[1], j[2]))
    pw, pf, pp = PF.fourier_sample_f(pts, p[0], p[1], p[3])
    jw, jf, jp = JF.fourier_sample_f(jts, j[0], j[1], j[3])
    err = np.abs(pw.numpy() - np.asarray(jw)).max()
    print(f"{which}: sampled direction max error {err:.3g}")
    assert err <= 1e-5
    close(pf.numpy(), jf)
    close(pp.numpy(), jp)
    # a mask gives zeros off it and the same values on it
    mask = torch.from_numpy(np.arange(tid.size) % 3 != 0)
    f_m = PF.fourier_f(pts, p[0], p[1], p[2], mask)
    assert bool((f_m[~mask] == 0).all())
    assert torch.equal(f_m[mask], PF.fourier_f(pts, p[0], p[1], p[2])[mask])


def test_fourier_bsdf_matches_wide_table():
    """The plain f, pdf and sample_f on a wide table (64 knots, orders up
    to 64: above K19's register path) against the JAX package, with
    test_fourier_bsdf_matches's tolerances."""
    tabs = [fourier_table(n_mu=64, m_max=64)]
    jts = JF.make_table_set(tabs)
    pts = PF.make_table_set(tabs).to("cpu")
    assert pts.m_pad == 64
    tid, wo, wi, u = _inputs(13)
    tid[:] = 0
    j = [jnp.asarray(x) for x in (tid, wo, wi, u)]
    p = [torch.from_numpy(x) for x in (tid, wo, wi, u)]
    close(PF.fourier_f(pts, p[0], p[1], p[2]).numpy(),
          JF.fourier_f(jts, j[0], j[1], j[2]))
    close(PF.fourier_pdf(pts, p[0], p[1], p[2]).numpy(),
          JF.fourier_pdf(jts, j[0], j[1], j[2]))
    pw, pf, pp = PF.fourier_sample_f(pts, p[0], p[1], p[3])
    jw, jf, jp = JF.fourier_sample_f(jts, j[0], j[1], j[3])
    err = np.abs(pw.numpy() - np.asarray(jw)).max()
    print(f"wide table: sampled direction max error {err:.3g}")
    assert err <= 1e-5
    close(pf.numpy(), jf)
    close(pp.numpy(), jp)


def test_chunked_series_keeps_the_plain_series_error():
    """tools/fourier_precision.py: K19's series (the float32 recurrence in
    float32 chunks of 32 orders added in double) lies within the plain
    series' own distance from the exact one, plus 2e-7 (a few ulps of
    the series), at 64 and 1000 orders."""
    from rustracer_tpu_torch.tools import fourier_precision as FP
    for name, ways in FP.report(2048).items():
        chunks = ways[f"float32 chunks of {FP.CHUNK} in double"]
        assert chunks <= ways["exact (float64)"] + 2e-7, (name, ways)


def test_plain_comparison_allows_only_direction_flips():
    """``tools/texture_work.py compare_with_plain``, which holds K19
    against its plain version on the card: a lane of sample_f may sample
    another direction, with the f of that direction and a finite pdf;
    f and pdf (and sample_f's f and pdf where the direction agrees) are
    held on every lane."""
    from rustracer_tpu_torch.tools.texture_work import compare_with_plain
    ts = PF.make_table_set(_tables()).to("cpu")
    tid, wo, wi, u = (torch.from_numpy(x) for x in _inputs(11, 20000))
    mask = torch.from_numpy(np.arange(tid.shape[0]) % 3 != 0)
    args = (ts, tid, wo, u, mask)
    out = PF.fourier_sample_f(*args)
    assert compare_with_plain("fourier_sample_f", args, out)["flipped"] == 0
    u2 = u.clone()
    u2[:3] = 1.0 - u2[:3]
    other = PF.fourier_sample_f(ts, tid, wo, u2, mask)
    flip = tuple(o.clone() for o in out)
    for o, x in zip(flip, other):
        o[1:3] = x[1:3]                       # lane 0 is masked off
    assert float((flip[0][1:3] - out[0][1:3]).abs().max()) > 1e-2
    assert compare_with_plain("fourier_sample_f", args, flip)["flipped"] == 2
    for j, lane in ((1, 1), (1, 4), (2, 4)):
        bad = tuple(o.clone() for o in flip)
        bad[j][lane] += 0.5
        with pytest.raises(AssertionError):
            compare_with_plain("fourier_sample_f", args, bad)
    for fname in ("fourier_f", "fourier_pdf"):
        a = (ts, tid, wo, wi, mask)
        out = getattr(PF, fname)(*a)
        assert compare_with_plain(fname, a, out)["flipped"] == 0
        bad = out.clone()
        bad[1] += 1e-3
        with pytest.raises(AssertionError):
            compare_with_plain(fname, a, bad)
