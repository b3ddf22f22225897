"""Port parity of the lights (``rustracer_tpu_torch.scene.lights``, the plain
versions of K15 and K16, ``core/sampling.py``'s distributions,
``ops/mipmap.py: bilerp_level``) against the JAX package, on the CPU.

The scene (``SCENE``, tools/light_work.py's ``MIXED_SCENE`` with the sky's
path made absolute, parsed by both packages) holds every light type: a
point light, a distant light under a rotation, a triangle light (two
triangles), a full sphere (sampled by its cone from outside), a clipped,
rotated two-sided sphere, a disk with an inner radius and a clipped
cylinder as area lights, and two infinite lights (the sky EXR under a
rotation, and the 4 x 8 map of ones). The port's tables are carried from
the JAX package's (``convert.lights_from_jax``) so that both sample the
same cdfs.

Tolerances: ``find_interval`` and every offset bit for bit; the
distributions' host build within n 2^-24 relative for rows of n entries
(the port's cdf is a sequential float32 cumsum, XLA's sums in another
order: two sums of n non-negative terms), their samples and pdfs on JAX's
tables within 1e-6; ``sample_li``'s directions, points and radiance within
1e-5 relative (sin, cos, acos, atan2 and rsqrt round apart by an ulp), on
the cone's lanes plus 2.4e-7 / (1 - cos theta_max) (that difference
cancels), its pdf as well plus 4e-7 / |cos| at the light (an ulp of the
cosine moves dist^2 / (|cos| A) by that much at grazing angles); the
escape radiance within 1e-5 relative plus 1e-5 / sin theta (acos near a
pole, ``_pole_slack``), after a bounce on the lanes whose direction's
texel of the map pdf is the same in both packages (the pdf is piecewise
constant: an ulp of acos or atan2 at a texel edge picks the neighbour;
they are counted, at most 0.5%); NEE toward every row within 1e-5
relative on at least 99.8% of the lanes (a shadow ray grazing an
occluder may land apart); the mixed-light render within 2e-5 mean
relative error and 2e-3 at the 99th percentile (the golden tolerance of
tests/test_golden.py is 100 times looser). The render, 32 x 24 at 2 spp
through both packages, takes about 20 s on one CPU thread (mostly the JAX
compile), NEE toward every row about 20 s, the whole file about 80 s."""
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.core import math as JM
from rustracer_tpu.core import sampling as JS
from rustracer_tpu.ops import mipmap as JMM
from rustracer_tpu.scene import lights as JL
from rustracer_tpu.scene.api import parse_scene_string as jax_parse_string
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.core import math as M
from rustracer_tpu_torch.core import sampling as S
from rustracer_tpu_torch.integrators.common import estimate_direct_light_side
from rustracer_tpu_torch.ops import mipmap as MM
from rustracer_tpu_torch.scene import lights as L
from rustracer_tpu_torch.scene.api import parse_scene_string
from rustracer_tpu_torch.tools import light_work as LW

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKY = os.path.join(REPO, "scenes", "textures", "sky.exr")
SCENE = LW.MIXED_SCENE.replace('"textures/sky.exr"', f'"{SKY}"')
# the rows of SCENE's light table (tools/light_work.py MIXED_ROWS)
ROWS = dict(LW.MIXED_ROWS, **{"every type": list(range(10))})
N = 4096


@pytest.fixture(scope="module")
def scenes():
    """(JAX bundle, port bundle, the port's tables carried from JAX's)."""
    jb = jax_parse_string(SCENE).scene
    pb = parse_scene_string(SCENE, device="cpu").scene
    return jb, pb, convert.lights_from_jax(jb.lights, geom=jb.geom,
                                           device="cpu")


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


# ---------------------------------------------------------------------------
# find_interval and the distributions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "uniform", "two"])
def test_find_interval_bit_equal(case):
    rng = np.random.default_rng(7)
    if case == "random":
        cdf = np.sort(rng.random((33,))).astype(np.float32)
    elif case == "ties":
        cdf = np.repeat(np.sort(rng.random(9)), 4).astype(np.float32)
    elif case == "uniform":
        cdf = (np.arange(65) / 64).astype(np.float32)
    else:
        cdf = np.array([0.0, 1.0], np.float32)
    x = np.concatenate([rng.random(2000), cdf, [-0.5, 0.0, 1.0, 1.5],
                        np.nextafter(cdf, 2)]).astype(np.float32)
    got = M.find_interval(_t(cdf), _t(x)).numpy()
    ref = np.asarray(JM.find_interval(jnp.asarray(cdf), jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)
    # per-lane rows, as Distribution2D's conditional search takes them
    rows = np.sort(rng.random((x.shape[0], 17)), -1).astype(np.float32)
    got = M.find_interval(_t(rows), _t(x)).numpy()
    ref = np.asarray(JM.find_interval(jnp.asarray(rows), jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)


def _funcs():
    rng = np.random.default_rng(11)
    f = rng.random(40).astype(np.float32)
    f[5:9] = 0.0
    return {"random": f, "zero": np.zeros(7, np.float32),
            "one bin": np.array([2.5], np.float32),
            "spike": np.eye(1, 16, 3, dtype=np.float32)[0]}


@pytest.mark.parametrize("name", ["random", "zero", "one bin", "spike"])
def test_distribution1d(name):
    """TestDistribution1D of tests/test_sampling.py on the port: create
    (the all-zero function: the uniform cdf and func_int 0), then the
    samples and pdfs on the JAX package's own tables."""
    f = _funcs()[name]
    jd = JS.Distribution1D.create(jnp.asarray(f))
    pd = S.Distribution1D.create(f)
    np.testing.assert_array_equal(pd.func.numpy(), np.asarray(jd.func))
    tol = f.shape[0] * 2.0 ** -24
    np.testing.assert_allclose(pd.cdf.numpy(), np.asarray(jd.cdf), rtol=tol,
                               atol=1e-7)
    np.testing.assert_allclose(pd.func_int.numpy(), np.asarray(jd.func_int),
                               rtol=tol)
    if name == "zero":
        assert float(pd.func_int) == 0.0
        np.testing.assert_array_equal(
            pd.cdf.numpy(), np.arange(8, dtype=np.float32) / np.float32(7))
    cd = S.Distribution1D(_t(jd.func), _t(jd.cdf), _t(jd.func_int))
    u = np.random.default_rng(2).random(3000).astype(np.float32)
    u = np.concatenate([u, np.asarray(jd.cdf)[:-1]]).astype(np.float32)
    x, pdf, off = cd.sample_continuous(_t(u))
    jx, jpdf, joff = jd.sample_continuous(jnp.asarray(u))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-6)
    off, pmf, u_rm = cd.sample_discrete(_t(u))
    joff, jpmf, ju = jd.sample_discrete(jnp.asarray(u))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    np.testing.assert_allclose(pmf.numpy(), np.asarray(jpmf), rtol=1e-6)
    np.testing.assert_allclose(u_rm.numpy(), np.asarray(ju), rtol=1e-6,
                               atol=1e-7)
    idx = np.arange(f.shape[0])
    np.testing.assert_allclose(cd.discrete_pdf(_t(idx)).numpy(),
                               np.asarray(jd.discrete_pdf(jnp.asarray(idx))),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["sky", "zero rows", "constant"])
def test_distribution2d(name):
    """Distribution2D of the sky's importance image (luminance x sin
    theta), of one with all-zero rows and of a constant map: the port's
    host build within 1e-6 of JAX's, then samples (the row and column
    offsets, floor(uv * (W, H)), bit for bit) and pdfs on JAX's tables."""
    from rustracer_tpu_torch.render.imageio import read_image
    if name == "sky":
        func = L.infinite_importance(read_image(SKY))
    elif name == "zero rows":
        func = np.random.default_rng(4).random((6, 12)).astype(np.float32)
        func[[0, 3]] = 0.0
    else:
        func = L.infinite_importance(np.ones((4, 8, 3), np.float32))
    jd = JS.Distribution2D.create(jnp.asarray(func))
    pd = S.Distribution2D.create(func)
    h, w = func.shape
    for a, b, n in ((pd.conditional.cdf, jd.conditional.cdf, w),
                    (pd.marginal.cdf, jd.marginal.cdf, h),
                    (pd.conditional.func_int, jd.conditional.func_int, w),
                    (pd.marginal.func_int, jd.marginal.func_int, h)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=n * 2.0 ** -24, atol=1e-7)
    cd = S.Distribution2D(*(S.Distribution1D(*(_t(a) for a in x))
                            for x in (jd.conditional, jd.marginal)))
    u = np.random.default_rng(5).random((4000, 2)).astype(np.float32)
    uv, pdf = cd.sample_continuous(_t(u))
    juv, jpdf = jd.sample_continuous(jnp.asarray(u))
    np.testing.assert_array_equal(
        np.floor(uv.numpy() * [w, h]), np.floor(np.asarray(juv) * [w, h]))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-6)
    np.testing.assert_allclose(cd.pdf(uv).numpy(),
                               np.asarray(jd.pdf(juv)), rtol=1e-6)


@pytest.mark.parametrize("wrap", [MM.WRAP_REPEAT, MM.WRAP_CLAMP,
                                  MM.WRAP_BLACK])
def test_bilerp_level_wrapped(wrap):
    """The envmap's one-level bilinear lookup at points inside and outside
    [0, 1)^2 (the seam, the poles, whole periods away), within 1e-6."""
    rng = np.random.default_rng(6)
    level = rng.random((5, 7, 3)).astype(np.float32)
    st = np.concatenate([rng.uniform(-1.5, 2.5, (3000, 2)),
                         [[0, 0], [1, 1], [0.5 / 7, 0.5 / 5], [1, 0],
                          [0.9999, 0.0001]]]).astype(np.float32)
    got = MM.bilerp_level(_t(level), _t(st), wrap).numpy()
    ref = np.asarray(JMM.bilerp_level(jnp.asarray(level), jnp.asarray(st),
                                      wrap))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the tables, sample_li, pdf_li_hit, the escape radiance
# ---------------------------------------------------------------------------

def test_lights_from_jax_every_type(scenes):
    """The port's parse of SCENE builds the JAX package's light table: the
    rows in the reference's order, their types, positions, emissions,
    prims, areas, quadrics and infinite maps; its cdfs within 1e-6."""
    jb, pb, clt = scenes
    plt = pb.lights
    assert plt.n_lights == 10 and plt.inf_rows == (8, 9)
    assert plt.kinds == clt.kinds == frozenset(
        {"point", "distant", "tri", "quadric", "sphere", "disk", "cylinder",
         "cone", "infinite"})
    assert plt.l_nondelta_rows == tuple(range(2, 10))
    for f in ("l_type", "l_prim", "l_twosided", "l_tri_rev", "l_q_type",
              "l_q_rev", "l_cone", "row_inf", "inf_desc"):
        assert torch.equal(getattr(plt, f), getattr(clt, f)), f
    for f in ("l_pos", "l_emit", "l_area", "l_tri_p", "l_q_o2w", "l_q_w2o",
              "l_q_params", "inf_l2w", "inf_w2l", "inf_scale",
              "world_center"):
        np.testing.assert_allclose(getattr(plt, f).numpy(),
                                   getattr(clt, f).numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    assert plt.world_radius == clt.world_radius
    for a, b in zip(plt.inf_maps, clt.inf_maps):
        assert torch.equal(a, b)
    np.testing.assert_allclose(plt.inf_flat.numpy(), clt.inf_flat.numpy(),
                               rtol=1e-6, atol=1e-6)
    q_al = pb.geom.q_arealight.tolist()
    assert q_al == np.asarray(jb.geom.q_arealight).tolist()
    assert sorted(x for x in q_al if x >= 0) == [2, 3, 4, 5]


def _lanes(rows, seed=3, n=N):
    rng = np.random.default_rng(seed)
    lid = rng.choice(rows, n).astype(np.int32)
    p = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    p[:, 1] = np.abs(p[:, 1])
    u = rng.random((n, 2)).astype(np.float32)
    return lid, p, u


def _cone_slack(lid, p):
    """The cone's own conditioning: 1 - cos theta_max cancels (cos theta_max
    = sqrt(1 - r^2 / d^2) near 1 for a small or far sphere), and the sample
    and its pdf inherit a relative error of a few ulp of 1 over it. -> the
    allowance 2.4e-7 / (1 - cos theta_max) on the lanes of row 2 (the full
    sphere, radius 0.3 at (-2, 1, 0.5)) seen from outside, else 0."""
    dc2 = ((p - np.array([-2.0, 1.0, 0.5])) ** 2).sum(-1)
    out = (lid == 2) & (dc2 > 0.09)
    one_minus = 1.0 - np.sqrt(np.maximum(0.0, 1.0 - 0.09 / dc2))
    return np.where(out, 2.4e-7 / np.maximum(one_minus, 1e-12), 0.0)


@pytest.mark.parametrize("kind", list(ROWS))
def test_sample_li_matches_jax(scenes, kind):
    jb, _, clt = scenes
    lid, p, u = _lanes(ROWS[kind])
    jl = JL.sample_li(jb.lights, jb.geom, jnp.asarray(lid),
                      SimpleNamespace(p=jnp.asarray(p), t=jnp.zeros(N)),
                      jnp.asarray(u))
    tl = L.sample_li(clt, _t(lid), SimpleNamespace(p=_t(p)), _t(u))
    slack = 1e-5 + _cone_slack(lid, p)
    for f in ("wi", "li", "p_target", "n_target", "err_target"):
        a, b = getattr(tl, f).numpy(), np.asarray(getattr(jl, f))
        scale = np.maximum(np.abs(b).max(-1), 1e-30)
        assert (np.abs(a - b).max(-1) / scale <= slack).all(), f
    cos_l = np.abs((np.asarray(jl.n_target) * -np.asarray(jl.wi)).sum(-1))
    pdf, jpdf = tl.pdf.numpy(), np.asarray(jl.pdf)
    area = np.isin(lid, [2, 3, 4, 5, 6, 7])
    bound = slack + np.where(area, 4e-7 / np.maximum(cos_l, 1e-12), 0.0)
    assert (_rel(pdf, jpdf) <= bound).all()
    assert (pdf > 0).mean() > 0.3
    types = clt.l_type.numpy()[lid]
    for f in ("is_delta", "at_infinity"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)))
    assert set(types.tolist()) == set(clt.l_type.numpy()[ROWS[kind]])


def test_cone_samples_land_on_visible_cap(scenes):
    """tests/test_conelight.py on the port: from outside, every cone sample
    of the full sphere light faces the receiver, with the uniform-cone pdf
    1 / (2 pi (1 - cos theta_max)) for all lanes."""
    _, _, clt = scenes
    n = 2048
    u = torch.as_tensor(np.random.default_rng(0).random((n, 2)),
                        dtype=torch.float32)
    p = torch.tensor([[1.0, 1.0, 0.5]]).expand(n, 3)
    ls = L.sample_li(clt, torch.full((n,), 2, dtype=torch.int32),
                     SimpleNamespace(p=p), u)
    assert (ls.li[:, 0] > 0).all()
    sin2max = 0.3 ** 2 / 9.0
    np.testing.assert_allclose(
        ls.pdf.numpy(), 1.0 / (2 * np.pi * (1 - np.sqrt(1 - sin2max))),
        rtol=1e-4)
    centre = torch.tensor([-2.0, 1.0, 0.5])
    np.testing.assert_allclose((ls.p_target - centre).norm(dim=-1).numpy(),
                               0.3, rtol=1e-4)


@pytest.mark.parametrize("cone", [False, True], ids=["area", "cone"])
def test_pdf_li_hit_matches_jax(scenes, cone):
    """The emission-hit density of a bounce ray from prev_p toward a point
    on an area light: the uniform-area density, or, for the full sphere
    seen from outside, the cone's (reference pdf_li_hit)."""
    jb, _, clt = scenes
    rows = [2] if cone else [3, 4, 5, 6, 7]
    lid, prev_p, u = _lanes(rows, seed=8)
    jl = JL.sample_li(jb.lights, jb.geom, jnp.asarray(lid),
                      SimpleNamespace(p=jnp.asarray(prev_p), t=jnp.zeros(N)),
                      jnp.asarray(u))
    p_hit, n_hit = np.asarray(jl.p_target), np.asarray(jl.n_target)
    d = np.asarray(jl.wi)
    lid[::7] = -1
    ref = np.asarray(JL.pdf_li_hit(jb.lights, jb.geom, jnp.asarray(lid),
                                   jnp.asarray(prev_p), jnp.asarray(d),
                                   jnp.asarray(p_hit), jnp.asarray(n_hit)))
    got = L.pdf_li_hit(clt, _t(lid), _t(prev_p), _t(d), _t(p_hit),
                       _t(n_hit)).numpy()
    cos_l = np.abs((n_hit * d).sum(-1))
    bound = 1e-5 + _cone_slack(lid, prev_p) + 4e-7 / np.maximum(cos_l, 1e-12)
    assert (_rel(got, ref) <= bound).all()
    assert (got[lid < 0] == 0).all() and (got[lid >= 0] > 0).mean() > 0.4


def _dirs(n=N, seed=9):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0, 1, 0],
             [0, -1, 0], [1, -1e-7, 0], [1, 1e-7, 0]]   # poles and seam
    return d


def _pole_slack(lt, d):
    """1e-5 plus 1e-5 / sin theta, theta the direction's polar angle in
    each light's frame: near a pole acos turns an ulp or two of the unit z
    into 1 / sin theta times that in theta, and the map's slope there
    into the radiance (REPEAT wraps the sky's last row onto its first, so
    near the lower pole its ground blends into its zenith)."""
    st = np.stack([L._inf_dir_to_uv(lt, k, _t(d))[1].numpy()
                   for k in range(lt.n_infinite)]).min(0)
    return 1e-5 + 1e-5 / np.maximum(st, 1e-12)


def test_infinite_le_matches_jax(scenes):
    jb, _, clt = scenes
    d = _dirs()
    ref = np.asarray(JL.infinite_le(jb.lights, jnp.asarray(d)))
    mask = np.random.default_rng(1).random(N) < 0.5
    mask[:8] = True
    bound = _pole_slack(clt, d)
    for m in (None, mask):
        got = L.infinite_le(clt, _t(d), None if m is None else _t(m)).numpy()
        m = np.ones(N, bool) if m is None else m
        assert (got[~m] == 0).all()
        err = np.abs(got - ref).max(-1)
        assert (err[m] <= bound[m] * np.abs(ref).max(-1)[m] + 1e-7).all()


@pytest.mark.parametrize("pmf", ["uniform", "per lane"])
def test_infinite_le_mis_matches_jax(scenes, pmf):
    """The escape radiance after a bounce: each infinite light's Le
    weighted by the power heuristic against its pdf times its selection
    pmf (1/n, or a per-lane value as the grid gives), weight 1 after a
    specular bounce."""
    jb, _, clt = scenes
    rng = np.random.default_rng(12)
    d = _dirs(seed=13)
    prev_pdf = (rng.random(N) * 3).astype(np.float32)
    prev_pdf[:50] = 0.0
    prev_spec = rng.random(N) < 0.2
    if pmf == "uniform":
        pmfs = [1.0 / clt.n_lights] * 2
    else:
        tabs = rng.random((2, N)).astype(np.float32)
        pmfs = [_t(tabs[0]), _t(tabs[1])]
    rows = list(clt.inf_rows)

    def pmf_fn(row):
        if pmf == "uniform":
            return jnp.full((N,), 1.0 / clt.n_lights, jnp.float32)
        return jnp.where(row == rows[0], tabs[0], tabs[1])

    ref = np.asarray(JL.infinite_le_mis(
        jb.lights, jnp.asarray(d), jnp.asarray(prev_pdf),
        jnp.asarray(prev_spec), pmf_fn))
    got = L.infinite_le_mis(clt, _t(d), _t(prev_pdf), _t(prev_spec),
                            pmfs).numpy()
    same = np.ones(N, bool)
    for k in range(clt.n_infinite):
        h, w = clt.inf_maps[k].shape[:2]
        uv = L._inf_dir_to_uv(clt, k, _t(d))[0].numpy()
        juv = np.asarray(JL._inf_dir_to_uv(jb.lights, k, jnp.asarray(d))[0])
        same &= (np.floor(uv * [w, h]) == np.floor(juv * [w, h])).all(-1)
    assert same.mean() >= 0.995, same.mean()
    bound = _pole_slack(clt, d)[same]
    err = np.abs(got - ref).max(-1)[same]
    assert (err <= bound * np.abs(ref).max(-1)[same] + 1e-7).all()


def test_delta_lights_weight_one():
    """A scene with point and distant lights only (the reference's
    l_nondelta_rows empty): their NEE weight is 1, their pdf the selection
    pmf alone; a scene without lights has the one dummy row, which emits
    nothing."""
    from rustracer_tpu_torch.scene.tables import make_geometry
    geom = make_geometry(device="cpu")
    lt = L.make_lights([dict(type=L.LIGHT_POINT, pos=(0, 2, 0),
                             emit=(4, 4, 4), prim=-1),
                        dict(type=L.LIGHT_DISTANT, pos=(0, 1, 0),
                             emit=(1, 1, 1), prim=-1)], geom,
                       world_radius=5.0, device="cpu")
    assert lt.l_nondelta_rows == () and lt.kinds == {"point", "distant"}
    n = 64
    ls = L.sample_li(lt, torch.arange(n, dtype=torch.int32) % 2,
                     SimpleNamespace(p=torch.zeros(n, 3)),
                     torch.rand(n, 2))
    assert ls.is_delta.all() and (ls.pdf == 1).all()
    assert torch.equal(ls.at_infinity, torch.arange(n) % 2 == 1)
    np.testing.assert_allclose(ls.li[0].numpy(), 1.0)        # 4 / 2^2
    none = L.make_lights([], geom, device="cpu")
    assert none.n_lights == 1 and none.kinds == {"dummy"}
    ls = L.sample_li(none, torch.zeros(n, dtype=torch.int32),
                     SimpleNamespace(p=torch.zeros(n, 3)), torch.rand(n, 2))
    assert (ls.li == 0).all() and (ls.pdf == 0).all()


def test_mixed_light_render_matches_jax():
    """SCENE (every light type over matte quads and a matte sphere)
    rendered by both packages from their own parses, uniform light pick,
    32 x 24 at 2 spp, depth 3: NEE toward each type with its shadow ray
    (distant and infinite ones at t_max = inf), the delta lights' weight 1,
    the cone, and escaped rays' MIS-weighted sky."""
    jb = jax_parse_string(SCENE).scene
    pb = parse_scene_string(SCENE, device="cpu").scene
    ref = np.asarray(jb.render())
    img = pb.render().numpy()
    assert img.shape == ref.shape == (24, 32, 3)
    assert np.isfinite(img).all() and img.mean() > 0.05
    err = np.abs(img - ref)
    scale = float(ref.mean())
    assert err.mean() / scale < 2e-5 and np.percentile(err, 99) / scale < 2e-3


def test_estimate_direct_toward_delta_and_infinite(scenes):
    """NEE toward every row of SCENE from points on the floor (matte,
    facing up), through both packages' estimate_direct_light_side: the
    shadow rays to distant and infinite lights are direction probes with
    t_max = inf, a delta light's weight 1."""
    from rustracer_tpu.integrators.common import \
        estimate_direct_light_side as jax_estimate
    jb, pb, clt = scenes
    from rustracer_tpu.core.ray import Ray as JRay
    from rustracer_tpu.scene.tables import scene_intersect as jax_intersect
    from rustracer_tpu_torch.core.ray import Ray
    from rustracer_tpu_torch.render.renderer import RenderContext
    from rustracer_tpu_torch.scene.tables import scene_intersect
    n = 2048
    rng = np.random.default_rng(21)
    o = np.stack([rng.uniform(-3, 3, n), np.full(n, 3.9),
                  rng.uniform(-3, 2.5, n)], -1).astype(np.float32)
    d = np.tile(np.array([[0, -1, 0]], np.float32), (n, 1))
    lid = rng.integers(0, 10, n).astype(np.int32)
    u = rng.random((n, 2)).astype(np.float32)
    pmf = np.full(n, 0.1, np.float32)
    jsi = jax_intersect(jb.geom, JRay(o=jnp.asarray(o), d=jnp.asarray(d),
                                      t_max=jnp.full(n, np.inf)))
    jsi, jlobes = jb.material_set.shade(jsi, jb.context())
    ref, _ = jax_estimate(jb.context(), jb.material_set, jsi, jlobes,
                          jnp.asarray(lid), jnp.asarray(u), jnp.asarray(pmf))
    ctx = RenderContext(geom=pb.geom, lights=clt, textures=pb.textures)
    si = scene_intersect(pb.geom, Ray(o=_t(o), d=_t(d),
                                      t_max=torch.full((n,), np.inf)))
    si, lobes = pb.material_set.shade(si, ctx)
    got = estimate_direct_light_side(ctx, pb.material_set, si, lobes,
                                     _t(lid), _t(u), _t(pmf)).numpy()
    ref = np.asarray(ref)
    assert (got.sum(-1) > 0).mean() > 0.3
    lit = np.abs(got - ref).max(-1) <= 1e-5 * np.abs(ref).max(-1) + 1e-7
    # a lane whose shadow ray grazes an occluder may land apart (XLA's
    # and torch's float32 roundings of the hit tests): at most 0.2%
    assert lit.mean() >= 0.998, lit.mean()


# ---------------------------------------------------------------------------
# tools/light_work.py: the one-light scenes and K12's operation counts
# ---------------------------------------------------------------------------

# the rows of SCENE that each of tools/light_work.py's light directives adds
LIGHT_ROWS = {"point": [0], "distant": [1], "full sphere (cone)": [2],
              "clipped sphere": [3], "disk": [4], "cylinder": [5],
              "triangle": [6, 7], "infinite": [8], "infinite ones": [9]}


@pytest.mark.parametrize("name", list(LIGHT_ROWS))
def test_light_scene_keeps_one_light(scenes, name):
    """light_scene(name) parses to the rows of SCENE that the directive
    adds, equal field for field (chip_smoke.py times each branch of K12 on
    such a table)."""
    assert set(LW.MIXED_LIGHTS) == set(LIGHT_ROWS)
    text = LW.light_scene(name).replace('"textures/sky.exr"', f'"{SKY}"')
    one = parse_scene_string(text, device="cpu").scene.lights
    full = scenes[1].lights
    rows = LIGHT_ROWS[name]
    assert one.n_lights == len(rows)
    for f in ("l_type", "l_pos", "l_emit", "l_twosided", "l_area",
              "l_tri_p", "l_tri_rev", "l_q_type", "l_q_o2w", "l_q_params",
              "l_q_rev", "l_cone"):
        assert torch.equal(getattr(one, f), getattr(full, f)[rows]), f
    inf = [full.inf_rows.index(r) for r in rows if r in full.inf_rows]
    assert len(one.inf_maps) == len(inf)
    for a, k in zip(one.inf_maps, inf):
        assert torch.equal(a, full.inf_maps[k])
    with pytest.raises(ValueError, match="spot"):
        LW.light_scene("spot")


@pytest.mark.parametrize("name,ops", [
    ("point", "K12_POINT_OPS"), ("triangle", "K12_PROBE_OPS"),
    ("clipped sphere", "K12_AREA_OPS"), ("full sphere (cone)", "cone"),
    ("distant", "K12_DISTANT_OPS"), ("infinite", "sample")])
def test_k12_light_work_counts_each_branch(scenes, name, ops):
    """k12_light_work on a row of each branch of K12's lights kernel, over
    10 voxels and 128 probes: a triangle row at the triangle kernel's
    K12_PROBE_OPS a (voxel, probe), a point or quadric row at its own
    count, the cone's probes besides, a distant or infinite row once a
    probe; the bytes are its column out and its table row in (and an
    infinite light's map and distribution)."""
    from rustracer_tpu_torch.scene import lightdistrib as LD
    lt = scenes[1].lights
    j = LIGHT_ROWS[name][0]
    n_vox, n_probes, cone = 10, 128, 300
    w = LW.k12_light_work(lt, j, n_vox, n_probes,
                          cone if ops == "cone" else 0)
    pairs = n_vox * n_probes
    want = {"K12_POINT_OPS": pairs * LW.K12_POINT_OPS,
            "K12_PROBE_OPS": pairs * LD.K12_PROBE_OPS,
            "K12_AREA_OPS": pairs * LW.K12_AREA_OPS,
            "cone": pairs * LW.K12_AREA_OPS + cone * LW.K12_CONE_OPS,
            "K12_DISTANT_OPS": n_probes * LW.K12_DISTANT_OPS,
            "sample": n_probes * (LW._inf_sample_ops(32, 64)
                                  + LW.K12_DISTANT_OPS)}[ops]
    assert w["ops"] == want
    row = 4 * (1 + 3 + 3 + 1 + 1 + 9 + 1 + 1 + 16 + 16 + 4 + 1 + 1 + 1)
    extra = LW._table_bytes(lt, 0) if name == "infinite" else 0
    assert w["moved"] == n_vox * 4 + row + extra
    if name == "triangle":
        assert LD.K12_PROBE_OPS < LW.K12_AREA_OPS
