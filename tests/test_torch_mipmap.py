"""Port parity of the per-texture mipmap lookups
(``rustracer_tpu_torch/ops/mipmap.py``: ``lookup_trilinear``,
``lookup_ewa`` and ``lookup_ewa_exact``, the plain twins of hand kernel
K17) against the JAX package, on the CPU, on seeded numpy inputs handed to
both.

``tests/test_ewa.py``'s anchors: a non-power-of-two image (37 x 50,
resampled to 64 x 64 by the pyramid build) of 1 and 3 channels, each wrap
mode (repeat, black, clamp), st inside and outside [0, 1)^2, filter widths
over four decades, footprints of anisotropy 1 to 32 at every angle (the
exact lookup's bounding box passes its 128 texels at 16:1 and beyond, and
is truncated there as in the reference), and degenerate footprints (zero
differentials, one zero axis, footprints wider than the image).
Tolerances, on texel values in [0, 1] and on every lane: 1e-6 absolute
for the trilinear and 8-tap lookups (the same float32 operations in the
same order; log2 may differ in its last bit, which could move a level's
floor where the lod is an integer: no lane of these inputs does); 2e-5
absolute for the exact lookup, whose weights exp(-2 r^2) - exp(-2) cancel
near the ellipse's edge: where the 128 texels it visits hold only a few
inside the ellipse (a 32:1 footprint truncated after 128 of some 2,500
texels of its box), a weight sum of about 0.015 from two such taps turns
the last-bit differences of XLA's exp and PyTorch's into about 1e-5. The port reads the levels from the flat
texel rows (``pyramid_texels``, the atlas's layout) or from the quad rows
(the first 3 floats of each 12-float row) with the same results.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.ops import mipmap as JM
from rustracer_tpu_torch.ops import mipmap as PM
from rustracer_tpu_torch.scene import atlas as A

torch.set_num_threads(1)
ATOL = 1e-6
ATOL_EXACT = 2e-5


def _pyramid(channels):
    rs = np.random.RandomState(channels)
    yy, xx = np.mgrid[0:37, 0:50]
    img = np.stack([0.5 + 0.5 * np.sin(xx / 3.0), 0.5 + 0.4 * np.cos(yy / 5.0),
                    rs.rand(37, 50)], -1).astype(np.float32)
    return JM.build_pyramid(img[..., :channels])


def _footprints(seed, n=1500):
    rs = np.random.RandomState(seed)
    st = rs.uniform(-0.5, 1.5, (n, 2)).astype(np.float32)
    ang = rs.uniform(0, 2 * np.pi, n)
    aniso = 10 ** rs.uniform(0, np.log10(32.0), n)
    minor = 10 ** rs.uniform(-3.5, -0.5, n)
    d0 = np.stack([np.cos(ang), np.sin(ang)], -1) * (minor * aniso)[:, None]
    d1 = np.stack([-np.sin(ang), np.cos(ang)], -1) * minor[:, None]
    d0[:10] = 0.0
    d1[:10] = 0.0                       # no footprint
    d1[10:20] = 0.0                     # one axis
    d0[20:30] *= 1e3                    # wider than the image
    width = (10 ** rs.uniform(-4, 0.5, n)).astype(np.float32)
    width[:5] = 0.0
    return st, d0.astype(np.float32), d1.astype(np.float32), width


def _close(out, ref, atol=ATOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= atol, err


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("wrap", [JM.WRAP_REPEAT, JM.WRAP_BLACK,
                                  JM.WRAP_CLAMP])
def test_lookups_match(wrap, channels):
    pyr = _pyramid(channels)
    jp = [jnp.asarray(lv) for lv in pyr]
    tp = PM.pyramid_texels([torch.from_numpy(lv) for lv in pyr])
    st, d0, d1, width = _footprints(10 * wrap + channels)
    j = [jnp.asarray(x) for x in (st, d0, d1, width)]
    t = [torch.from_numpy(x) for x in (st, d0, d1, width)]
    _close(PM.lookup_trilinear(tp, t[0], t[3], wrap),
           JM.lookup_trilinear(jp, j[0], j[3], wrap))
    for ma in (2.0, 8.0):
        _close(PM.lookup_ewa(tp, t[0], t[1], t[2], ma, wrap),
               JM.lookup_ewa(jp, j[0], j[1], j[2], ma, wrap))
    for ma in (16.0, 32.0):
        _close(PM.lookup_ewa_exact(tp, t[0], t[1], t[2], ma, wrap),
               JM.lookup_ewa_exact(jp, j[0], j[1], j[2], ma, wrap),
               ATOL_EXACT)


def test_exact_lookup_truncates_at_128_texels():
    """At 32:1 most boxes pass 128 texels: the truncation (and the
    fallback where no texel lands) is the reference's."""
    tx = PM.pyramid_texels([torch.from_numpy(lv) for lv in _pyramid(3)])
    st, d0, d1, _ = (torch.from_numpy(x) for x in _footprints(7))
    e = PM.ellipse(tx, st, d0, d1, 32.0)
    assert int((e.n_box > PM.N_TAPS_EXACT).sum()) > 100


def test_quad_rows_read_the_same_texels():
    """The lookups on the atlas's quad rows (what a scene whose atlas
    registrations all wrap REPEAT holds) equal those on the flat rows, in
    every wrap mode."""
    pyr = [torch.from_numpy(lv) for lv in _pyramid(3)]
    flat = PM.pyramid_texels(pyr)
    quad = PM.Texels(A.atlas_quad_texels([pyr]), flat.meta, 3)
    st, d0, d1, width = (torch.from_numpy(x) for x in _footprints(8, 300))
    for wrap in (JM.WRAP_REPEAT, JM.WRAP_BLACK, JM.WRAP_CLAMP):
        for fn, args in ((PM.lookup_trilinear, (st, width)),
                         (PM.lookup_ewa, (st, d0, d1, 8.0)),
                         (PM.lookup_ewa_exact, (st, d0, d1, 16.0))):
            a = fn(flat, *args, wrap=wrap)
            b = fn(quad, *args, wrap=wrap)
            assert torch.equal(a, b)


@pytest.mark.parametrize("wrap", [JM.WRAP_REPEAT, JM.WRAP_CLAMP])
def test_plain_comparison_allows_only_level_flips(wrap):
    """``tools/texture_work.py compare_with_plain``, which holds K17
    against its plain version on the card: a lane of the exact lookup
    whose lod lies on a half-integer may take the neighbouring level's
    value; the trilinear and 8-tap lookups allow no flip (their blend of
    two levels is continuous in the lod); any other lane off by more than
    the tolerance, and a flipped lane that takes no neighbour's value, are
    refused."""
    from rustracer_tpu_torch.tools.texture_work import compare_with_plain
    tx = PM.pyramid_texels([torch.from_numpy(lv) for lv in _pyramid(3)])
    st, d0, d1, width = (torch.from_numpy(x) for x in _footprints(9, 20000))
    # lod (L - 1) + log2(minor) = 2.5 on an isotropic footprint
    minor = float(np.float32(2.0 ** (2.5 - (tx.meta.shape[0] - 1))))
    d0[:2] = torch.tensor([minor, 0.0])
    d1[:2] = torch.tensor([0.0, minor])
    args = (tx, st, d0, d1, 16.0, wrap)
    out = PM.lookup_ewa_exact(*args)
    assert compare_with_plain("lookup_ewa_exact", args, out)["flipped"] == 0
    up = PM.Texels(tx.texels, torch.cat([tx.meta[1:], tx.meta[-1:]]), 3)
    flip = out.clone()
    flip[:2] = PM.ewa_exact_plain(up, st[:2], d0[:2], d1[:2], 16.0, wrap)
    assert float((flip[:2] - out[:2]).abs().max()) > 1e-3
    r = compare_with_plain("lookup_ewa_exact", args, flip)
    assert r["flipped"] == 2 and r["max_abs_err"] == 0.0
    for lane, by in ((100, 1e-3), (0, 0.3)):
        bad = flip.clone()
        bad[lane] += by
        with pytest.raises(AssertionError):
            compare_with_plain("lookup_ewa_exact", args, bad)
    for fname, a in (("lookup_trilinear", (tx, st, width, wrap)),
                     ("lookup_ewa", (tx, st, d0, d1, 8.0, wrap))):
        out = getattr(PM, fname)(*a)
        assert compare_with_plain(fname, a, out)["flipped"] == 0
        bad = out.clone()
        bad[0] += 1e-4
        with pytest.raises(AssertionError):
            compare_with_plain(fname, a, bad)
