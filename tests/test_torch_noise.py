"""Port parity of the noise (``rustracer_tpu_torch/core/noise.py``: noise3,
fbm and turbulence, the plain twins of hand kernel K18) against the JAX
package, on the CPU, on seeded numpy points and footprints handed to both.

The integer lattice (each lane's cell corner and its 8 hashes) and the
octave count from the footprint are bit for bit; noise3 itself is bit for
bit (the same float32 operations in the same order); fbm and turbulence
within 1e-6 absolute (their sum over octaves, and the partial octave's
weights, meet the same float32 roundings of the double lam and o; a
different summation order of the footprint's squared length could move a
lane's log2 by an ulp). The reference's departures from PBRT (a hash
lattice, the quintic fade, the partial octave at 1.99^max_octaves and
omega^max_octaves) are what the port reproduces.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.core import noise as JN
from rustracer_tpu.core.rng import hash_u32 as jax_hash
from rustracer_tpu_torch.core import noise as PN
from rustracer_tpu_torch.core.rng import MASK32, hash_u32

torch.set_num_threads(1)


def _inputs(seed, n=2000):
    rs = np.random.RandomState(seed)
    p = rs.uniform(-40, 40, (n, 3)).astype(np.float32)
    p[:8] = np.floor(p[:8])            # on lattice points
    p[8:16] = -np.abs(p[8:16]) - 0.5   # negative corners
    scale = 10 ** rs.uniform(-5, 1, (n, 1))
    dx = (rs.normal(size=(n, 3)) * scale).astype(np.float32)
    dy = (rs.normal(size=(n, 3)) * scale).astype(np.float32)
    dx[16:24] = 0.0
    dy[16:24] = 0.0                    # no footprint: all octaves
    return p, dx, dy


def test_lattice_hashes_bit_for_bit():
    p, _, _ = _inputs(0)
    corner = np.floor(p).astype(np.int32).astype(np.uint32)
    for d in ((0, 0, 0), (1, 0, 1), (1, 1, 1)):
        w = [corner[:, i] + np.uint32(d[i]) for i in range(3)]
        ref = np.asarray(jax_hash(*[jnp.asarray(x) for x in w]))
        out = hash_u32(*[torch.from_numpy(x.astype(np.int64)) & MASK32
                         for x in w])
        np.testing.assert_array_equal(out.numpy().astype(np.uint32), ref)


def test_noise3_bit_for_bit():
    p, _, _ = _inputs(1)
    np.testing.assert_array_equal(
        PN.noise3(torch.from_numpy(p)).numpy().view(np.int32),
        np.asarray(JN.noise3(jnp.asarray(p))).view(np.int32))


@pytest.mark.parametrize("omega,max_octaves", [(0.5, 8), (0.7, 3), (0.35, 1)])
def test_fbm_and_turbulence(omega, max_octaves):
    p, dx, dy = _inputs(2 + max_octaves)
    jp, jx, jy = (jnp.asarray(a) for a in (p, dx, dy))
    tp, tx, ty = (torch.from_numpy(a) for a in (p, dx, dy))
    n, n_int = PN.octaves(tx, ty, max_octaves)
    len2 = np.maximum((dx * dx).sum(-1), (dy * dy).sum(-1))
    ref_n = np.asarray(jnp.clip(-1.0 - 0.5 * jnp.log2(jnp.maximum(
        jnp.asarray(len2), 1e-24)), 0.0, float(max_octaves)))
    np.testing.assert_array_equal(n_int.numpy(), np.floor(ref_n))
    for fn_p, fn_j in ((PN.fbm, JN.fbm), (PN.turbulence, JN.turbulence)):
        out = fn_p(tp, tx, ty, omega, max_octaves).numpy()
        ref = np.asarray(fn_j(jp, jx, jy, omega, max_octaves))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_plain_comparison_allows_only_octave_flips():
    """``tools/texture_work.py compare_with_plain``, which holds K18 against
    its plain version on the card: a lane whose octave count lies on an
    integer may take the value of the other side of it; any other lane
    off by more than the tolerance, and a flipped lane that takes neither
    side's value, are refused."""
    from rustracer_tpu_torch.tools.texture_work import compare_with_plain
    p, dx, dy = (torch.from_numpy(a) for a in _inputs(5, 20000))
    dx[:2] = torch.tensor([2.0 ** -3, 0.0, 0.0])   # |d|^2 = 2^-6: 2 octaves
    dy[:2] = 0.0
    assert torch.equal(PN.octaves(dx, dy, 5)[0][:2], torch.tensor([2.0, 2.0]))
    s = float(np.float32(2.0 ** 2e-5))
    for fname in ("fbm", "turbulence"):
        fn = getattr(PN, fname)
        args = (p, dx, dy, 0.5, 5)
        out = fn(*args)
        assert compare_with_plain(fname, args, out)["flipped"] == 0
        flip = out.clone()
        flip[:2] = fn(p[:2], dx[:2] * s, dy[:2] * s, 0.5, 5)
        assert float((flip[:2] - out[:2]).abs().max()) > 1e-3
        r = compare_with_plain(fname, args, flip)
        assert r["flipped"] == 2 and r["max_abs_err"] == 0.0
        for lane, by in ((100, 1e-4), (0, 0.3)):
            bad = flip.clone()
            bad[lane] += by
            with pytest.raises(AssertionError):
                compare_with_plain(fname, args, bad)
