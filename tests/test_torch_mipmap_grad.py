"""Port parity of the per-texture lookups' texel gradient: hand kernel
K20's plain version (``rustracer_tpu_torch/ops/mipmap.py``
``mipmap_lookup_bwd_plain``, under the ``_MipmapLookup`` autograd Function
that the lookups take when their texel rows require grad) against
``jax.vjp`` of ``rustracer_tpu/ops/mipmap.py``'s ``lookup_trilinear``,
``lookup_ewa`` and ``lookup_ewa_exact``, on the CPU, on seeded numpy
inputs handed to both.

tests/test_torch_mipmap.py's inputs: the 37 x 50 image of 1 and 3
channels (resampled to 64 x 64 by the pyramid build), each wrap mode, st
inside and outside [0, 1)^2, widths over four decades, footprints of
anisotropy 1 to 32 at every angle and degenerate ones; a seeded cotangent
in [-1, 1]. The port's gradient reaches each pyramid level through the
flat (T, 3) texel rows (``pyramid_texels``, a 1-channel image replicated
to 3), which the lookups read in grad mode also where a scene's atlas
holds the (T, 12) quad rows. Tolerance: every element of every level
within 1e-5 of the largest magnitude of the JAX gradient (both sum the
lanes' adds into a texel in other orders; on these inputs no lane's level
or major axis differs between the packages, tests/test_torch_mipmap.py);
the observed error is printed. A lookup's coordinates that require grad,
K17's or K5's, raise naming ROADMAP item B12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mipmap import _footprints, _pyramid
from rustracer_tpu.ops import mipmap as JM
from rustracer_tpu_torch.ops import mipmap as PM
from rustracer_tpu_torch.scene import atlas as A

torch.set_num_threads(1)
REL = 1e-5
N = 600
CASES = {
    "trilinear": (PM.lookup_trilinear, JM.lookup_trilinear, None),
    "ewa": (PM.lookup_ewa, JM.lookup_ewa, 8.0),
    "exact": (PM.lookup_ewa_exact, JM.lookup_ewa_exact, 16.0),
}


def _inputs(seed, channels):
    st, d0, d1, width = (x[:N] for x in _footprints(seed))
    g = np.random.RandomState(seed + 1).uniform(
        -1, 1, (N, channels)).astype(np.float32)
    return st, d0, d1, width, g


def _jax_grad(mode, pyr, wrap, st, d0, d1, width, g):
    _, fn, ma = CASES[mode]

    def f(levels):
        if mode == "trilinear":
            return fn(levels, jnp.asarray(st), jnp.asarray(width), wrap)
        return fn(levels, jnp.asarray(st), jnp.asarray(d0), jnp.asarray(d1),
                  ma, wrap)
    _, vjp = jax.vjp(f, [jnp.asarray(lv) for lv in pyr])
    return [np.asarray(x) for x in vjp(jnp.asarray(g))[0]]


def _port_lookup(mode, tx, wrap, st, d0, d1, width):
    fn, _, ma = CASES[mode]
    t = [torch.from_numpy(x) for x in (st, d0, d1, width)]
    if mode == "trilinear":
        return fn(tx, t[0], t[3], wrap)
    return fn(tx, t[0], t[1], t[2], ma, wrap)


def _port_grad(mode, pyr, wrap, st, d0, d1, width, g):
    levels = [torch.tensor(lv, requires_grad=True) for lv in pyr]
    tx = PM.pyramid_texels(levels)
    assert tx.texels.requires_grad
    out = _port_lookup(mode, tx, wrap, st, d0, d1, width)
    assert out.grad_fn is not None and out.shape == g.shape
    out.backward(torch.from_numpy(g))
    return [lv.grad.numpy() for lv in levels]


def _close(port, ref, what):
    assert len(port) == len(ref)
    top = max(np.abs(r).max() for r in ref)
    err = max(np.abs(p - r).max() for p, r in zip(port, ref))
    print(f"{what}: max |g_port - g_jax| = {err:.3g} of max |g_jax| "
          f"{top:.3g}")
    assert top > 0 and err <= REL * top, (err, top)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("wrap", [JM.WRAP_REPEAT, JM.WRAP_BLACK,
                                  JM.WRAP_CLAMP])
@pytest.mark.parametrize("mode", list(CASES))
def test_texel_gradient_matches_jax(mode, wrap, channels):
    pyr = _pyramid(channels)
    args = _inputs(10 * wrap + channels, channels)
    ref = _jax_grad(mode, pyr, wrap, *args)
    _close(_port_grad(mode, pyr, wrap, *args), ref,
           f"{mode} wrap {wrap} C={channels}")


@pytest.mark.parametrize("wrap", [JM.WRAP_REPEAT, JM.WRAP_CLAMP])
@pytest.mark.parametrize("mode", list(CASES))
def test_quad_layout_gradient_matches_jax(mode, wrap):
    """A scene whose atlas registrations all wrap REPEAT holds the (T, 12)
    quad rows, which a render's lookups read; in grad mode they read the
    (T, 3) rows instead. Both give the same lookups bit for bit, and the
    gradient through the (T, 3) rows reaches the levels as JAX's."""
    pyr = _pyramid(3)
    args = _inputs(7 + wrap, 3)
    levels = [torch.from_numpy(lv) for lv in pyr]
    flat = PM.pyramid_texels(levels)
    quad = flat._replace(texels=A.atlas_quad_texels([levels]))
    assert quad.texels.shape == (flat.texels.shape[0], 12)
    np.testing.assert_array_equal(
        _port_lookup(mode, quad, wrap, *args[:4]).numpy(),
        _port_lookup(mode, flat, wrap, *args[:4]).numpy())
    _close(_port_grad(mode, pyr, wrap, *args),
           _jax_grad(mode, pyr, wrap, *args), f"{mode} quad wrap {wrap}")


def test_coordinates_requiring_grad_are_refused():
    """st, a width or a differential that requires grad raises naming
    ROADMAP item B12 (the lookups carry no gradient to them), with the
    texels requiring grad or not; without grad mode nothing is refused."""
    tx = PM.pyramid_texels([torch.from_numpy(lv) for lv in _pyramid(3)])
    st, d0, d1, width, _ = (torch.from_numpy(x) for x in _inputs(4, 3))
    st_g = st.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="B12"):
        PM.lookup_trilinear(tx, st_g, width)
    with pytest.raises(NotImplementedError, match="B12"):
        PM.lookup_ewa(tx, st, d0.clone().requires_grad_(), d1)
    tg = tx._replace(texels=tx.texels.clone().requires_grad_())
    with pytest.raises(NotImplementedError, match="B12"):
        PM.lookup_ewa_exact(tg, st, d0, d1.clone().requires_grad_())
    with torch.no_grad():
        PM.lookup_trilinear(tx, st_g, width)


@pytest.mark.parametrize("field", ["uv", "dudx", "dvdy"])
def test_atlas_coordinates_requiring_grad_are_refused(field):
    """K5's lookups likewise (ROADMAP item B12): a uv or a differential of
    the interaction that requires grad raises, through the forward-only
    lookup and through the one differentiable in the texels."""
    from test_torch_atlas import _images, _lookup_inputs, _si
    images = _images()
    meta = A.build_atlas_meta(images)
    texs, uv, diffs, reg = _lookup_inputs(JM.WRAP_REPEAT)
    regs = A.registrations_on(A.build_registrations(texs), "cpu")
    si = _si(uv, diffs, torch.as_tensor)
    setattr(si, field, getattr(si, field).clone().requires_grad_())
    texels = A.atlas_texels([[torch.as_tensor(lv) for lv in p]
                             for p in images])
    args = (torch.as_tensor(meta["atlas_meta"]),
            torch.as_tensor(meta["atlas_levels"]), regs,
            torch.as_tensor(reg), si)
    with pytest.raises(NotImplementedError, match="atlas lookup.*B12"):
        A.atlas_lookup_ewa(texels, *args)
    with pytest.raises(NotImplementedError, match="atlas lookup.*B12"):
        A.atlas_lookup_ewa_grad(texels.clone().requires_grad_(), None, *args)
