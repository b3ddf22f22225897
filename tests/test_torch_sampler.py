"""Port parity: the integer hash, the (0,2) sequence and the samplers (plain
versions of kernels K3 and K3r) against the JAX package.

Tolerance: bit-equal (uint32 arithmetic and one rounding uint32 -> float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.core import lowdiscrepancy as jld
from rustracer_tpu.core import rng as jrng
from rustracer_tpu.render.sampler import SamplerConfig as JaxSampler
from rustracer_tpu_torch.core import lowdiscrepancy as ld
from rustracer_tpu_torch.core import rng
from rustracer_tpu_torch.render.sampler import SamplerConfig

torch.set_num_threads(1)


def _u32(seed, n):
    """uint32 words with the extremes included."""
    w = np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64)
    w[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    return w.astype(np.uint32)


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _t(w):
    return torch.as_tensor(w.astype(np.int64))


def test_hash_u32_bit_equal():
    a, b, c = _u32(0, 4096), _u32(1, 4096), _u32(2, 4096)
    ref = jrng.hash_u32(jnp.asarray(a), jnp.asarray(b), 7, jnp.asarray(c))
    out = rng.hash_u32(_t(a), _t(b), 7, _t(c))
    np.testing.assert_array_equal(out.numpy().astype(np.uint32),
                                  np.asarray(ref))
    ref_f = jrng.hash_float(jnp.asarray(a), 3)
    np.testing.assert_array_equal(_bits(rng.hash_float(_t(a), 3).numpy()),
                                  _bits(ref_f))


def test_sample02_bit_equal():
    idx, s0, s1 = _u32(3, 4096), _u32(4, 4096), _u32(5, 4096)
    np.testing.assert_array_equal(ld.reverse_bits32(_t(idx)).numpy()
                                  .astype(np.uint32),
                                  np.asarray(jld.reverse_bits32(idx)))
    ref = jld.sample02(jnp.asarray(idx), (jnp.asarray(s0), jnp.asarray(s1)))
    out = ld.sample02(_t(idx), (_t(s0), _t(s1)))
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("seed,spp", [(0, 8), (5, 3)])
def test_sampler_dims_bit_equal(seed, spp):
    cfg, jcfg = SamplerConfig(spp=spp, seed=seed), \
        JaxSampler(kind="02sequence", spp=spp, seed=seed)
    assert cfg.spp == jcfg.spp
    rs = np.random.default_rng(seed)
    pix = rs.integers(0, 1 << 20, 2048).astype(np.uint32)
    smp = rs.integers(0, 64, 2048).astype(np.uint32)
    for dim in (0, 1, 2, 9, 31):
        np.testing.assert_array_equal(
            _bits(cfg.get_1d(_t(pix), _t(smp), dim).numpy()),
            _bits(jcfg.get_1d(jnp.asarray(pix), jnp.asarray(smp), dim)))
        np.testing.assert_array_equal(
            _bits(cfg.get_2d(_t(pix), _t(smp), dim).numpy()),
            _bits(jcfg.get_2d(jnp.asarray(pix), jnp.asarray(smp), dim)))
    xy = rs.integers(0, 1024, (2048, 2)).astype(np.float32)
    out = cfg.get_camera_sample(torch.as_tensor(xy), _t(pix), _t(smp))
    ref = jcfg.get_camera_sample(jnp.asarray(xy), jnp.asarray(pix),
                                 jnp.asarray(smp))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


def test_random_sampler_refused():
    """The random sampler, refused until the run surface was ported:
    ``get_1d``, ``get_2d`` and the camera sample bit for bit with the JAX
    package's SamplerConfig(kind="random") (plain version of K3r), its spp
    not rounded (3 stays 3); an unknown kind raises."""
    cfg, jcfg = SamplerConfig(kind="random", spp=3, seed=7), \
        JaxSampler(kind="random", spp=3, seed=7)
    assert cfg.spp == jcfg.spp == 3
    pix, smp = _u32(6, 4096), _u32(7, 4096)
    for dim in (0, 1, 5, 2 ** 31):
        np.testing.assert_array_equal(
            _bits(cfg.get_1d(_t(pix), _t(smp), dim).numpy()),
            _bits(jcfg.get_1d(jnp.asarray(pix), jnp.asarray(smp), dim)))
        np.testing.assert_array_equal(
            _bits(cfg.get_2d(_t(pix), _t(smp), dim).numpy()),
            _bits(jcfg.get_2d(jnp.asarray(pix), jnp.asarray(smp), dim)))
    xy = np.random.default_rng(8).integers(0, 512, (4096, 2)) \
        .astype(np.float32)
    out = cfg.get_camera_sample(torch.as_tensor(xy), _t(pix), _t(smp))
    ref = jcfg.get_camera_sample(jnp.asarray(xy), jnp.asarray(pix),
                                 jnp.asarray(smp))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    with pytest.raises(ValueError):
        SamplerConfig(kind="halton")
