"""Port parity of the shared mip atlas (scene/atlas.py, ops/mipmap.py)
against the JAX package, on seeded numpy inputs.

Tolerances: the pyramid, the atlas metadata and both texel layouts are
bit-equal (the same float32 data moved, and the same float32 box filters on
the host). The plain EWA lookup agrees with the JAX one within 1e-5
absolute on every lane except where the mip level sits on an integer and
the two libraries' log2 round to different sides of it (a floor flip);
such lanes are counted and must stay at most 0.1% of the lanes."""
import types

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.ops import mipmap as JM
from rustracer_tpu.scene import atlas as JA
from rustracer_tpu_torch.ops import mipmap as TM
from rustracer_tpu_torch.scene import atlas as TA
from rustracer_tpu_torch.scenes import hero_texture
from rustracer_tpu_torch.tools.atlas_work import k10_atomics

torch.set_num_threads(1)

LANES = 4096


def _images():
    """Pyramids of the hero texture, a non-power-of-two RGB image and a
    one-channel image (3 atlas images)."""
    rs = np.random.RandomState(7)
    hero, _ = hero_texture()
    return [hero[0],
            TM.build_pyramid(rs.rand(12, 20, 3).astype(np.float32)),
            TM.build_pyramid(rs.rand(8, 8).astype(np.float32))]


def _jax_images(images):
    return [[jnp.asarray(lv) for lv in pyr] for pyr in images]


@pytest.mark.parametrize("shape", [(128, 128, 3), (12, 20, 3), (5, 7),
                                   (1, 6, 1)])
def test_build_pyramid_bit_equal(shape):
    img = np.random.RandomState(3).rand(*shape).astype(np.float32)
    a, b = TM.build_pyramid(img), JM.build_pyramid(img)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))


def test_atlas_tables_bit_equal():
    images = _images()
    meta, jmeta = TA.build_atlas_meta(images), JA.build_atlas_meta(images)
    for k in ("atlas_meta", "atlas_levels"):
        assert meta[k].dtype == jmeta[k].dtype
        np.testing.assert_array_equal(meta[k], jmeta[k])
    assert meta["atlas_total"] == jmeta["atlas_total"]
    jimg = _jax_images(images)
    for port, ref in ((TA.atlas_texels, JA.atlas_texels),
                      (TA.atlas_quad_texels, JA.atlas_quad_texels)):
        a = port([[torch.as_tensor(lv) for lv in p] for p in images])
        b = np.asarray(ref(jimg))
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.view(np.int32))


def _lookup_inputs(wrap, coarse=False):
    """Registrations on every image with assorted mappings and scales, and
    LANES lanes: uv in [-0.5, 1.5], random differentials on 3/4 of the
    lanes and zeros (bounce lanes) on the rest, reg = -1 on some lanes.
    ``coarse``: about 1% of the lanes textured, all with differentials of
    0.03-3 (uv units) that put them on the coarsest levels, as an interior
    bounce's lookups, where many lanes add into one texel."""
    rs = np.random.RandomState(11)
    texs = [types.SimpleNamespace(
        image_id=i % 3, wrap=wrap, scale=[1.0, 0.5, 2.0, 1.25][i],
        mapping=types.SimpleNamespace(su=[1.0, 3.0, 0.5, 2.0][i],
                                      sv=[1.0, 2.0, 1.5, 0.75][i],
                                      du=[0.0, 0.25, -0.1, 0.5][i],
                                      dv=[0.0, -0.5, 0.3, 0.0][i]))
        for i in range(4)]
    uv = rs.uniform(-0.5, 1.5, (LANES, 2)).astype(np.float32)
    scale = 10.0 ** rs.uniform(-4, -0.5, (LANES, 4))
    sign = np.where(rs.rand(LANES, 4) < 0.5, -1.0, 1.0)
    diffs = (scale * sign * (rs.rand(LANES, 1) < 0.75)).astype(np.float32)
    reg = rs.randint(-1, len(texs), LANES).astype(np.int32)
    if coarse:
        scale = 10.0 ** rs.uniform(-1.5, 0.5, (LANES, 4))
        diffs = (scale * sign).astype(np.float32)
        reg = np.where(rs.rand(LANES) < 0.01,
                       rs.randint(0, len(texs), LANES), -1).astype(np.int32)
    return texs, uv, diffs, reg


def _si(uv, diffs, lib):
    f = {"uv": uv, "dudx": diffs[:, 0], "dvdx": diffs[:, 1],
         "dudy": diffs[:, 2], "dvdy": diffs[:, 3]}
    return types.SimpleNamespace(**{k: lib(np.ascontiguousarray(v))
                                    for k, v in f.items()})


@pytest.mark.parametrize("quad,wrap", [(True, TM.WRAP_REPEAT),
                                       (False, TM.WRAP_REPEAT),
                                       (False, TM.WRAP_BLACK),
                                       (False, TM.WRAP_CLAMP)])
def test_lookup_ewa_matches_jax(quad, wrap):
    images = _images()
    meta = TA.build_atlas_meta(images)
    texs, uv, diffs, reg = _lookup_inputs(wrap)
    regs = TA.build_registrations(texs)
    assert TA.all_repeat(regs) == (wrap == TM.WRAP_REPEAT)
    np.testing.assert_array_equal(regs["reg_map"],
                                  JA.build_registrations(texs)["reg_map"])

    jimg = _jax_images(images)
    jtex = JA.atlas_quad_texels(jimg) if quad else JA.atlas_texels(jimg)
    ref = np.asarray(JA.atlas_lookup_ewa(
        jtex, meta["atlas_meta"], meta["atlas_levels"], regs,
        jnp.asarray(reg), _si(uv, diffs, jnp.asarray), quad=quad))

    timg = [[torch.as_tensor(lv) for lv in p] for p in images]
    ttex = TA.atlas_quad_texels(timg) if quad else TA.atlas_texels(timg)
    regs_t = TA.registrations_on(regs, "cpu")
    si = _si(uv, diffs, torch.as_tensor)
    out = TA.atlas_lookup_ewa(
        ttex, torch.as_tensor(meta["atlas_meta"]),
        torch.as_tensor(meta["atlas_levels"]), regs_t,
        torch.as_tensor(reg), si, quad=quad).numpy()

    assert out.shape == ref.shape == (LANES, 3)
    assert np.isfinite(out).all() and (out[reg < 0] == 0).all()
    assert np.abs(ref).max() > 0.1
    # lanes whose mip level sits on an integer may floor differently
    _, img, _, _, _, minor = TA._ewa_axes(regs_t, torch.as_tensor(reg), si)
    level, _ = TA.ewa_level(torch.as_tensor(meta["atlas_levels"]), img,
                            minor)
    level = level.numpy()
    on_int = np.abs(level - np.round(level)) < 1e-4
    bad = np.abs(out - ref).max(-1) > 1e-5
    print(f"lanes beyond 1e-5: {int(bad.sum())}, of which on an integer "
          f"level: {int((bad & on_int).sum())}")
    assert not (bad & ~on_int).any()
    assert bad.mean() <= 1e-3


@pytest.mark.parametrize("quad,wrap", [(True, TM.WRAP_REPEAT),
                                       (False, TM.WRAP_REPEAT),
                                       (False, TM.WRAP_BLACK),
                                       (False, TM.WRAP_CLAMP)])
def test_lookup_ewa_vjp_matches_jax(quad, wrap):
    """The texel gradient of the differentiable lookup (the autograd
    Function around K5, whose CPU backward is K10's plain version) against
    ``jax.vjp`` of the JAX lookup, both taken back to every pyramid level
    through the atlas build (for quad rows: built from the (T, 3) texels
    by the port, by jnp.roll in JAX). The cotangent is zero on the lanes
    whose mip level sits on an integer (a floor flip moves their taps to
    the other level). Tolerance: 1e-5 of the largest texel gradient (sums
    of up to a few thousand float32 terms in another order)."""
    _vjp_matches_jax(quad, wrap, coarse=False)


@pytest.mark.parametrize("quad,wrap", [(True, TM.WRAP_REPEAT),
                                       (False, TM.WRAP_REPEAT),
                                       (False, TM.WRAP_BLACK),
                                       (False, TM.WRAP_CLAMP)])
def test_lookup_ewa_vjp_matches_jax_coarse(quad, wrap):
    """As test_lookup_ewa_vjp_matches_jax, on the inputs K10's design
    targets: about 1% of the lanes textured, on the coarsest levels, so
    many lanes add into one texel (the top level of each pyramid is one
    texel). Lanes clamped to the top level keep their cotangent: the clamp
    is exact in both libraries; the cotangent is zero only where the
    unclamped level sits on an integer."""
    _vjp_matches_jax(quad, wrap, coarse=True)


def _vjp_matches_jax(quad, wrap, coarse):
    images = _images()
    meta = TA.build_atlas_meta(images)
    texs, uv, diffs, reg = _lookup_inputs(wrap, coarse)
    regs = TA.build_registrations(texs)
    regs_t = TA.registrations_on(regs, "cpu")
    si = _si(uv, diffs, torch.as_tensor)
    _, img, _, _, _, minor = TA._ewa_axes(regs_t, torch.as_tensor(reg), si)
    levels_t = torch.as_tensor(meta["atlas_levels"])
    if coarse:
        level = (levels_t[img.long()] - 1).float() \
            + torch.log2(torch.clamp(minor, min=1e-8))
    else:
        level, _ = TA.ewa_level(levels_t, img, minor)
    on_int = np.abs(level.numpy() - np.round(level.numpy())) < 1e-4
    cot = np.random.RandomState(4).uniform(-1, 1, (LANES, 3))
    cot = (cot * ~on_int[:, None]).astype(np.float32)
    if coarse:
        top_level = (levels_t[img.long()] - 1).numpy()
        live = (reg >= 0) & ~on_int
        assert 20 <= live.sum() <= 80
        # most of them on the two coarsest levels of their pyramid
        assert (level.numpy()[live] > top_level[live] - 2).mean() > 0.5

    def jax_lookup(levels_):
        it = iter(levels_)
        imgs = [[next(it) for _ in p] for p in images]
        tex = JA.atlas_quad_texels(imgs) if quad else JA.atlas_texels(imgs)
        return JA.atlas_lookup_ewa(tex, meta["atlas_meta"],
                                   meta["atlas_levels"], regs,
                                   jnp.asarray(reg), _si(uv, diffs,
                                                         jnp.asarray),
                                   quad=quad)
    flat = [jnp.asarray(lv) for p in images for lv in p]
    _, vjp = jax.vjp(jax_lookup, flat)
    ref = [np.asarray(g) for g in vjp(jnp.asarray(cot))[0]]

    leaves = [torch.tensor(lv, requires_grad=True)
              for p in images for lv in p]
    it = iter(leaves)
    timg = [[next(it) for _ in p] for p in images]
    qidx = TA.atlas_quad_index(timg) if quad else None
    out = TA.atlas_lookup_ewa_grad(
        TA.atlas_texels(timg), qidx, torch.as_tensor(meta["atlas_meta"]),
        torch.as_tensor(meta["atlas_levels"]), regs_t, torch.as_tensor(reg),
        si)
    out.backward(torch.as_tensor(cot))
    top = max(np.abs(r).max() for r in ref)
    assert top > 0
    for lv, r in zip(leaves, ref):
        assert lv.grad.shape == r.shape
        np.testing.assert_allclose(lv.grad.numpy(), r, rtol=0,
                                   atol=1e-5 * top)


def _k10_case(case):
    """64 lanes (one tile: K10 runs each lookup on 4 threads, 8 lookups a
    warp, 8 warps; the parent ran 2 warps of one thread a lane) on one
    registration of a 128^2 pyramid (8 levels; level 7, one texel, at
    offset 21844), identity mapping, REPEAT. "level 7": uv (1, 1) with unit
    differentials along s and t: the level is 7 with blend 0, and every
    tap falls on the quad at (0, 0), whose 4 corners wrap onto the one
    texel. "distinct": zero differentials (level 0, blend 0) at the
    centres of level-0 texels (4i, 4j), i, j < 8: each lane's 4 corners on
    level 0 and 4 on level 1 touch no other lane's, and only corner (0, 0)
    of level 0 has a nonzero weight."""
    rs = np.random.RandomState(5)
    pyr = TM.build_pyramid(rs.rand(128, 128, 3).astype(np.float32))
    meta = TA.build_atlas_meta([pyr])
    assert meta["atlas_total"] == 21845
    tex = types.SimpleNamespace(
        image_id=0, wrap=TM.WRAP_REPEAT, scale=1.0,
        mapping=types.SimpleNamespace(su=1.0, sv=1.0, du=0.0, dv=0.0))
    regs = TA.registrations_on(TA.build_registrations([tex]), "cpu")
    n = 64
    if case == "level 7":
        uv = np.ones((n, 2), np.float32)
        diffs = np.tile(np.float32([1.0, 0.0, 0.0, 1.0]), (n, 1))
    else:
        i, j = np.meshgrid(np.arange(8), np.arange(8))
        uv = np.stack([(4 * i.ravel() + 0.5) / 128,
                       (4 * j.ravel() + 0.5) / 128], -1).astype(np.float32)
        diffs = np.zeros((n, 4), np.float32)
    g = torch.as_tensor(rs.uniform(0.5, 1.0, (n, 3)).astype(np.float32))
    return (torch.as_tensor(meta["atlas_meta"]),
            torch.as_tensor(meta["atlas_levels"]), regs,
            torch.zeros(n, dtype=torch.int32), _si(uv, diffs, torch.as_tensor),
            g)


# by hand, 64 lanes of 64 adds each (4096); level 1 has blend 0, so K10
# skips it, and each thread's taps fall on one quad, added once at the end:
# "level 7": every add lands on the one texel: the parent adds once for each
#   of its 2 warps' 64 add numbers (x 3 channels = 384), K10 once a warp
#   (8 x 3 = 24), and that texel takes all 4096 adds;
# "distinct": no two lanes share a texel, so the parent adds every add
#   (4096 x 3); K10 adds the 64 texels of nonzero weight once (192), the 4
#   threads of a lookup summed first; a texel takes its lane's 8 taps
@pytest.mark.parametrize("case,parent,new,most", [
    ("level 7", 384, 24, 4096), ("distinct", 12288, 192, 8)])
@pytest.mark.parametrize("quad", [True, False])
def test_k10_atomics_by_hand(case, parent, new, most, quad):
    meta, levels, regs, reg, si, g = _k10_case(case)
    got = k10_atomics(meta, levels, regs, reg, si, quad, g, 21845)
    assert got == dict(adds=4096, parent=parent, new=new,
                       max_adds_texel=most)
    # lane 0's gradient is zero: the parent still adds, K10 leaves out the
    # adds of a zero sum (lane 0's texel where no other lane adds)
    g[0] = 0.0
    got = k10_atomics(meta, levels, regs, reg, si, quad, g, 21845)
    assert got["parent"] == parent
    assert got["new"] == (24 if case == "level 7" else 189)
