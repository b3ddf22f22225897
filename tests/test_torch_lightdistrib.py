"""Port parity of the spatial light grid (``rustracer_tpu_torch.scene
.lightdistrib``, the plain versions of K12 and K13) against the JAX
package's ``scene/lightdistrib.py``, on the CPU, on a scene of five area
lights of different sizes, emissions and orientations, one two-sided.

- K12's voxel corners: those it computes from a voxel's flat index
  (``voxel_corners``, the plain twin of the kernel's formula) equal the
  reference's meshgrid corners bit for bit, for the Cornell box's and the
  dragon file's bounds and an odd-shaped grid; the whole grid's sums
  (``grid_contrib``, chunked on the CPU) equal the sums over the
  reference's corners.
- K12's plain version: every (voxel, light) contribution sum within 1e-5
  relative of JAX's (the 128 probes are summed in another order by XLA;
  1e-6 of the largest sum absolute for sums near 0); the grid's host
  tables (voxel counts, bounds) equal and its pmf and cdf within 1e-5
  relative, at ``max_voxels=16`` for time.
- K13's plain versions on the JAX grid's own tables: light ids and pmfs
  equal lane for lane. On the port's grid: equal ids except on lanes
  whose u lies within 1e-5 of a cdf entry of their voxel, which may pick
  the neighbouring light. The test places 64 lanes' u on such an entry (a
  tie, which both packages count as passed) and counts the others: 1 of
  the 2^14 random lanes here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.scene import lightdistrib as JLD
from rustracer_tpu.scene import lights as JL
from rustracer_tpu.scene.api import parse_scene_string as jax_parse_string
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.scene import lightdistrib as LD
from rustracer_tpu_torch.scene.api import parse_scene_string

torch.set_num_threads(1)

SCENE = '''LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "path" "string lightsamplestrategy" "uniform"
WorldBegin
Material "matte" "rgb Kd" [0.5 0.5 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-3 0 -3  3 0 -3  3 0 3  -3 0 3]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 6 4]
  Shape "trianglemesh" "integer indices" [0 2 1 0 3 2]
    "point P" [-2.5 2 -2.5  -1.5 2 -2.5  -1.5 2 -1.5  -2.5 2 -1.5]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [1 2 9] "bool twosided" "true"
  Shape "trianglemesh" "integer indices" [0 1 2]
    "point P" [2 0.5 2  2.5 1.5 2  2 1.5 2.6]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [20 20 20]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [0.2 3 0.2  -0.2 3 0.2  -0.2 3 -0.2  0.2 3 -0.2]
AttributeEnd
WorldEnd
'''
MAX_VOXELS = 16
# lanes of the 2^14 random ones whose u lies within 1e-5 of a cdf entry of
# their voxel (counted on this seed)
NEAR_OTHERS = 1


def _scenes():
    jb = jax_parse_string(SCENE).scene
    pb = parse_scene_string(SCENE, device="cpu").scene
    return jb, pb


def _bounds(pb):
    tv = pb.geom.tv_p.numpy()
    return tv.min(0), tv.max(0)


def _jax_contrib(jb, vox_lo, vox_ext, halton):
    """The reference's chunk_contrib over the voxels ``vox_lo``."""
    c, n_s = vox_lo.shape[0], halton.shape[0]
    pts = jnp.asarray(vox_lo)[:, None, :] + jnp.asarray(halton)[None, :, :3] \
        * jnp.asarray(vox_ext)
    u = jnp.broadcast_to(jnp.asarray(halton)[None, :, 3:5], (c, n_s, 2))
    probe = JLD._Probe(p=pts, t=jnp.zeros((c, n_s), jnp.float32))
    cols = []
    for j in range(jb.lights.n_lights):
        ls = JL.sample_li(jb.lights, jb.geom,
                          jnp.full((c, n_s), j, jnp.int32), probe, u)
        y = (0.212671 * ls.li[..., 0] + 0.715160 * ls.li[..., 1]
             + 0.072169 * ls.li[..., 2])
        cols.append(jnp.sum(jnp.where(ls.pdf > 0.0,
                                      y / jnp.maximum(ls.pdf, 1e-20), 0.0),
                            axis=1))
    return np.asarray(jnp.stack(cols, -1))


def test_contributions_match():
    jb, pb = _scenes()
    assert pb.lights.n_lights == jb.lights.n_lights == 5
    lo, hi = _bounds(pb)
    rng = np.random.RandomState(0)
    vox_ext = ((hi - lo) / 12).astype(np.float32)
    vox_lo = (lo + rng.randint(0, 12, (600, 3)) * vox_ext).astype(np.float32)
    halton = LD._radical_inverse_table(LD.N_SAMPLES)
    np.testing.assert_array_equal(halton,
                                  JLD._radical_inverse_table(LD.N_SAMPLES))
    got = LD.grid_contrib_plain(pb.lights, torch.as_tensor(vox_lo), vox_ext,
                                torch.as_tensor(halton)).numpy()
    ref = _jax_contrib(jb, vox_lo, vox_ext, halton)
    assert (ref > 0).mean() > 0.5
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * ref.max())


CORNELL_BOUNDS = ([0.0, 0.0, 0.0], [556.0, 548.8, 559.2])
# the dragon scene file's bounds (tools/dragon_scene.py: the ground quad
# and the light)
DRAGON_BOUNDS = ([-12.0, -1.25, -12.0], [12.0, 3.0, 12.0])


def _reference_corners(world_lo, world_hi, max_voxels):
    """The reference's voxel corners (rustracer_tpu/scene/lightdistrib.py
    build_spatial_grid: meshgrid coordinates in C order times the voxel
    extent, plus the lower corner, in numpy float32)."""
    world_lo = np.asarray(world_lo, np.float32)
    world_hi = np.asarray(world_hi, np.float32)
    diag = np.maximum(world_hi - world_lo, 1e-6)
    nv = np.maximum(1, np.round(diag / float(diag.max()) * max_voxels)
                    ).astype(np.int64)
    coords = np.stack(np.meshgrid(np.arange(nv[0]), np.arange(nv[1]),
                                  np.arange(nv[2]), indexing="ij"),
                      -1).reshape(-1, 3).astype(np.float32)
    vox_ext = (diag / nv).astype(np.float32)
    return nv, vox_ext, world_lo + coords * vox_ext


@pytest.mark.parametrize("bounds,max_voxels", [
    (CORNELL_BOUNDS, LD.MAX_VOXELS), (DRAGON_BOUNDS, LD.MAX_VOXELS),
    (([-0.3, 2.1, 5.0], [0.41, 2.2, 9.7]), 13)],
    ids=["cornell", "dragon file", "odd"])
def test_voxel_corners_from_flat_index(bounds, max_voxels):
    lo, hi = bounds
    nv_ref, ext_ref, corners = _reference_corners(lo, hi, max_voxels)
    nv, _, ext = LD.voxels(lo, hi, max_voxels)
    np.testing.assert_array_equal(nv, nv_ref)
    np.testing.assert_array_equal(ext, ext_ref)
    v = corners.shape[0]
    assert v == int(np.prod(nv))
    got = torch.cat([LD.voxel_corners(lo, ext, nv, s, min(s + 5000, v))
                     for s in range(0, v, 5000)]).numpy()
    np.testing.assert_array_equal(got.view(np.int32), corners.view(np.int32))


def test_grid_contrib_whole_grid_equals_corner_sums():
    """The whole grid through ``grid_contrib`` (corners from flat indices,
    chunked) equals the sums over the reference's corners, and its chunk
    size does not change them."""
    _, pb = _scenes()
    lo, hi = _bounds(pb)
    nv, ext, corners = _reference_corners(lo, hi, 9)
    halton = torch.as_tensor(LD._radical_inverse_table(LD.N_SAMPLES))
    got = LD.grid_contrib(pb.lights, lo, ext, nv, halton)
    ref = LD.grid_contrib_plain(pb.lights, torch.as_tensor(corners), ext,
                                halton)
    assert got.shape == (int(np.prod(nv)), pb.lights.n_lights)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    small = LD.grid_contrib_all_plain(pb.lights, lo, ext, nv, halton,
                                      chunk_voxels=97)
    assert torch.equal(small.view(torch.int32), got.view(torch.int32))


def _grids():
    jb, pb = _scenes()
    lo, hi = _bounds(pb)
    jgrid = JLD.build_spatial_grid(jb.lights, jb.geom, lo, hi,
                                   max_voxels=MAX_VOXELS)
    grid = LD.build_spatial_grid(pb.lights, lo, hi, max_voxels=MAX_VOXELS)
    return jgrid, grid, lo, hi


def test_grid_tables_and_picks():
    jgrid, grid, lo, hi = _grids()
    conv = convert.light_grid_from_jax(jgrid, device="cpu")
    for a, b in zip(conv.host, grid.host):
        np.testing.assert_array_equal(a, b)
    for f in ("world_lo", "world_inv_ext", "n_voxels", "strides"):
        assert torch.equal(getattr(conv, f), getattr(grid, f))
    np.testing.assert_allclose(grid.pmf.numpy(), conv.pmf.numpy(), rtol=1e-5)
    np.testing.assert_allclose(grid.cdf.numpy(), conv.cdf.numpy(), rtol=1e-5)
    assert grid.pmf.shape[0] == int(np.prod(grid.host[2])) > 1000

    rng = np.random.RandomState(1)
    n = 1 << 14
    p = (lo - 0.2 + rng.rand(n, 3) * (hi - lo + 0.4)).astype(np.float32)
    u = rng.rand(n).astype(np.float32)
    pt = torch.as_tensor(p)
    # 64 lanes whose u is one of their own voxel's cdf entries: a tie
    flat = LD.voxel_index(conv, pt)
    u[:64] = conv.cdf.numpy()[flat[:64].numpy(), rng.randint(0, 4, 64)]
    ut = torch.as_tensor(u)
    jlid, jpmf = JLD.sample_light(jgrid, jnp.asarray(p), jnp.asarray(u))
    jlid, jpmf = np.asarray(jlid), np.asarray(jpmf)
    lid, pmf = LD.sample_light(conv, pt, ut)
    np.testing.assert_array_equal(lid.numpy(), jlid)
    np.testing.assert_array_equal(pmf.numpy(), jpmf)
    lid_q = torch.as_tensor(rng.randint(-1, 6, n).astype(np.int32))
    np.testing.assert_array_equal(
        LD.pmf_lookup(conv, pt, lid_q).numpy(),
        np.asarray(JLD.pmf_lookup(jgrid, jnp.asarray(p),
                                  jnp.asarray(lid_q.numpy()))))
    # the port's own grid: picks differ only near a cdf entry
    lid2, pmf2 = LD.sample_light(grid, pt, ut)
    near = (torch.abs(ut[:, None] - conv.cdf[flat]) < 1e-5).any(-1).numpy()
    differ = lid2.numpy() != jlid
    print(f"lanes within 1e-5 of a cdf entry: {int(near.sum())} of {n} "
          f"({int(near[64:].sum())} besides the 64 ties); picks that "
          f"differ: {int(differ.sum())}")
    assert near[:64].all() and int(near[64:].sum()) == NEAR_OTHERS
    assert not differ[~near].any()
    same = ~differ
    np.testing.assert_allclose(pmf2.numpy()[same], jpmf[same], rtol=1e-5)
