"""Port parity of the sharded render: ``rustracer_tpu_torch.parallel.mesh``
render_sharded on 4 gloo ranks of the CPU (parallel/launch.py spawn)
against the JAX package's render_sharded on a 2 x 2 mesh of its virtual
CPU devices, and the port's 4 x 1 and 2 x 2 factorisations and one-device
Renderer against each other.

Scene: the Cornell box at 16^2, 2 spp, depth 3, once with constant walls
and once with the red and green walls as atlas imagemaps (8x8 pyramids of
a seeded numpy noise, tests/helpers.py cornell_imagemap_materials); both
packages walk the same wide BVH of the same triangles. Global tiles of
100 lanes, so the last tile is padded and one 4 x 1 rank's block of it
holds no valid lane. Bound: rtol 2e-5, atol 2e-6 (tests/test_mesh.py:78:
the same samples, only the order of float sums differs)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import cornell_camera, cornell_imagemap_materials
from rustracer_tpu_torch.parallel.launch import spawn
from rustracer_tpu_torch.parallel.ranks import mesh_job
from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
from rustracer_tpu_torch.scenes import (CORNELL_KD, build_cornell,
                                        cornell_tris)

torch.set_num_threads(1)

RES = (16, 16)
SPP = 2
DEPTH = 3
TILE = 100
WALLS = {"const": (), "atlas-imagemaps": (1, 2)}


def jax_scene(walls, res=RES, spp=SPP, depth=DEPTH):
    """The JAX package's Cornell box over the port's triangles and the
    JAX wide BVH of them (what the port builds), its walls ``walls`` atlas
    imagemaps -> (ctx, camera, film, sampler, integrator)."""
    from rustracer_tpu.accel.wide import build_wide_arrays
    from rustracer_tpu.integrators.path import PathIntegrator
    from rustracer_tpu.render.film import Film
    from rustracer_tpu.render.filters import Filter
    from rustracer_tpu.render.renderer import RenderContext
    from rustracer_tpu.render.sampler import SamplerConfig
    from rustracer_tpu.scene.lights import LIGHT_AREA, make_lights
    from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
    from rustracer_tpu.scene.tables import make_geometry
    from rustracer_tpu.scene.textures import ConstantTexture

    tris, first = cornell_tris()
    geom = make_geometry(tris=tris,
                         bvh=build_wide_arrays(copy.deepcopy(tris)))
    rows = [dict(type=LIGHT_AREA, pos=(0, 0, 0), emit=(15.0, 15.0, 15.0),
                 prim=1 + first + k, twosided=False) for k in range(2)]
    lights = make_lights(rows, world_center=(0.5, 0.5, 0.5),
                         world_radius=1.0, geom=geom)
    if walls:
        ms, textures = cornell_imagemap_materials(seed_base=10,
                                                  imagemap_walls=walls)
    else:
        ms = MaterialSet()
        const = {}
        for i, a in enumerate(CORNELL_KD):
            const[f"kd{i}"] = jnp.asarray(a, jnp.float32)
            ms.add(MatteMaterial(kd=ConstantTexture(f"kd{i}")))
        textures = {"const": const, "images": []}
    return (RenderContext(geom=geom, lights=lights, textures=textures),
            cornell_camera(res),
            Film(full_resolution=res, filter=Filter("box", 0.5, 0.5)),
            SamplerConfig(kind="02sequence", spp=spp),
            PathIntegrator(mat_set=ms, max_depth=depth))


def port_kw(walls):
    return dict(res=RES, spp=SPP, max_depth=DEPTH, imagemap_walls=walls)


@pytest.fixture(scope="module")
def port_images():
    """{case: {shape: image}} of render_sharded on 4 gloo ranks; every
    rank's image the same bits."""
    shapes = {"const": [(2, 2), (4, 1)], "atlas-imagemaps": [(2, 2)]}
    tasks = [dict(build=build_cornell, kw=port_kw(WALLS[case]),
                  renders=[dict(shape=s, max_lanes=TILE)
                           for s in shapes[case]])
             for case in shapes]
    out = spawn(mesh_job, 4, tasks, device="cpu", timeout=120)
    for rank in out[1:]:
        for task, task0 in zip(rank, out[0]):
            for r, r0 in zip(task["renders"], task0["renders"]):
                assert torch.equal(r["image"], r0["image"])
    return {case: {s: r["image"].numpy()
                   for s, r in zip(shapes[case], task["renders"])}
            for case, task in zip(shapes, out[0])}


@pytest.mark.parametrize("case", list(WALLS))
def test_render_sharded_matches_jax(case, port_images):
    from rustracer_tpu.parallel.mesh import make_device_mesh, render_sharded
    ctx, cam, film, sampler, integ = jax_scene(WALLS[case])
    mesh = make_device_mesh(data=2, sample=2, devices=jax.devices()[:4])
    ref = np.asarray(render_sharded(ctx, integ.li, cam, film, sampler, mesh,
                                    max_lanes=TILE))
    img = port_images[case][(2, 2)]
    assert np.isfinite(img).all() and img.mean() > 1e-3
    print(f"{case}: max |port - JAX| {np.abs(img - ref).max():.3g}")
    np.testing.assert_allclose(img, ref, rtol=2e-5, atol=2e-6)


def test_mesh_shapes_agree(port_images):
    """4 x 1, 2 x 2 and the one-device Renderer give one image."""
    ctx, cam, film, sampler, integ = build_cornell(**port_kw(()),
                                                   device="cpu")
    one = Renderer(integ.li, cam, film, sampler,
                   RenderConfig(max_lanes=TILE, collect_stats=False),
                   device="cpu").render(ctx).numpy()
    imgs = port_images["const"]
    np.testing.assert_allclose(imgs[(4, 1)], imgs[(2, 2)], rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(imgs[(2, 2)], one, rtol=2e-5, atol=2e-6)


def test_spp_must_divide_by_the_sample_axis():
    """spp 1 on a 1 x 2 mesh (the (0,2) sampler rounds spp up to a power
    of two): every rank raises, and the error ends the run (no rank waits
    on a peer)."""
    task = dict(build=build_cornell, kw=dict(res=(8, 8), spp=1, max_depth=2),
                renders=[dict(shape=(1, 2), max_lanes=TILE)])
    with pytest.raises(Exception, match=r"spp 1 .*sample axis 2"):
        spawn(mesh_job, 2, [task], device="cpu", timeout=60)
