"""Scenes of the port: the benchmark dragon of ``bench.py`` build_dragon,
the Cornell box of ``bench.py`` build_cornell (``build_cornell``), and the
instanced gallery of ``tools/gen_instanced_gallery.py`` (``build_instanced``).

Both variants share the geometry (the 327,680-triangle bumpy sphere that
stands in for the dragon scan, a ground quad and a two-triangle area
light), a look-at camera with fov 42, the box 0.5 filter, the
(0,2)-sequence sampler and path tracing to depth 5:

- ``build_dragon`` is the headline config (``dragon_fwd_rays_per_s``): the
  hero mesh carries a 128^2 marbled imagemap served through the shared
  atlas, and the config is 64 spp (timed on an 8-sample slice, so render
  with ``sample_stop=8``: the spp sets the ray-differential scale);
- ``build_dragon_matte`` is its constant-matte variant
  (``dragon_matte_fwd_rays_per_s``).

The PLY round trip of the reference is left out.

The Cornell box (``tests/helpers.py`` cornell_box and cornell_camera,
``bench.py`` build_cornell) is built from triangles only, through the
port's ``make_geometry``, so it renders through the wide BVH (K1); the
JAX bench's brute-force Cornell and a wide-BVH one render the same.
``imagemap_walls`` serves the given wall materials as atlas imagemaps (the
8x8 noisy pyramids of ``tests/helpers.py`` cornell_imagemap_materials).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.transform import Transform
from .integrators.path import PathIntegrator
from .render.camera import PerspectiveCamera
from .render.film import Film
from .render.filters import Filter
from .render.renderer import RenderContext
from .render.sampler import SamplerConfig
from .ops.mipmap import build_pyramid
from .scene.atlas import build_atlas_meta
from .scene.lights import LIGHT_AREA, make_lights
from .scene.materials import MaterialSet, MatteMaterial
from .accel.bvh_build import build_wide_scene
from .scene.tables import N_DUMMY_QUADRICS, make_geometry
from .scene.textures import ConstantTexture, ImageTexture
from .utils.meshgen import bumpy_sphere

MAX_DEPTH = 5
DRAGON_SPP = 64      # the headline config's spp (bench.py DRAGON_SPP)
CORNELL_RES = (256, 256)
CORNELL_SPP = 16
# the Cornell's matte albedos: white, red (left), green (right), black
CORNELL_KD = ([0.73] * 3, [0.63, 0.065, 0.05], [0.14, 0.45, 0.09], [0.0] * 3)


def dragon_tris(sub=7):
    """Host triangle tables of the dragon scene -> (tris dict, n_mesh)."""
    mv, mn, mf = bumpy_sphere(subdivisions=sub, radius=1.0)
    n_mesh = mf.shape[0]
    extra_v = np.array([
        [-12, -1.25, -12], [12, -1.25, -12], [12, -1.25, 12], [-12, -1.25, 12],
        # light: 2x2 quad at y=3.0, wound so its normal points -y
        [-1, 3.0, -1], [1, 3.0, -1], [1, 3.0, 1], [-1, 3.0, 1],
    ], np.float32)
    base = mv.shape[0]
    extra_f = np.array([
        [base, base + 1, base + 2], [base, base + 2, base + 3],          # ground
        [base + 4, base + 5, base + 6], [base + 4, base + 6, base + 7],  # light
    ], np.int32)
    # spherical uv on the hero mesh
    uv_mesh = np.stack(
        [np.arctan2(mv[:, 2], mv[:, 0]) / (2 * np.pi) + 0.5,
         np.arccos(np.clip(mv[:, 1] /
                           np.maximum(np.linalg.norm(mv, axis=1), 1e-9),
                           -1, 1)) / np.pi], -1).astype(np.float32)
    tv_p = np.concatenate([mv, extra_v])
    n_tris = n_mesh + 4
    tris = dict(
        tv_p=tv_p,
        tv_n=np.concatenate([mn, np.zeros((8, 3), np.float32)]),
        tv_uv=np.concatenate([uv_mesh, np.zeros((8, 2), np.float32)]),
        tv_s=np.zeros_like(tv_p),
        t_idx=np.concatenate([mf, extra_f]),
        t_material=np.concatenate([np.full(n_mesh, 1, np.int32),
                                   np.array([0, 0, 2, 2], np.int32)]),
        t_arealight=np.concatenate([np.full(n_mesh + 2, -1, np.int32),
                                    np.array([0, 1], np.int32)]),
        t_reverse=np.zeros(n_tris, bool),
        t_has_n=np.concatenate([np.ones(n_mesh, bool), np.zeros(4, bool)]),
        t_has_uv=np.concatenate([np.ones(n_mesh, bool), np.zeros(4, bool)]),
        t_alpha_tex=np.full(n_tris, -1, np.int32),
    )
    return tris, n_mesh


def dragon_light_rows(n_mesh):
    emit = (18.0, 18.0, 18.0)
    first = N_DUMMY_QUADRICS + n_mesh + 2
    return [dict(type=LIGHT_AREA, emit=emit, prim=first + k, twosided=False)
            for k in range(2)]


def dragon_materials():
    """-> (MaterialSet, constant texture values as float32 numpy)."""
    const = {"kd_floor": np.array([0.6, 0.6, 0.6], np.float32),
             "kd_dragon": np.array([0.55, 0.45, 0.35], np.float32),
             "kd_black": np.array([0.0, 0.0, 0.0], np.float32)}
    ms = MaterialSet([MatteMaterial(kd=ConstantTexture(k))
                      for k in ("kd_floor", "kd_dragon", "kd_black")])
    return ms, const


def dragon_camera(res):
    c2w = Transform.look_at([0.0, 1.1, -3.4], [0.0, 0.0, 0.0], [0, 1, 0])
    return PerspectiveCamera.create(c2w, fov=42.0, resolution=res)


def hero_texture():
    """The hero mesh's 128^2 marbled albedo as bench.py builds it.
    -> (images [pyramid of float32 levels], build_atlas_meta dict)."""
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float32) / 128.0
    tex = np.stack([0.45 + 0.25 * np.sin(14 * xx + 5 * np.sin(3 * yy)),
                    0.40 + 0.15 * np.sin(11 * yy + 4 * np.sin(5 * xx)),
                    0.32 + 0.10 * np.cos(9 * (xx + yy))], -1)
    images = [build_pyramid(tex.astype(np.float32))]
    return images, build_atlas_meta(images)


def dragon_materials_textured():
    """-> (MaterialSet: floor constant, ImageTexture(0), black constant;
    constant texture values as float32 numpy)."""
    const = {"kd_floor": np.array([0.6, 0.6, 0.6], np.float32),
             "kd_black": np.array([0.0, 0.0, 0.0], np.float32)}
    ms = MaterialSet([MatteMaterial(kd=ConstantTexture("kd_floor")),
                      MatteMaterial(kd=ImageTexture(0)),
                      MatteMaterial(kd=ConstantTexture("kd_black"))])
    return ms, const


def dragon_geometry(sub=7, device="cuda"):
    """-> (GeometryTables, LightTables, n_tris) of the dragon scene, which
    both variants can share (the SAH build is the costly part)."""
    tris, n_mesh = dragon_tris(sub)
    geom = make_geometry(tris, device=device)
    lights = make_lights(dragon_light_rows(n_mesh), geom, device=device)
    return geom, lights, n_mesh + 4


def _dragon(textures, ms, res, spp, device, crop_window, geometry, sub):
    geom, lights, n_tris = geometry or dragon_geometry(sub, device)
    ctx = RenderContext(geom=geom, lights=lights, textures=textures)
    film = Film(full_resolution=res, crop_window=crop_window,
                filter=Filter("box", 0.5, 0.5))
    return (ctx, dragon_camera(res), film,
            SamplerConfig(kind="02sequence", spp=spp),
            PathIntegrator(mat_set=ms, max_depth=MAX_DEPTH), n_tris)


def build_dragon_matte(sub=7, res=(1024, 1024), spp=8, device="cuda",
                       crop_window=(0.0, 0.0, 1.0, 1.0), geometry=None):
    """-> (ctx, camera, film, sampler, integrator, n_tris) on ``device``;
    ``geometry`` is a ``dragon_geometry`` result to share."""
    ms, const = dragon_materials()
    return _dragon(textures_on({"const": const}, device), ms, res, spp,
                   device, crop_window, geometry, sub)


def build_dragon(sub=7, res=(1024, 1024), spp=DRAGON_SPP, device="cuda",
                 crop_window=(0.0, 0.0, 1.0, 1.0), geometry=None):
    """The textured headline dragon -> (ctx, camera, film, sampler,
    integrator, n_tris) on ``device``; ``geometry`` as build_dragon_matte.
    ``ctx.textures`` carries the pyramids (``images``), ``atlas_meta`` and
    ``atlas_levels``."""
    ms, const = dragon_materials_textured()
    images, meta = hero_texture()
    textures = textures_on(dict(const=const, images=images, **meta), device)
    return _dragon(textures, ms, res, spp, device, crop_window, geometry,
                   sub)


def _quad(tris, p00, p10, p11, p01, material=0, arealight=-1):
    """Two triangles (p00, p10, p11) and (p00, p11, p01) into ``tris``
    (lists), uv (0,0) (1,0) (1,1) (0,1); -> the first triangle's index."""
    base = len(tris["v"])
    tris["v"] += [p00, p10, p11, p01]
    tris["uv"] += [(0, 0), (1, 0), (1, 1), (0, 1)]
    tris["idx"] += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    tris["mat"] += [material, material]
    tris["al"] += [arealight, arealight]
    return len(tris["idx"]) - 2


def cornell_tris():
    """Host triangle tables of the Cornell box in [0, 1]^3 (tests/helpers.py
    cornell_box): materials 0 white (floor, ceiling, back wall), 1 red
    (left wall), 2 green (right wall), 3 the light's black matte; the light
    is a small quad under the ceiling facing down, area lights 0 and 1.
    -> (tris dict, the light's first triangle)."""
    t = {"v": [], "uv": [], "idx": [], "mat": [], "al": []}
    _quad(t, (0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1), 0)    # floor
    _quad(t, (0, 1, 1), (1, 1, 1), (1, 1, 0), (0, 1, 0), 0)    # ceiling
    _quad(t, (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1), 0)    # back
    _quad(t, (0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0), 1)    # left
    _quad(t, (1, 0, 1), (1, 0, 0), (1, 1, 0), (1, 1, 1), 2)    # right
    first = _quad(t, (0.35, 0.999, 0.35), (0.65, 0.999, 0.35),
                  (0.65, 0.999, 0.65), (0.35, 0.999, 0.65), 3)
    t["al"][first], t["al"][first + 1] = 0, 1
    n = len(t["idx"])
    v = np.asarray(t["v"], np.float32)
    return dict(
        tv_p=v, tv_n=np.zeros_like(v),
        tv_uv=np.asarray(t["uv"], np.float32), tv_s=np.zeros_like(v),
        t_idx=np.asarray(t["idx"], np.int32),
        t_material=np.asarray(t["mat"], np.int32),
        t_arealight=np.asarray(t["al"], np.int32),
        t_reverse=np.zeros(n, bool), t_has_n=np.zeros(n, bool),
        t_has_uv=np.ones(n, bool), t_alpha_tex=np.full(n, -1, np.int32),
    ), first


def cornell_box(light_emit=(15.0, 15.0, 15.0), device="cuda"):
    """-> (GeometryTables, LightTables) of the Cornell box."""
    tris, first = cornell_tris()
    geom = make_geometry(tris, device=device)
    rows = [dict(type=LIGHT_AREA, emit=light_emit,
                 prim=N_DUMMY_QUADRICS + first + k, twosided=False)
            for k in range(2)]
    return geom, make_lights(rows, geom, device=device)


def cornell_camera(res=(64, 64)):
    c2w = Transform.look_at([0.5, 0.5, -1.4], [0.5, 0.5, 0.5], [0, 1, 0])
    return PerspectiveCamera.create(c2w, fov=40.0, resolution=res)


def cornell_materials(imagemap_walls=(), seed_base=10):
    """-> (MaterialSet, textures dict of numpy arrays): the four mattes,
    those in ``imagemap_walls`` served as atlas imagemaps (8x8 noisy
    pyramids of their albedo, tests/helpers.py
    cornell_imagemap_materials); "images" always present, "atlas_meta" and
    "atlas_levels" when there are imagemaps."""
    ms = MaterialSet()
    const, images = {}, []
    for i, a in enumerate(CORNELL_KD):
        const[f"kd{i}"] = np.asarray(a, np.float32)
        if i in imagemap_walls:
            rng = np.random.RandomState(seed_base + i)
            img = (np.asarray(a, np.float32)[None, None]
                   * (0.6 + 0.4 * rng.rand(8, 8, 3))).astype(np.float32)
            images.append(build_pyramid(img))
            ms.add(MatteMaterial(kd=ImageTexture(len(images) - 1)))
        else:
            ms.add(MatteMaterial(kd=ConstantTexture(f"kd{i}")))
    textures = {"const": const, "images": images}
    if images:
        am = build_atlas_meta(images)
        textures["atlas_meta"] = am["atlas_meta"]
        textures["atlas_levels"] = am["atlas_levels"]
    return ms, textures


def textures_on(textures, device):
    """A textures dict of numpy arrays ("const", optional "images",
    "atlas_meta", "atlas_levels" and "fourier", a FourierTableSet) as
    tensors on ``device``."""
    out = {"const": {k: torch.as_tensor(v, device=device)
                     for k, v in textures["const"].items()}}
    if "images" in textures:
        out["images"] = [[torch.as_tensor(lv, device=device) for lv in pyr]
                         for pyr in textures["images"]]
    for key in ("atlas_meta", "atlas_levels"):
        if key in textures:
            out[key] = torch.as_tensor(textures[key], device=device)
    if "fourier" in textures:
        out["fourier"] = textures["fourier"].to(device)
    return out


def build_cornell(res=CORNELL_RES, spp=CORNELL_SPP, max_depth=MAX_DEPTH,
                  imagemap_walls=(), device="cuda"):
    """bench.py build_cornell: the Cornell box, box 0.5 filter, (0,2)
    sampler, path tracing -> (ctx, camera, film, sampler, integrator)."""
    geom, lights = cornell_box(device=device)
    ms, textures = cornell_materials(imagemap_walls)
    ctx = RenderContext(geom=geom, lights=lights,
                        textures=textures_on(textures, device))
    film = Film(full_resolution=res, filter=Filter("box", 0.5, 0.5))
    return (ctx, cornell_camera(res), film,
            SamplerConfig(kind="02sequence", spp=spp),
            PathIntegrator(mat_set=ms, max_depth=max_depth))


def instanced_tris(subdiv=6, grid=5):
    """Host tables of the instanced gallery (tools/gen_instanced_gallery.py
    build): a ground quad and a 3 x 3 light quad (world space), then the
    bumpy sphere of radius 0.45 once in object space, placed by grid x grid
    instances (a seeded rotation about y, a scale in [0.8, 1.25], on a
    1.6-spaced grid) -> (tris dict, objects, instances)."""
    mv, mn, mf = bumpy_sphere(subdivisions=subdiv, radius=0.45)
    static_v = np.array([
        [-9, 0, -9], [9, 0, -9], [9, 0, 9], [-9, 0, 9],
        [-1.5, 6.0, -1.5], [1.5, 6.0, -1.5], [1.5, 6.0, 1.5], [-1.5, 6.0, 1.5],
    ], np.float32)
    # the light's two triangles are wound so that their normal points -y
    static_f = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]],
                        np.int32)
    gv = np.concatenate([static_v, mv])
    gi = np.concatenate([static_f, mf + len(static_v)])
    n_static, n_mesh = len(static_f), len(mf)
    n = n_static + n_mesh
    tris = dict(
        tv_p=gv,
        tv_n=np.concatenate([np.zeros((8, 3), np.float32), mn]),
        tv_uv=np.zeros((len(gv), 2), np.float32),
        tv_s=np.zeros((len(gv), 3), np.float32),
        t_idx=gi,
        t_material=np.concatenate([np.array([0, 0, 2, 2], np.int32),
                                   np.full(n_mesh, 1, np.int32)]),
        t_arealight=np.concatenate([np.array([-1, -1, 0, 1], np.int32),
                                    np.full(n_mesh, -1, np.int32)]),
        t_reverse=np.zeros(n, bool),
        t_has_n=np.concatenate([np.zeros(n_static, bool),
                                np.ones(n_mesh, bool)]),
        t_has_uv=np.zeros(n, bool),
        t_alpha_tex=np.full(n, -1, np.int32))
    rng = np.random.default_rng(7)
    instances = []
    for i in range(grid):
        for j in range(grid):
            ang = rng.uniform(0, 2 * np.pi)
            c, s = np.cos(ang), np.sin(ang)
            sc = rng.uniform(0.8, 1.25)
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                 np.float32) * sc
            m[:3, 3] = (1.6 * (i - (grid - 1) / 2), 0.45 * sc + 0.02,
                        1.6 * (j - (grid - 1) / 2))
            instances.append(dict(obj=0, o2w=m, w2o=np.linalg.inv(m),
                                  flip=False))
    return tris, [(n_static, n)], instances


def build_instanced(subdiv=6, res=(1024, 768), spp=16, grid=5,
                    device="cuda"):
    """The instanced gallery (tools/gen_instanced_gallery.py, its flagship:
    25 instances of one 81,920-triangle bumpy sphere, 2.05 M triangles in
    effect) through the two-level BVH, under the two-triangle area light
    (emission 30), matte floor, hero and light, look-at camera with fov 52,
    the box 0.5 filter, the (0,2)-sequence sampler, path tracing to depth
    5 -> (ctx, camera, film, sampler, integrator)."""
    tris, objects, instances = instanced_tris(subdiv, grid)
    geom = make_geometry(tris, bvh=build_wide_scene(tris, objects,
                                                    instances),
                         device=device)
    emit = (30.0, 30.0, 30.0)
    rows = [dict(type=LIGHT_AREA, pos=(0, 0, 0), emit=emit,
                 prim=N_DUMMY_QUADRICS + 2 + k, twosided=False)
            for k in range(2)]
    lights = make_lights(rows, geom, world_center=(0, 1, 0),
                         world_radius=15.0, device=device)
    const = {"kd_floor": np.array([0.55, 0.55, 0.58], np.float32),
             "kd_hero": np.array([0.6, 0.42, 0.3], np.float32),
             "kd_black": np.array([0.0, 0.0, 0.0], np.float32)}
    ms = MaterialSet([MatteMaterial(kd=ConstantTexture(k))
                      for k in ("kd_floor", "kd_hero", "kd_black")])
    ctx = RenderContext(geom=geom, lights=lights,
                        textures=textures_on({"const": const}, device))
    c2w = Transform.look_at([5.5, 5.0, -6.5], [0.0, 0.4, 0.0], [0, 1, 0])
    cam = PerspectiveCamera.create(c2w, fov=52.0, resolution=res)
    film = Film(full_resolution=res, filter=Filter("box", 0.5, 0.5))
    return (ctx, cam, film, SamplerConfig(kind="02sequence", spp=spp),
            PathIntegrator(mat_set=ms, max_depth=MAX_DEPTH))
