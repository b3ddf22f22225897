"""Carry the JAX package's scene state over to the port.

Each function takes an object of the JAX package (its arrays are read with
``np.asarray``; this module imports no JAX) and returns the port's
counterpart on ``device``, so both packages render from identical tables.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.bvh_build import build_wide_arrays
from .render.camera import PerspectiveCamera
from .render.film import Film
from .render.filters import Filter
from .render.sampler import SamplerConfig
from .core.sampling import Distribution1D, Distribution2D
from .scene import lights as L
from .scene.lightdistrib import SpatialLightGrid
from .scene.lights import LIGHT_AREA, LightTables
from .scene import materials as M
from .scene.tables import QUADRIC_KEYS, GeometryTables
from .scene.textures import (CheckerboardTexture, ConstantTexture,
                             ImageTexture, UVMapping2D)


def _t(x, dtype, device):
    # a copy: arrays read from JAX are not writable
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def geometry_from_jax(geom, device="cuda") -> GeometryTables:
    """JAX GeometryTables of a scene of triangles and quadrics -> port's.
    A scene the JAX package intersects without a wide BVH (8 primitives
    or fewer) gets the port's own over its triangles."""
    if np.asarray(geom.inst_o2w).shape[0] > 1:
        raise NotImplementedError("instancing is not ported")
    if np.asarray(geom.alpha_atlas).shape[0] > 1:
        raise NotImplementedError("alpha cutouts are not ported")
    if np.asarray(geom.iface_flag).shape[0] > 0:
        raise NotImplementedError("medium interfaces are not ported")
    table = np.asarray(geom.bvh16_table)
    if table.shape[0] > 1:
        bvh = dict(bvh16_table=table, bvh16_roots=geom.bvh16_roots,
                   bvh16_depth=np.asarray(geom.bvh16_depth_pad).shape[0])
    else:
        bvh = build_wide_arrays(np.asarray(geom.tv_p), np.asarray(geom.t_idx))
    q = {k: np.array(getattr(geom, k)) for k in QUADRIC_KEYS}
    return GeometryTables(
        tv_p=_t(geom.tv_p, torch.float32, device),
        t_idx=_t(geom.t_idx, torch.int32, device),
        t_reverse=_t(geom.t_reverse, torch.bool, device),
        t_shade=_t(geom.t_shade, torch.float32, device),
        bvh16_table=_t(bvh["bvh16_table"], torch.float32, device),
        bvh16_roots=_t(bvh["bvh16_roots"], torch.int32, device),
        bvh16_depth=int(bvh["bvh16_depth"]),
        q_type=_t(q["q_type"], torch.int32, device),
        q_o2w=_t(q["q_o2w"], torch.float32, device),
        q_w2o=_t(q["q_w2o"], torch.float32, device),
        q_params=_t(q["q_params"], torch.float32, device),
        q_material=_t(q["q_material"], torch.int32, device),
        q_arealight=_t(q["q_arealight"], torch.int32, device),
        q_reverse=_t(q["q_reverse"], torch.bool, device))


def lights_from_jax(lt, geom=None, device="cuda") -> LightTables:
    """JAX LightTables built with ``geom=`` (the per-light precompute), of
    any light types, with its infinite lights' maps and distributions ->
    port's. An area light on a quadric takes its quadric's rows from
    ``geom`` (the JAX GeometryTables the lights were built on)."""
    if np.asarray(lt.pre_flag).shape[0] == 0:
        raise NotImplementedError("only precomputed light tables are ported")
    l_type = np.array(lt.l_type, np.int32)
    l_prim = np.array(lt.l_prim, np.int32)
    l_emit = np.array(lt.l_emit, np.float32)
    area = l_type == LIGHT_AREA
    if geom is not None:
        pre = L.area_precompute(l_type, l_prim, L.geom_arrays(geom))
    else:
        if np.any(area & ~np.asarray(lt.l_tri_p).any(axis=(1, 2))):
            raise ValueError("an area light on a quadric: pass geom")
        pre = L.area_precompute(np.where(area, -1, l_type), l_prim,
                                dict(n_quadrics=0))
    # the JAX package's own precompute, bit for bit
    pre.update(l_area=np.array(lt.l_area, np.float32),
               l_tri_p=np.array(lt.l_tri_p, np.float32),
               l_tri_rev=np.array(lt.l_tri_rev, bool))
    dists = [Distribution2D(
        *(Distribution1D(*(torch.as_tensor(np.array(a, np.float32))
                           for a in x)) for x in (d.conditional, d.marginal)))
        for d in lt.inf_dists]
    return LightTables(
        **L.light_tensors(l_type, np.array(lt.l_pos, np.float32), l_emit,
                          l_prim, np.array(lt.l_twosided, bool), pre,
                          np.asarray(lt.world_center),
                          float(np.asarray(lt.world_radius)), device),
        **L.infinite_tensors(
            [np.array(m, np.float32) for m in lt.inf_maps], dists,
            list(np.array(lt.inf_l2w, np.float32)),
            list(np.array(lt.inf_w2l, np.float32)),
            [int(r) for r in np.asarray(lt.inf_rows)], l_emit, device))


def light_grid_from_jax(grid, device="cuda") -> SpatialLightGrid:
    """JAX SpatialLightGrid -> port's (the same tables)."""
    lo, inv_ext, nv = (np.array(x) for x in (grid.world_lo,
                                             grid.world_inv_ext,
                                             grid.n_voxels))
    return SpatialLightGrid(
        world_lo=_t(lo, torch.float32, device),
        world_inv_ext=_t(inv_ext, torch.float32, device),
        n_voxels=_t(nv, torch.int32, device),
        strides=_t(grid.strides, torch.int32, device),
        pmf=_t(grid.pmf, torch.float32, device),
        cdf=_t(grid.cdf, torch.float32, device),
        host=(lo.astype(np.float32), inv_ext.astype(np.float32),
              nv.astype(np.int32)))


def film_from_jax(film) -> Film:
    """JAX Film (any filter, scale, crop window) -> port's."""
    f = film.filter
    return Film(full_resolution=tuple(film.full_resolution),
                crop_window=tuple(film.crop_window),
                filter=Filter(f.kind, f.xwidth, f.ywidth, alpha=f.alpha,
                              b=f.b, c=f.c),
                filename=film.filename, scale=film.scale,
                max_sample_luminance=film.max_sample_luminance,
                diagonal=film.diagonal)


def textures_from_jax(textures, device="cuda",
                      requires_grad=False) -> dict:
    """{"const": {key: array}, "images": [pyramid], "atlas_meta",
    "atlas_levels"} -> the same dict of tensors (float32 values, int32
    atlas metadata); keys the JAX dict lacks stay absent. With
    ``requires_grad`` the float leaves (the constants and every pyramid
    level) are leaves that require grad."""
    def leaf(v):
        return _t(v, torch.float32, device).requires_grad_(requires_grad)

    out = {"const": {k: leaf(v) for k, v in textures["const"].items()}}
    if "images" in textures:
        out["images"] = [[leaf(lv) for lv in pyr]
                         for pyr in textures["images"]]
    for key in ("atlas_meta", "atlas_levels"):
        if key in textures:
            out[key] = _t(textures[key], torch.int32, device)
    return out


def _uv_mapping(m):
    if type(m).__name__ != "UVMapping2D":
        raise NotImplementedError(f"mapping {type(m).__name__} is not ported")
    return UVMapping2D(m.su, m.sv, m.du, m.dv)


def _texture_from_jax(tex):
    kind = type(tex).__name__
    if kind == "ConstantTexture":
        return ConstantTexture(tex.key)
    if kind == "CheckerboardTexture":
        return CheckerboardTexture(_texture_from_jax(tex.tex1),
                                   _texture_from_jax(tex.tex2),
                                   _uv_mapping(tex.mapping), aa=tex.aa,
                                   is_spectrum=tex.is_spectrum)
    if kind == "ImageTexture":
        return ImageTexture(tex.image_id, _uv_mapping(tex.mapping),
                            trilinear=tex.trilinear, max_aniso=tex.max_aniso,
                            wrap=tex.wrap, scale=tex.scale,
                            is_spectrum=tex.is_spectrum)
    raise NotImplementedError(f"texture {kind} is not ported")


def _zero_sigma(sigma, textures) -> bool:
    """A parsed matte's sigma: a constant texture whose value (in the JAX
    textures dict) is 0, the Lambertian lobe."""
    return (textures is not None
            and type(sigma).__name__ == "ConstantTexture"
            and np.asarray(textures["const"][sigma.key]).size == 1
            and float(np.asarray(textures["const"][sigma.key])) == 0.0)


def _opt_texture(tex):
    return None if tex is None else _texture_from_jax(tex)


# the texture attributes of each material (both packages name them alike)
_MATERIAL_TEXTURES = {
    "PlasticMaterial": ("kd", "ks", "roughness"),
    "MirrorMaterial": ("kr",),
    "GlassMaterial": ("kr", "kt", "index", "urough", "vrough"),
    "MetalMaterial": ("eta", "k", "roughness", "urough", "vrough"),
    "SubstrateMaterial": ("kd", "ks", "urough", "vrough"),
    "TranslucentMaterial": ("kd", "ks", "roughness", "reflect", "transmit"),
    "UberMaterial": ("kd", "ks", "kr", "kt", "roughness", "urough", "vrough",
                     "opacity", "eta"),
    "DisneyMaterial": ("color", "metallic", "eta", "roughness",
                       "specular_tint", "anisotropic", "sheen", "sheen_tint",
                       "clearcoat", "clearcoat_gloss", "spec_trans",
                       "flatness", "diff_trans"),
}


def _material_from_jax(m, textures, memo):
    """The port's material for the JAX one ``m``; a material held by a mix
    and by the set is converted once (``memo``: id -> port material)."""
    if id(m) in memo:
        return memo[id(m)]
    kind = type(m).__name__
    if m.bump_tex is not None:
        raise NotImplementedError(f"material {kind} with a bump map is not "
                                  "ported")
    if kind == "MatteMaterial":
        sigma = None if m.sigma is None or _zero_sigma(m.sigma, textures) \
            else _texture_from_jax(m.sigma)
        out = M.MatteMaterial(kd=_texture_from_jax(m.kd), sigma=sigma)
    elif kind == "MixMaterial":
        out = M.MixMaterial(_material_from_jax(m.m1, textures, memo),
                            _material_from_jax(m.m2, textures, memo),
                            _texture_from_jax(m.amount))
    elif kind in _MATERIAL_TEXTURES:
        kw = {k: _opt_texture(getattr(m, k)) for k in _MATERIAL_TEXTURES[kind]}
        if kind == "DisneyMaterial":
            kw["thin"] = m.thin
        elif kind != "MirrorMaterial":
            kw["remap_roughness"] = m.remap
        out = getattr(M, kind)(**kw)
    else:
        raise NotImplementedError(f"material {kind} is not ported")
    memo[id(m)] = out
    return out


def material_set_from_jax(ms, textures=None) -> M.MaterialSet:
    """JAX MaterialSet of matte (with sigma), plastic, mirror, glass,
    metal, substrate, translucent, uber, Disney and mix materials over
    constant, checkerboard or UV-mapped image textures -> port's; raises on
    anything else (and on a bump map). A mix's materials are the set's own
    where the set holds them. A parsed scene's mattes carry a sigma
    texture: with the JAX ``textures`` dict given, a sigma that is the
    constant 0 is the Lambertian lobe."""
    memo = {}
    return M.MaterialSet([_material_from_jax(m, textures, memo)
                          for m in ms.materials])


def camera_from_jax(cam) -> PerspectiveCamera:
    """JAX PerspectiveCamera (pinhole or thin lens) -> port's."""
    return PerspectiveCamera(
        camera_to_world=np.asarray(cam.camera_to_world, np.float32),
        raster_to_camera=np.asarray(cam.raster_to_camera, np.float32),
        lens_radius=float(cam.lens_radius),
        focal_distance=float(cam.focal_distance),
        shutter_open=float(cam.shutter_open),
        shutter_close=float(cam.shutter_close))


def sampler_from_jax(cfg) -> SamplerConfig:
    return SamplerConfig(kind=cfg.kind, spp=cfg.spp, seed=cfg.seed)
