"""PBRT directive state machine: directives -> flat scene tables (port of
rustracer_tpu/scene/api.py without JAX).

The state machine (the options and world blocks, the attribute and
transform stacks, named coordinate systems and named materials) and every
directive the parser (scene/parser.py, the reference's copy) calls are the
reference's. Factories append flat records that ``world_end`` freezes into
the port's tables (scene/bundle.py).

What renders: transforms and LookAt; ``Texture`` of class ``constant`` and
``imagemap`` (uv mapping, served through the shared atlas) as float and
spectrum, and the 2D ``checkerboard`` spectrum texture over constant
textures; ``Material`` ``"matte"`` (Oren-Nayar where ``sigma`` is not 0),
``"plastic"``, ``"mirror"``, ``"glass"`` (smooth and rough), ``"metal"``,
``"substrate"``, ``"translucent"``, ``"uber"``, ``"disney"`` (thin too)
and ``"mix"`` (over materials without an image texture);
``Shape "trianglemesh"``,
``"plymesh"``, ``"sphere"``, ``"cylinder"`` and ``"disk"``;
``LightSource`` ``"point"``, ``"distant"`` and ``"infinite"`` (a
latitude-longitude map from ``mapname``, several such lights summed) and
``AreaLightSource "diffuse"`` on triangle meshes and quadrics. Every other
shape, material,
texture, light, instancing and alpha raises NotImplementedError naming the
feature and the ROADMAP.md item (section A) that ports it; nothing is
substituted. The reference's own unimplemented shapes keep its error, and
what it only warns about (an unknown material, texture class, light or
camera) it still only warns about.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional

import numpy as np

from ..core.spectrum import metal_eta_k, srgb_decode_np
from ..core.transform import Transform
from ..ops.mipmap import WRAP_REPEAT, build_pyramid
from ..utils import fileutil
from ..utils.stats import time_phase
from . import atlas as A
from . import materials as M
from . import textures as T
from .lexer import tokenize, tokenize_file
from .lights import LIGHT_DISTANT, LIGHT_POINT
from .paramset import ParamSet, TextureParams
from .parser import parse

log = logging.getLogger(__name__)

STATE_UNINITIALIZED, STATE_OPTIONS, STATE_WORLD = 0, 1, 2

# ROADMAP.md section A items that port what this module refuses
SHADING, GEOMETRY, INTEGRATORS, RUN_SURFACE = 13, 15, 16, 17


class ApiError(Exception):
    pass


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"section A, item {item})")


class TextureRegistry:
    """Constants and image pyramids of the scene's textures, as numpy
    (the keys and their order are the reference's)."""

    def __init__(self):
        self.const: Dict[str, np.ndarray] = {}
        self.images: List[list] = []
        self._n = 0
        self._image_cache: Dict[tuple, int] = {}

    def constant_spectrum(self, value) -> T.ConstantTexture:
        key = f"c{self._n}"
        self._n += 1
        self.const[key] = np.broadcast_to(np.asarray(value, np.float32),
                                          (3,)).copy()
        return T.ConstantTexture(key)

    def constant_float(self, value) -> T.ConstantTexture:
        key = f"c{self._n}"
        self._n += 1
        self.const[key] = np.float32(value)
        return T.ConstantTexture(key)

    def image(self, filename, gamma=None) -> int:
        from ..render.imageio import read_image
        key = (filename, bool(gamma))
        if key in self._image_cache:
            return self._image_cache[key]
        img = read_image(filename)
        if gamma:
            img = srgb_decode_np(img)
        self.images.append(build_pyramid(img))
        idx = len(self.images) - 1
        self._image_cache[key] = idx
        return idx

    def tables(self):
        """{"const", "images"} of numpy arrays."""
        return {"const": dict(self.const), "images": list(self.images)}


@dataclasses.dataclass
class GraphicsState:
    material: str = "matte"
    material_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    named_materials: Dict[str, int] = dataclasses.field(default_factory=dict)
    float_textures: Dict[str, object] = dataclasses.field(default_factory=dict)
    spectrum_textures: Dict[str, object] = dataclasses.field(
        default_factory=dict)
    area_light: str = ""
    area_light_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    reverse_orientation: bool = False
    current_material_id: Optional[int] = None

    def clone(self):
        return dataclasses.replace(
            self, named_materials=dict(self.named_materials),
            float_textures=dict(self.float_textures),
            spectrum_textures=dict(self.spectrum_textures))


@dataclasses.dataclass
class QuadricRecord:
    qtype: int                  # ops/quadrics.py SPHERE, CYLINDER, DISK
    o2w: Transform
    params: np.ndarray          # (4,) float32, ops/quadrics.py's layout
    material: int
    reverse: bool
    arealight_spec: Optional[tuple] = None   # (emit rgb, twosided, nsamples)


@dataclasses.dataclass
class MeshRecord:
    o2w: Transform              # applied at emit time
    p: np.ndarray               # (V, 3) object space
    n: Optional[np.ndarray]
    s: Optional[np.ndarray]
    uv: Optional[np.ndarray]
    indices: np.ndarray         # (T, 3)
    material: int
    arealight_spec: Optional[tuple]   # (emit rgb, twosided, nsamples)
    reverse: bool


@dataclasses.dataclass
class RenderOptions:
    filter_name: str = "box"
    filter_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    film_name: str = "image"
    film_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    sampler_name: str = "02sequence"
    sampler_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    accelerator_name: str = "bvh"
    accelerator_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    integrator_name: str = "path"
    integrator_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    camera_name: str = "perspective"
    camera_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    camera_to_world: Transform = dataclasses.field(default_factory=Transform)
    lights: List[dict] = dataclasses.field(default_factory=list)
    infinite_lights: List[dict] = dataclasses.field(default_factory=list)
    meshes: List[MeshRecord] = dataclasses.field(default_factory=list)
    quadrics: List[QuadricRecord] = dataclasses.field(default_factory=list)


class RealApi:
    """The PBRT directive state machine; ``scene`` is the SceneBundle on
    ``device`` after WorldEnd."""

    def __init__(self, options=None, device="cuda"):
        self.opts = options or {}
        self.device = device
        self.state = STATE_UNINITIALIZED
        self.cur_transform = Transform()
        self.named_coordinate_systems: Dict[str, Transform] = {}
        self.transform_stack: List[Transform] = []
        self.graphics_stack: List[GraphicsState] = []
        self.graphics = GraphicsState()
        self.render_options = RenderOptions()
        self.textures = TextureRegistry()
        self.material_set = M.MaterialSet()
        self.scene = None

    # --- state guards ---
    def _verify_initialized(self, what):
        if self.state == STATE_UNINITIALIZED:
            raise ApiError(f"init() must be called before {what}()")

    def _verify_options(self, what):
        self._verify_initialized(what)
        if self.state == STATE_WORLD:
            raise ApiError(f"{what}() not allowed inside world block")

    def _verify_world(self, what):
        self._verify_initialized(what)
        if self.state == STATE_OPTIONS:
            raise ApiError(f"{what}() only allowed inside world block")

    def init(self):
        if self.state != STATE_UNINITIALIZED:
            raise ApiError("init() called twice")
        self.state = STATE_OPTIONS

    # --- transforms ---
    def identity(self):
        self._verify_initialized("identity")
        self.cur_transform = Transform()

    def translate(self, x, y, z):
        self._verify_initialized("translate")
        self.cur_transform = self.cur_transform * Transform.translate(x, y, z)

    def scale(self, x, y, z):
        self._verify_initialized("scale")
        self.cur_transform = self.cur_transform * Transform.scale(x, y, z)

    def rotate(self, angle, x, y, z):
        self._verify_initialized("rotate")
        self.cur_transform = self.cur_transform * Transform.rotate(angle, x, y,
                                                                   z)

    def look_at(self, eye, look, up):
        self._verify_initialized("look_at")
        # look_at builds camera-to-world; the directive composes the
        # current transform with its inverse (world-to-camera)
        c2w = Transform.look_at(eye, look, up)
        self.cur_transform = self.cur_transform * c2w.inverse()

    def transform(self, m16):
        self._verify_initialized("transform")
        m = np.asarray(m16, np.float32).reshape(4, 4).T  # column-major input
        self.cur_transform = Transform(m)

    def concat_transform(self, m16):
        self._verify_initialized("concat_transform")
        m = np.asarray(m16, np.float32).reshape(4, 4).T
        self.cur_transform = self.cur_transform * Transform(m)

    def coordinate_system(self, name):
        self._verify_initialized("coordinate_system")
        self.named_coordinate_systems[name] = self.cur_transform

    def coord_sys_transform(self, name):
        self._verify_initialized("coord_sys_transform")
        t = self.named_coordinate_systems.get(name)
        if t is None:
            log.warning("unknown coordinate system %r", name)
        else:
            self.cur_transform = t

    # --- option directives ---
    def pixel_filter(self, name, params):
        self._verify_options("pixel_filter")
        self.render_options.filter_name = name
        self.render_options.filter_params = params

    def film(self, name, params):
        self._verify_options("film")
        self.render_options.film_name = name
        self.render_options.film_params = params

    def sampler(self, name, params):
        self._verify_options("sampler")
        self.render_options.sampler_name = name
        self.render_options.sampler_params = params

    def accelerator(self, name, params):
        self._verify_options("accelerator")
        self.render_options.accelerator_name = name
        self.render_options.accelerator_params = params

    def integrator(self, name, params):
        self._verify_options("integrator")
        self.render_options.integrator_name = name
        self.render_options.integrator_params = params

    def camera(self, name, params):
        self._verify_options("camera")
        self.render_options.camera_name = name
        self.render_options.camera_params = params
        self.render_options.camera_to_world = self.cur_transform.inverse()
        self.named_coordinate_systems["camera"] = \
            self.render_options.camera_to_world

    # --- world block ---
    def world_begin(self):
        self._verify_options("world_begin")
        self.state = STATE_WORLD
        self.cur_transform = Transform()
        self.named_coordinate_systems["world"] = Transform()

    def attribute_begin(self):
        self._verify_world("attribute_begin")
        self.graphics_stack.append(self.graphics.clone())
        self.transform_stack.append(self.cur_transform)

    def attribute_end(self):
        self._verify_world("attribute_end")
        if not self.graphics_stack:
            log.error("unmatched AttributeEnd ignored")
            return
        self.graphics = self.graphics_stack.pop()
        self.cur_transform = self.transform_stack.pop()

    def transform_begin(self):
        self._verify_world("transform_begin")
        self.transform_stack.append(self.cur_transform)

    def transform_end(self):
        self._verify_world("transform_end")
        if not self.transform_stack:
            log.error("unmatched TransformEnd ignored")
            return
        self.cur_transform = self.transform_stack.pop()

    def texture(self, name, ty, cls, params):
        self._verify_world("texture")
        tp = self._tp(params)
        if ty == "float":
            tex = self._make_texture(cls, tp, is_spectrum=False)
            if tex is not None:
                self.graphics.float_textures[name] = tex
        elif ty in ("spectrum", "color"):
            tex = self._make_texture(cls, tp, is_spectrum=True)
            if tex is not None:
                self.graphics.spectrum_textures[name] = tex
        else:
            log.error("texture type %r unknown", ty)

    def material(self, name, params):
        self._verify_world("material")
        self.graphics.material = name
        self.graphics.material_params = params
        self.graphics.current_material_id = None  # rebuilt lazily

    def make_named_material(self, name, params):
        self._verify_world("make_named_material")
        ty = params.find_one_string("type", "")
        if not ty:
            log.error("MakeNamedMaterial missing \"type\"")
            ty = "matte"
        self.graphics.named_materials[name] = self._build_material(ty, params)

    def named_material(self, name):
        self._verify_world("named_material")
        mid = self.graphics.named_materials.get(name)
        if mid is None:
            log.error("unknown named material %r", name)
            return
        self.graphics.material = "@named"
        self.graphics.current_material_id = mid

    def lightsource(self, name, params):
        self._verify_world("lightsource")
        ro = self.render_options
        if name == "point":
            i = params.find_one_spectrum("I", (1, 1, 1))
            sc = params.find_one_spectrum("scale", (1, 1, 1))
            p_from = params.find_one_point3f("from", (0, 0, 0))
            p = self.cur_transform.apply_point(p_from)
            ro.lights.append(dict(type=LIGHT_POINT, pos=tuple(p),
                                  emit=tuple(i * sc), prim=-1))
        elif name == "distant":
            l_emit = params.find_one_spectrum("L", (1, 1, 1))
            sc = params.find_one_spectrum("scale", (1, 1, 1))
            p_from = params.find_one_point3f("from", (0, 0, 0))
            p_to = params.find_one_point3f("to", (0, 0, 1))
            w = self.cur_transform.apply_point(p_from) - \
                self.cur_transform.apply_point(p_to)
            w = w / max(np.linalg.norm(w), 1e-12)
            ro.lights.append(dict(type=LIGHT_DISTANT, pos=tuple(w),
                                  emit=tuple(l_emit * sc), prim=-1))
        elif name == "infinite":
            l_emit = params.find_one_spectrum("L", (1, 1, 1))
            sc = params.find_one_spectrum("scale", (1, 1, 1))
            mapname = params.find_one_filename("mapname", "")
            ns = params.find_one_int("nsamples",
                                     params.find_one_int("samples", 1))
            ro.infinite_lights.append(dict(
                scale=tuple(l_emit * sc), mapname=mapname,
                l2w=self.cur_transform.m.copy(), nsamples=max(1, int(ns))))
        else:
            log.error("light type %r unknown (the reference supports point, "
                      "distant, infinite and area lights)", name)

    def arealightsource(self, name, params):
        self._verify_world("arealightsource")
        if name not in ("area", "diffuse"):
            log.error("area light type %r unknown", name)
            return
        self.graphics.area_light = name
        self.graphics.area_light_params = params

    def reverse_orientation(self):
        self._verify_world("reverse_orientation")
        self.graphics.reverse_orientation = \
            not self.graphics.reverse_orientation

    # --- object instancing ---
    def object_begin(self, name):
        self._verify_world("object_begin")
        raise not_ported(f"ObjectBegin {name!r} (instancing)", GEOMETRY)

    def object_end(self):
        self._verify_world("object_end")
        raise not_ported("ObjectEnd (instancing)", GEOMETRY)

    def object_instance(self, name):
        self._verify_world("object_instance")
        raise not_ported(f"ObjectInstance {name!r} (instancing)", GEOMETRY)

    # --- shapes ---
    def shape(self, name, params):
        self._verify_world("shape")
        # the material is built before the shape is looked at, as the
        # reference does (its constants take the next texture keys)
        mid = self._current_material_id()
        al_spec = self._area_light_spec()
        if name in ("cone", "paraboloid", "hyperboloid", "curve",
                    "loopsubdiv", "nurbs", "heightfield"):
            # unimplemented in the reference too
            raise NotImplementedError(f"shape {name!r} is unimplemented "
                                      "(matches reference api.rs:1134)")
        if name not in ("trianglemesh", "plymesh", "sphere", "cylinder",
                        "disk"):
            log.error("shape %r unknown", name)
            return
        if mid < 0 and al_spec is None:
            raise not_ported("a shape with material \"none\" (medium "
                             "interfaces)", GEOMETRY)
        o2w = self.cur_transform
        rev = self.graphics.reverse_orientation ^ o2w.swaps_handedness()
        if name in ("sphere", "cylinder", "disk"):
            self.render_options.quadrics.append(
                QuadricRecord(("sphere", "cylinder", "disk").index(name), o2w,
                              self._quadric_params(name, params), mid, rev,
                              al_spec))
            return
        for alpha in ("alpha", "shadowalpha"):
            if params.has(alpha):
                raise not_ported(f"Shape {name!r} with {alpha!r} (alpha "
                                 "cutouts)", GEOMETRY)
        if name == "trianglemesh":
            idx = params.find_int("indices")
            p = params.find_point3("P")
            if idx is None or p is None:
                log.error("trianglemesh needs indices and P")
                return
            n = params.find_normal3("N")
            s = params.find_vector3("S")
            uv = params.find_point2("uv")
            if uv is None:
                uv = params.find_point2("st")
            rec = MeshRecord(o2w, p, n, s, uv, idx.reshape(-1, 3), mid,
                             al_spec, rev)
        else:
            from ..utils.plyio import read_ply
            fname = params.find_one_filename("filename", "")
            with time_phase("scene/PLY read"):
                p, n, uv, idx = read_ply(fname)
            rec = MeshRecord(o2w, p, n, None, uv, idx, mid, al_spec, rev)
        self.render_options.meshes.append(rec)

    @staticmethod
    def _quadric_params(name, params) -> np.ndarray:
        """The parameter row of a sphere, cylinder or disk with the
        reference's defaults (rustracer_tpu/scene/api.py:484-510): z
        bounds ordered, phimax in radians."""
        phimax = np.deg2rad(params.find_one_float("phimax", 360.0))
        if name == "disk":
            return np.array([params.find_one_float("height", 0.0),
                             params.find_one_float("radius", 1.0),
                             params.find_one_float("innerradius", 0.0),
                             phimax], np.float32)
        r = params.find_one_float("radius", 1.0)
        zmin = params.find_one_float("zmin", -r if name == "sphere" else -1.0)
        zmax = params.find_one_float("zmax", r if name == "sphere" else 1.0)
        return np.array([r, min(zmin, zmax), max(zmin, zmax), phimax],
                        np.float32)

    def _area_light_spec(self):
        if not self.graphics.area_light:
            return None
        ps = self.graphics.area_light_params
        l_emit = ps.find_one_spectrum("L", (1, 1, 1))
        sc = ps.find_one_spectrum("scale", (1, 1, 1))
        two = ps.find_one_bool("twosided", False)
        ns = ps.find_one_int("nsamples", ps.find_one_int("samples", 1))
        return (tuple(l_emit * sc), two, max(1, int(ns)))

    # --- materials ---
    def _current_material_id(self):
        g = self.graphics
        if g.current_material_id is not None:
            return g.current_material_id
        mid = self._build_material(g.material, g.material_params)
        g.current_material_id = mid
        return mid

    def _tp(self, params):
        return TextureParams(params, ParamSet(), self.graphics.float_textures,
                             self.graphics.spectrum_textures, self.textures)

    def _is_zero(self, tex) -> bool:
        """``tex`` is a constant float texture whose value is 0."""
        if not isinstance(tex, T.ConstantTexture):
            return False
        v = np.asarray(self.textures.const[tex.key])
        return v.size == 1 and float(v) == 0.0

    def _build_material(self, name, params) -> int:
        """The material id of ``name`` with ``params``: the reference's
        factories (rustracer_tpu/scene/api.py:605-703), their defaults
        and the order in which they register textures."""
        if name in ("", "none"):
            return -1
        if name == "fourier":
            raise not_ported(f"Material {name!r}", SHADING)
        if name not in ("matte", "plastic", "mirror", "glass", "metal",
                        "substrate", "translucent", "uber", "disney", "mix"):
            log.warning("material %r unknown; using matte", name)
            return self._build_material("matte", ParamSet())
        tp = self._tp(params)
        if name == "matte":
            kd = tp.get_spectrum_texture("Kd", (0.5, 0.5, 0.5))
            sigma = tp.get_float_texture("sigma", 0.0)
            # a constant 0 is the Lambertian lobe the reference picks for it
            m = M.MatteMaterial(kd=kd,
                                sigma=None if self._is_zero(sigma) else sigma)
        elif name == "plastic":
            m = M.PlasticMaterial(
                kd=tp.get_spectrum_texture("Kd", (0.25,) * 3),
                ks=tp.get_spectrum_texture("Ks", (0.25,) * 3),
                roughness=tp.get_float_texture("roughness", 0.1),
                remap_roughness=tp.find_bool("remaproughness", True))
        elif name == "mirror":
            m = M.MirrorMaterial(kr=tp.get_spectrum_texture("Kr", (0.9,) * 3))
        elif name == "glass":
            ur = tp.get_float_texture_or_none("uroughness")
            vr = tp.get_float_texture_or_none("vroughness")
            eta = tp.get_float_texture_or_none("eta")
            if eta is None:
                eta = tp.get_float_texture("index", 1.5)
            kr = tp.get_spectrum_texture("Kr", (1.0,) * 3)
            kt = tp.get_spectrum_texture("Kt", (1.0,) * 3)
            m = M.GlassMaterial(
                kr=kr, kt=kt, index=eta,
                urough=ur or self.textures.constant_float(0.0),
                vrough=vr or self.textures.constant_float(0.0),
                remap_roughness=tp.find_bool("remaproughness", True))
        elif name == "metal":
            cu_eta, cu_k = metal_eta_k("Cu")
            m = M.MetalMaterial(
                eta=tp.get_spectrum_texture("eta", tuple(cu_eta)),
                k=tp.get_spectrum_texture("k", tuple(cu_k)),
                roughness=tp.get_float_texture("roughness", 0.01),
                urough=tp.get_float_texture_or_none("uroughness"),
                vrough=tp.get_float_texture_or_none("vroughness"),
                remap_roughness=tp.find_bool("remaproughness", True))
        elif name == "substrate":
            m = M.SubstrateMaterial(
                kd=tp.get_spectrum_texture("Kd", (0.5,) * 3),
                ks=tp.get_spectrum_texture("Ks", (0.5,) * 3),
                urough=tp.get_float_texture("uroughness", 0.1),
                vrough=tp.get_float_texture("vroughness", 0.1),
                remap_roughness=tp.find_bool("remaproughness", True))
        elif name == "translucent":
            m = M.TranslucentMaterial(
                kd=tp.get_spectrum_texture("Kd", (0.25,) * 3),
                ks=tp.get_spectrum_texture("Ks", (0.25,) * 3),
                roughness=tp.get_float_texture("roughness", 0.1),
                reflect=tp.get_spectrum_texture("reflect", (0.5,) * 3),
                transmit=tp.get_spectrum_texture("transmit", (0.5,) * 3),
                remap_roughness=tp.find_bool("remaproughness", True))
        elif name == "uber":
            m = M.UberMaterial(
                kd=tp.get_spectrum_texture("Kd", (0.25,) * 3),
                ks=tp.get_spectrum_texture("Ks", (0.25,) * 3),
                kr=tp.get_spectrum_texture("Kr", (0.0,) * 3),
                kt=tp.get_spectrum_texture("Kt", (0.0,) * 3),
                roughness=tp.get_float_texture("roughness", 0.1),
                urough=tp.get_float_texture_or_none("uroughness"),
                vrough=tp.get_float_texture_or_none("vroughness"),
                opacity=tp.get_spectrum_texture("opacity", (1.0,) * 3),
                eta=tp.get_float_texture("eta", 1.5),
                remap_roughness=tp.find_bool("remaproughness", True))
        elif name == "disney":
            m = M.DisneyMaterial(
                color=tp.get_spectrum_texture("color", (0.5,) * 3),
                metallic=tp.get_float_texture("metallic", 0.0),
                eta=tp.get_float_texture("eta", 1.5),
                roughness=tp.get_float_texture("roughness", 0.5),
                specular_tint=tp.get_float_texture("speculartint", 0.0),
                anisotropic=tp.get_float_texture("anisotropic", 0.0),
                sheen=tp.get_float_texture("sheen", 0.0),
                sheen_tint=tp.get_float_texture("sheentint", 0.5),
                clearcoat=tp.get_float_texture("clearcoat", 0.0),
                clearcoat_gloss=tp.get_float_texture("clearcoatgloss", 1.0),
                spec_trans=tp.get_float_texture("spectrans", 0.0),
                flatness=tp.get_float_texture("flatness", 0.0),
                diff_trans=tp.get_float_texture("difftrans", 1.0),
                thin=tp.find_bool("thin", False))
        else:
            # the two named materials, shared with the set (the reference
            # logs and takes a matte where either name is missing)
            ids = [self.graphics.named_materials.get(
                params.find_one_string(k, ""))
                for k in ("namedmaterial1", "namedmaterial2")]
            if None in ids:
                log.error("mix material needs two named materials; "
                          "falling back to matte")
                return self._build_material("matte", ParamSet())
            m1, m2 = (self.material_set.materials[i] for i in ids)
            m = M.MixMaterial(m1, m2,
                              tp.get_spectrum_texture("amount", (0.5,) * 3))
        if tp.get_float_texture_or_none("bumpmap") is not None:
            raise not_ported(f"Material {name!r} with a bumpmap", SHADING)
        return self.material_set.add(m)

    # --- textures ---
    def _mapping_2d(self, tp: TextureParams):
        mtype = tp.find_string("mapping", "uv")
        if mtype == "planar":
            raise not_ported("the planar texture mapping", SHADING)
        if mtype != "uv":
            log.warning("2D mapping %r unsupported; using uv", mtype)
            return T.UVMapping2D()
        return T.UVMapping2D(tp.find_float("uscale", 1.0),
                             tp.find_float("vscale", 1.0),
                             tp.find_float("udelta", 0.0),
                             tp.find_float("vdelta", 0.0))

    def _make_texture(self, cls, tp: TextureParams, is_spectrum: bool):
        reg = self.textures
        kind = "spectrum" if is_spectrum else "float"
        if cls == "constant":
            if is_spectrum:
                return reg.constant_spectrum(tp.find_spectrum("value",
                                                              (1, 1, 1)))
            return reg.constant_float(tp.find_float("value", 1.0))
        if cls == "imagemap":
            fname = tp.find_filename("filename", "")
            gamma = tp.find_bool("gamma",
                                 fname.lower().endswith((".png", ".tga")))
            mapping = self._mapping_2d(tp)
            trilinear = tp.find_bool("trilinear", False)
            max_aniso = tp.find_float("maxanisotropy", 8.0)
            if trilinear or max_aniso != A.MAX_ANISOTROPY:
                raise not_ported("imagemap textures with trilinear "
                                 "filtering or a maxanisotropy other than "
                                 f"{A.MAX_ANISOTROPY:g} (the per-texture "
                                 "mipmap lookups)", SHADING)
            img_id = reg.image(fname, gamma)
            return T.ImageTexture(
                img_id, mapping, trilinear=trilinear, max_aniso=max_aniso,
                wrap={"repeat": WRAP_REPEAT, "black": 1, "clamp": 2}
                .get(tp.find_string("wrap", "repeat"), WRAP_REPEAT),
                scale=tp.find_float("scale", 1.0), is_spectrum=is_spectrum)
        if is_spectrum and cls == "checkerboard":
            if tp.find_int("dimension", 2) != 2:
                log.warning("3D checkerboard unsupported; using 2D")
            aa = tp.find_string("aamode", "closedform")
            tex1 = tp.get_spectrum_texture("tex1", (1,) * 3)
            tex2 = tp.get_spectrum_texture("tex2", (0,) * 3)
            if not (tex1.is_constant and tex2.is_constant):
                raise not_ported("a checkerboard of textures that are not "
                                 "constant", SHADING)
            return T.CheckerboardTexture(tex1, tex2, self._mapping_2d(tp),
                                         aa=aa)
        if cls in ("scale", "mix", "fbm", "wrinkled", "windy") or (
                is_spectrum and cls in ("uv", "marble")):
            raise not_ported(f"{kind} Texture class {cls!r}", SHADING)
        log.error("%s texture %r unimplemented (reference "
                  "api.rs:1201-1259)", kind, cls)
        return None

    # --- world_end: freeze tables and build the render bundle ---
    def world_end(self):
        self._verify_world("world_end")
        while self.graphics_stack:
            log.warning("missing AttributeEnd")
            self.graphics_stack.pop()
            self.transform_stack.pop()
        from .bundle import build_bundle
        self.scene = build_bundle(self, self.device)
        self.state = STATE_OPTIONS
        return self.scene


def parse_scene(filename: str, options=None, device="cuda") -> RealApi:
    """Tokenize and parse a scene file; the api's ``scene`` is the
    SceneBundle on ``device`` (the card unless the caller asks for the
    CPU)."""
    fileutil.set_search_directory(fileutil.directory_containing(filename))
    with time_phase("parse/tokenize"):
        tokens = tokenize_file(filename)
    api = RealApi(options, device)
    api.init()
    with time_phase("parse/directives+build"):
        parse(tokens, api,
              include_dir=os.path.dirname(os.path.abspath(filename)))
    return api


def parse_scene_string(text: str, options=None, device="cuda") -> RealApi:
    api = RealApi(options, device)
    api.init()
    parse(tokenize(text), api)
    return api
