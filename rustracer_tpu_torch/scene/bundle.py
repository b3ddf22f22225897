"""SceneBundle: the frozen, renderable scene that WorldEnd produces (port of
rustracer_tpu/scene/bundle.py for triangle and quadric scenes).

``build_bundle`` freezes the parsed records into the port's tables on the
api's device: the quadrics' tables (their prim ids first, as the
reference numbers them; an area light on a quadric is one light row), the
meshes transformed to world space and concatenated (one area-light row a
triangle of an emissive mesh), the infinite lights' maps, the wide
BVH over the triangles from the port's copy of the SAH builder (always:
the reference tests scenes of at most 8 primitives one by one, which
renders the same; the quadrics are searched brute force, as there), the
light tables with the scene's bounds (quadrics included), the film,
filter, camera and sampler, and the path integrator with its spatial light
grid (scene/lightdistrib.py) unless the scene asks for the uniform
strategy or has a single light. The
reference's quirks stay: the film's ``rt-`` filename prefix and the crop
window's PBRT order [x0 x1 y0 y1].
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from ..accel.bvh_build import build_wide_arrays
from ..integrators.path import PathIntegrator
from ..ops.quadrics import quadric_world_bounds_np
from ..render.camera import PerspectiveCamera
from ..render.film import Film
from ..render.filters import make_filter
from ..render.imageio import read_image
from ..render.renderer import RenderConfig, RenderContext, Renderer
from ..render.sampler import SamplerConfig
from ..scenes import textures_on
from ..utils.stats import time_phase
from .api import INTEGRATORS, RUN_SURFACE, not_ported
from .atlas import build_atlas_meta
from .lightdistrib import build_spatial_grid
from .lights import LIGHT_AREA, make_lights
from .tables import make_geometry

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SceneBundle:
    geom: object
    lights: object
    material_set: object
    textures: dict
    camera: PerspectiveCamera
    film: Film
    sampler: SamplerConfig
    integrator: object
    integrator_name: str
    filename: str
    light_grid: object = None
    device: torch.device = torch.device("cuda")
    world_bounds: tuple = None   # (lo (3,), hi (3,)) the grid's, numpy

    def context(self) -> RenderContext:
        return RenderContext(geom=self.geom, lights=self.lights,
                             textures=self.textures,
                             light_grid=self.light_grid)

    def renderer(self, max_lanes=1 << 16) -> Renderer:
        return Renderer(self.integrator.li, self.camera, self.film,
                        self.sampler, RenderConfig(max_lanes=max_lanes),
                        device=self.device)

    def render(self, max_lanes=1 << 16, sample_stop: Optional[int] = None):
        """Samples [0, sample_stop) (all by default) -> (H, W, 3) linear
        RGB on the bundle's device."""
        r = self.renderer(max_lanes)
        return self.film.to_image(r.render_state(self.context(),
                                                 sample_stop=sample_stop))


def _emit_quadrics(api, light_rows):
    """Quadric records -> the numpy ``quadrics`` dict of make_geometry, or
    None (the reference's bundle.py:117-142); a quadric with an area light
    appends its row to ``light_rows`` (its prim id, the quadric's index)."""
    recs = api.render_options.quadrics
    if not recs:
        return None
    q_al = []
    for i, r in enumerate(recs):
        if r.arealight_spec is None:
            q_al.append(-1)
            continue
        emit, two, nsamp = r.arealight_spec
        light_rows.append(dict(type=LIGHT_AREA, pos=(0, 0, 0), emit=emit,
                               prim=i, twosided=two, nsamples=nsamp))
        q_al.append(len(light_rows) - 1)
    return dict(
        q_type=np.array([r.qtype for r in recs], np.int32),
        q_o2w=np.stack([r.o2w.m for r in recs]),
        q_w2o=np.stack([r.o2w.m_inv for r in recs]),
        q_params=np.stack([r.params for r in recs]),
        q_material=np.array([r.material for r in recs], np.int32),
        q_arealight=np.array(q_al, np.int32),
        q_reverse=np.array([r.reverse for r in recs], bool))


def _emit_geometry(api, light_rows):
    """Mesh records -> the numpy ``tris`` dict, or None for a scene of
    quadrics alone; each triangle of an emissive mesh appends a light row
    to ``light_rows`` (its prim id after the quadrics')."""
    ro = api.render_options
    # the quadrics' ids come first; the dummy takes id 0 when there are none
    n_quad_slots = max(len(ro.quadrics), 1)
    vs, ns_, uvs, ss_, idxs = [], [], [], [], []
    t_mat, t_al, t_rev, t_has_n, t_has_uv = [], [], [], [], []
    v_off = 0
    for rec in ro.meshes:
        p = rec.o2w.apply_point(rec.p)
        nv = p.shape[0]
        vs.append(p.astype(np.float32))
        has_n = rec.n is not None and len(rec.n) > 0
        ns_.append(rec.o2w.apply_normal(rec.n).astype(np.float32) if has_n
                   else np.zeros((nv, 3), np.float32))
        has_uv = rec.uv is not None and len(rec.uv) > 0
        uvs.append(np.asarray(rec.uv, np.float32) if has_uv
                   else np.zeros((nv, 2), np.float32))
        ss_.append(rec.o2w.apply_vector(rec.s).astype(np.float32)
                   if rec.s is not None and len(rec.s)
                   else np.zeros((nv, 3), np.float32))
        base_tri = sum(len(x) for x in idxs)
        tris = np.asarray(rec.indices, np.int32) + v_off
        idxs.append(tris)
        nt = tris.shape[0]
        t_mat += [rec.material] * nt
        t_rev += [rec.reverse] * nt
        t_has_n += [has_n] * nt
        t_has_uv += [has_uv] * nt
        if rec.arealight_spec is not None:
            emit, two, nsamp = rec.arealight_spec
            for k in range(nt):
                light_rows.append(dict(
                    type=LIGHT_AREA, pos=(0, 0, 0), emit=emit,
                    prim=n_quad_slots + base_tri + k, twosided=two,
                    nsamples=nsamp))
                t_al.append(len(light_rows) - 1)
        else:
            t_al += [-1] * nt
        v_off += nv
    if not idxs:
        return None
    n = sum(len(x) for x in idxs)
    tris = dict(
        tv_p=np.concatenate(vs), tv_n=np.concatenate(ns_),
        tv_uv=np.concatenate(uvs), tv_s=np.concatenate(ss_),
        t_idx=np.concatenate(idxs),
        t_material=np.array(t_mat, np.int32),
        t_arealight=np.array(t_al, np.int32),
        t_reverse=np.array(t_rev, bool),
        t_has_n=np.array(t_has_n, bool),
        t_has_uv=np.array(t_has_uv, bool),
        t_alpha_tex=np.full(n, -1, np.int32),
        t_shadow_alpha_tex=np.full(n, -1, np.int32))
    return tris


def _infinite_lights(ro):
    """The infinite lights' maps (the port's image reader; a 4 x 8 map of
    ones without ``mapname``), frames and scales."""
    out = []
    for inf in ro.infinite_lights:
        m = read_image(inf["mapname"]) if inf["mapname"] \
            else np.ones((4, 8, 3), np.float32)
        out.append(dict(map=m, l2w=inf["l2w"], scale=inf["scale"]))
    return out


def _world_bounds(tris, quad):
    """-> (center, radius, lo, hi) of the triangles' vertices and the
    quadrics' world boxes (the unit box of an empty scene)."""
    los, his = [], []
    if tris is not None:
        los.append(tris["tv_p"].min(0))
        his.append(tris["tv_p"].max(0))
    if quad is not None:
        lo, hi = quadric_world_bounds_np(quad["q_type"], quad["q_o2w"],
                                         quad["q_params"])
        los.append(lo.min(0))
        his.append(hi.max(0))
    if not los:
        z = np.zeros(3, np.float32)
        return z, 1.0, z, np.ones(3, np.float32)
    lo, hi = np.min(np.stack(los), 0), np.max(np.stack(his), 0)
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - center)) or 1.0
    return center, radius, lo, hi


def _bvh(ro, tris):
    """The wide BVH over the triangles (None without: make_geometry's
    dummy triangle takes its own); refuses what the port's builder does
    not build."""
    split = ro.accelerator_params.find_one_string("splitmethod", "sah")
    if ro.accelerator_name != "bvh" or split != "sah":
        raise NotImplementedError(
            f"Accelerator {ro.accelerator_name!r} with splitmethod "
            f"{split!r}: the port builds the SAH BVH only (the reference "
            "builds the middle split as well)")
    if tris is None:
        return None
    with time_phase("scene/BVH build"):
        return build_wide_arrays(tris["tv_p"], tris["t_idx"])


def _film(ro):
    fp = ro.film_params
    xres = fp.find_one_int("xresolution", 1280)
    yres = fp.find_one_int("yresolution", 720)
    crop = fp.find_float("cropwindow")
    if crop is not None and len(crop) == 4:
        # PBRT order [x0 x1 y0 y1] -> Film (x0, y0, x1, y1)
        crop = (float(crop[0]), float(crop[2]), float(crop[1]),
                float(crop[3]))
    else:
        crop = (0.0, 0.0, 1.0, 1.0)
    # the reference's quirk: a scene's filename gets an "rt-" prefix
    fname = fp.find_one_string("filename", "")
    fname = ("rt-" + fname) if fname else "image.png"
    return Film(full_resolution=(xres, yres), crop_window=crop,
                filter=make_filter(ro.filter_name, ro.filter_params),
                filename=fname, scale=fp.find_one_float("scale", 1.0),
                max_sample_luminance=fp.find_one_float("maxsampleluminance",
                                                       float("inf")),
                diagonal=fp.find_one_float("diagonal", 35.0) * 0.001)


def _camera(ro, res):
    cp = ro.camera_params
    if ro.camera_name != "perspective":
        log.warning("camera %r unsupported (the reference has perspective "
                    "only); using perspective", ro.camera_name)
    sw = cp.find_float("screenwindow")
    screen = None
    if sw is not None and len(sw) == 4:
        screen = tuple(float(x) for x in sw)
    return PerspectiveCamera.create(
        ro.camera_to_world, fov=cp.find_one_float("fov", 90.0),
        lens_radius=cp.find_one_float("lensradius", 0.0),
        focal_distance=cp.find_one_float("focaldistance", 1e6),
        resolution=res, screen_window=screen,
        shutter_open=cp.find_one_float("shutteropen", 0.0),
        shutter_close=cp.find_one_float("shutterclose", 1.0))


def _sampler(ro, quick):
    sp, name = ro.sampler_params, ro.sampler_name
    if name == "random":
        raise not_ported(f"Sampler {name!r}", RUN_SURFACE)
    if name not in ("02sequence", "lowdiscrepancy", "zerotwosequence"):
        log.warning("sampler %r unsupported; using 02sequence", name)
    spp = sp.find_one_int("pixelsamples", 16)
    if quick:
        spp = max(1, spp // 4)   # --quick: spp / 4
    return SamplerConfig(kind="02sequence", spp=spp)


def build_bundle(api, device="cuda") -> SceneBundle:
    ro = api.render_options
    dev = torch.device(device)
    iname = ro.integrator_name
    if iname in ("directlighting", "whitted", "ao", "ambientocclusion",
                 "normal"):
        raise not_ported(f"Integrator {iname!r}", INTEGRATORS)
    # the light rows in the reference's order: point and distant lights,
    # quadric area lights, triangle area lights; make_lights appends the
    # infinite lights
    light_rows = list(ro.lights)
    quad = _emit_quadrics(api, light_rows)
    tris = _emit_geometry(api, light_rows)
    bvh = _bvh(ro, tris)
    geom = make_geometry(tris, bvh=bvh, quadrics=quad, device=dev)
    center, radius, world_lo, world_hi = _world_bounds(tris, quad)
    lights = make_lights(light_rows, geom, world_center=center,
                         world_radius=radius,
                         infinite=_infinite_lights(ro), device=dev)
    film = _film(ro)
    camera = _camera(ro, film.full_resolution)
    sampler = _sampler(ro, api.opts.get("quick_render"))

    ip = ro.integrator_params
    ms = api.material_set
    light_grid = None
    if iname != "path":
        log.warning("integrator %r unknown; using path", iname)
        integ = PathIntegrator(mat_set=ms, max_depth=5)
    else:
        integ = PathIntegrator(
            mat_set=ms, max_depth=ip.find_one_int("maxdepth", 5),
            rr_threshold=ip.find_one_float("rrthreshold", 1.0))
        # light-sampling strategy: "spatial" by default; uniform when asked
        # for or when there is one light
        strategy = ip.find_one_string("lightsamplestrategy", "spatial")
        if strategy != "uniform" and lights.n_lights > 1:
            with time_phase("scene/spatial light distribution"):
                light_grid = build_spatial_grid(lights, world_lo, world_hi)

    tex = api.textures.tables()
    if tex["images"]:
        am = build_atlas_meta(tex["images"])
        tex["atlas_meta"] = am["atlas_meta"]
        tex["atlas_levels"] = am["atlas_levels"]
    return SceneBundle(
        geom=geom, lights=lights, material_set=ms,
        textures=textures_on(tex, dev), camera=camera, film=film,
        sampler=sampler, integrator=integ, integrator_name=iname,
        filename=film.filename, light_grid=light_grid, device=dev,
        world_bounds=(world_lo, world_hi))
