"""SceneBundle: the frozen, renderable scene that WorldEnd produces (port of
rustracer_tpu/scene/bundle.py).

``build_bundle`` freezes the parsed records into the port's tables on the
api's device: the quadrics' tables (their prim ids first, as the
reference numbers them; an area light on a quadric is one light row), the
meshes transformed to world space and concatenated (one area-light row a
triangle of an emissive mesh), then each instanced object's meshes once,
in object space; the alpha masks baked into one atlas; the infinite
lights' maps; the wide BVH over the triangles from the port's copy of the
native builder (always: the reference tests scenes of at most 8
primitives one by one, which renders the same; the quadrics are searched
brute force, as there), with the ``Accelerator``'s split method (the
middle split for "middle", SAH for any other name; the accelerator's name
is not read, as the reference does not), two-level with instance records
when the scene instances an object; the light tables with the scene's
bounds (quadrics and instances included), the film,
filter, camera and sampler, and the integrator: the path integrator with
its spatial light grid (scene/lightdistrib.py) unless the scene asks for
the uniform strategy or has a single light, the direct-lighting (its
strategy and the lights' sample counts), Whitted, ambient-occlusion and
normal integrators. The
reference's quirks stay: the film's ``rt-`` filename prefix and the crop
window's PBRT order [x0 x1 y0 y1].

The build adds the reference's scene counters to utils/stats.py (its
_report_build_stats): triangles, quadrics, lights, materials, the memory
of the meshes, the film and the texture pyramids, and, where the JAX
package builds a BVH (more than 8 primitives, or instances; the reference
tests fewer one by one, and the port's tree of such a scene is one leaf
standing for that list), the port's 16-wide tree under names of its own,
since the JAX package's BVH/ entries count its binary tree: the 16-wide
interior nodes (one octant copy each), the 8-triangle leaf records, the
triangles per leaf record and the table's bytes.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from ..accel.bvh_build import build_wide_arrays, build_wide_scene, xform_aabb
from ..core.interaction import Interaction
from ..integrators.ao import AOIntegrator
from ..integrators.direct import DirectLightingIntegrator
from ..integrators.normal import NormalIntegrator
from ..integrators.path import PathIntegrator
from ..integrators.whitted import WhittedIntegrator
from ..ops.quadrics import quadric_world_bounds_np
from ..render.camera import PerspectiveCamera
from ..render.film import Film
from ..render.filters import make_filter
from ..render.imageio import read_image
from ..render.renderer import RenderConfig, RenderContext, Renderer
from ..render.sampler import SEQUENCE_KINDS, SamplerConfig
from ..scenes import textures_on
from ..utils import stats as S
from ..utils.stats import time_phase
from .atlas import build_atlas_meta
from .lightdistrib import build_spatial_grid
from .lights import LIGHT_AREA, make_lights
from .tables import make_geometry
from .textures import ConstantTexture, ImageTexture, full

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

    def renderer(self, max_lanes=1 << 16, progress=False) -> Renderer:
        """The scene's Renderer: the integrator's ``li_aux`` where it has
        one, so that the path lengths are counted, and its dispatched
        test bounds."""
        li = getattr(self.integrator, "li_aux", None) or self.integrator.li
        tests = getattr(self.integrator, "tests_per_lane", None)
        return Renderer(li, self.camera, self.film, self.sampler,
                        RenderConfig(max_lanes=max_lanes,
                                     report_progress=progress),
                        device=self.device,
                        tests_per_lane=tests() if tests else None)

    def render(self, progress=False, max_lanes=1 << 16, checkpoint=None,
               checkpoint_every=8, sample_stop: Optional[int] = None):
        """Samples [0, sample_stop) (all by default) -> (H, W, 3) linear
        RGB on the bundle's device; with ``checkpoint`` a path, the
        checkpointed render (resumed from the file if it exists, a
        snapshot every ``checkpoint_every`` samples, the file removed at
        the end; all samples)."""
        r = self.renderer(max_lanes, progress)
        if checkpoint:
            return r.render_checkpointed(self.context(), checkpoint,
                                         every_spp=checkpoint_every)
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


def bake_alpha(tex, textures, lookups, dev) -> np.ndarray:
    """A float alpha texture baked to an (H, W) grid of the alpha atlas
    (rustracer_tpu/scene/bundle.py _bake_alpha): a constant as 2 x 2, an
    ImageTexture at its level-0 size, any other texture on a 64 x 64 grid,
    each at its texel centres, through the texture's own ``evaluate``
    (``textures`` on device ``dev``, ``lookups`` MaterialSet.lookups of
    them)."""
    if isinstance(tex, ConstantTexture):
        v = float(np.asarray(textures["const"][tex.key].cpu()).reshape(-1)[0])
        return np.full((2, 2), v, np.float32)
    if isinstance(tex, ImageTexture):
        res_v, res_u = textures["images"][tex.image_id][0].shape[:2]
    else:
        res_v = res_u = 64
    us = (np.arange(res_u, dtype=np.float32) + 0.5) / res_u
    vs = (np.arange(res_v, dtype=np.float32) + 0.5) / res_v
    uu, vv = np.meshgrid(us, vs)
    n = uu.size
    uv = torch.as_tensor(np.stack([uu.ravel(), vv.ravel()], -1), device=dev)
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    si = Interaction(valid=torch.ones(n, dtype=torch.bool, device=dev), t=z,
                     p=z3, p_error=z3, wo=z3, n=z3, uv=uv, dpdu=z3, dpdv=z3,
                     ns=z3, ss=z3, ts=z3, material=zi, arealight=zi,
                     prim_id=zi, dndu=z3, dndv=z3)
    val = full(tex, tex.evaluate(si, textures, lookups), si)
    return val.reshape(-1)[:n].cpu().numpy().astype(np.float32) \
        .reshape(res_v, res_u)


def _emit_geometry(api, light_rows, bake):
    """Mesh records -> (the numpy ``tris`` dict, or None for a scene of
    quadrics alone; the alpha dict of make_geometry or None; the
    instances, or None); each triangle of an emissive mesh appends a light
    row to ``light_rows`` (its prim id after the quadrics'). Instanced
    objects follow the static meshes, in object space. ``bake`` bakes an
    alpha texture (``bake_alpha``)."""
    ro = api.render_options
    # the quadrics' ids come first; the dummy takes id 0 when there are none
    n_quad_slots = max(len(ro.quadrics), 1)
    vs, ns_, uvs, ss_, idxs = [], [], [], [], []
    t_mat, t_al, t_rev, t_has_n, t_has_uv = [], [], [], [], []
    t_alpha, t_shadow_alpha = [], []
    alpha_maps, alpha_ids = [], {}
    v_off = 0

    def alpha_id(tex):
        if tex is None:
            return -1
        if id(tex) not in alpha_ids:
            alpha_maps.append(bake(tex))
            alpha_ids[id(tex)] = len(alpha_maps) - 1
        return alpha_ids[id(tex)]

    def emit_mesh(rec, arealights=True):
        nonlocal v_off
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
        t_mat.extend([rec.material] * nt)
        t_rev.extend([rec.reverse] * nt)
        t_has_n.extend([has_n] * nt)
        t_has_uv.extend([has_uv] * nt)
        t_alpha.extend([alpha_id(rec.alpha_tex)] * nt)
        t_shadow_alpha.extend([alpha_id(rec.shadow_alpha_tex)] * nt)
        if arealights and rec.arealight_spec is not None:
            emit, two, nsamp = rec.arealight_spec
            for k in range(nt):
                light_rows.append(dict(
                    type=LIGHT_AREA, pos=(0, 0, 0), emit=emit,
                    prim=n_quad_slots + base_tri + k, twosided=two,
                    nsamples=nsamp))
                t_al.append(len(light_rows) - 1)
        else:
            t_al.extend([-1] * nt)
        v_off += nv

    for rec in ro.meshes:
        emit_mesh(rec)
    inst = None
    if ro.instance_list:
        n_static_verts = v_off
        objects = []
        for obj_recs in ro.instance_objects:
            tri_lo = sum(len(x) for x in idxs)
            for rec in obj_recs:
                emit_mesh(rec, arealights=False)
            objects.append((tri_lo, sum(len(x) for x in idxs)))
        instances = [dict(obj=oid, o2w=t.m, w2o=t.m_inv,
                          flip=bool(t.swaps_handedness()))
                     for oid, t in ro.instance_list]
        inst = dict(objects=objects, instances=instances,
                    n_static_verts=n_static_verts)
    if not idxs:
        return None, None, inst
    tris = dict(
        tv_p=np.concatenate(vs), tv_n=np.concatenate(ns_),
        tv_uv=np.concatenate(uvs), tv_s=np.concatenate(ss_),
        t_idx=np.concatenate(idxs),
        t_material=np.array(t_mat, np.int32),
        t_arealight=np.array(t_al, np.int32),
        t_reverse=np.array(t_rev, bool),
        t_has_n=np.array(t_has_n, bool),
        t_has_uv=np.array(t_has_uv, bool),
        t_alpha_tex=np.array(t_alpha, np.int32),
        t_shadow_alpha_tex=np.array(t_shadow_alpha, np.int32))
    alpha = None
    if alpha_maps:
        flats = [m.ravel() for m in alpha_maps]
        offs = np.concatenate([[0], np.cumsum([f.size for f in flats])[:-1]])
        atlas = np.concatenate(flats).astype(np.float32)
        meta = np.array([[o, m.shape[1], m.shape[0]]
                         for o, m in zip(offs, alpha_maps)], np.int32)
        if atlas.size <= 1:      # has_alpha counts more than one texel
            atlas = np.concatenate([atlas, np.zeros(1, np.float32)])
        alpha = dict(alpha_atlas=atlas, alpha_meta=meta)
    return tris, alpha, inst


def _infinite_lights(ro):
    """The infinite lights' maps (the port's image reader; a 4 x 8 map of
    ones without ``mapname``), frames and scales."""
    out = []
    for inf in ro.infinite_lights:
        m = read_image(inf["mapname"]) if inf["mapname"] \
            else np.ones((4, 8, 3), np.float32)
        out.append(dict(map=m, l2w=inf["l2w"], scale=inf["scale"]))
    return out


def _world_bounds(tris, quad, inst=None):
    """-> (center, radius, lo, hi) of the triangles' vertices (static
    vertices and each instance's transformed object box where the scene
    has instances: the objects' rows are in object space) and the
    quadrics' world boxes (the unit box of an empty scene)."""
    los, his = [], []
    if tris is not None:
        if inst is None:
            los.append(tris["tv_p"].min(0))
            his.append(tris["tv_p"].max(0))
        else:
            nsv = inst["n_static_verts"]
            if nsv:
                los.append(tris["tv_p"][:nsv].min(0))
                his.append(tris["tv_p"][:nsv].max(0))
            for r in inst["instances"]:
                alo, ahi = inst["objects"][r["obj"]]
                vids = tris["t_idx"][alo:ahi].ravel()
                ov = tris["tv_p"][vids.min():vids.max() + 1]
                lo, hi = xform_aabb(np.asarray(r["o2w"], np.float32),
                                    ov.min(0), ov.max(0))
                los.append(lo)
                his.append(hi)
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


def _bvh(ro, tris, inst):
    """The wide BVH over the triangles with the Accelerator's split method
    (None without triangles: make_geometry's dummy triangle takes its
    own); two-level, with the instance tables, for an instanced scene."""
    if tris is None:
        return None
    split = ro.accelerator_params.find_one_string("splitmethod", "sah")
    with time_phase("scene/BVH build"):
        if inst is not None:
            return build_wide_scene(tris, inst["objects"], inst["instances"],
                                    split_method=split)
        return build_wide_arrays(tris["tv_p"], tris["t_idx"], split)


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
    """The (0,2)-sequence sampler (16 spp by default) or the random one
    (4); any other name warns and takes the (0,2)-sequence."""
    sp, name = ro.sampler_params, ro.sampler_name
    kind = "random" if name == "random" else "02sequence"
    if name != "random" and name not in SEQUENCE_KINDS:
        log.warning("sampler %r unsupported; using 02sequence", name)
    spp = sp.find_one_int("pixelsamples", 4 if kind == "random" else 16)
    if quick:
        spp = max(1, spp // 4)   # --quick: spp / 4
    return SamplerConfig(kind=kind, spp=spp)


def _integrator(ro, ms, lights, light_rows, world_lo, world_hi):
    """-> (the integrator of the scene's Integrator directive, the spatial
    light grid or None); the reference's bundle.py:384-428. ``light_rows``:
    the light rows before the infinite lights'. An unknown name takes the
    path integrator at depth 5."""
    ip, iname = ro.integrator_params, ro.integrator_name
    depth = ip.find_one_int("maxdepth", 5)
    if iname == "path":
        integ = PathIntegrator(
            mat_set=ms, max_depth=depth,
            rr_threshold=ip.find_one_float("rrthreshold", 1.0))
        # light-sampling strategy: "spatial" by default; uniform when asked
        # for or when there is one light
        strategy = ip.find_one_string("lightsamplestrategy", "spatial")
        if strategy != "uniform" and lights.n_lights > 1:
            with time_phase("scene/spatial light distribution"):
                return integ, build_spatial_grid(lights, world_lo, world_hi)
        return integ, None
    if iname == "directlighting":
        # per-light sample counts aligned with the final light rows (the
        # infinite lights' rows last)
        nsamp = tuple(r.get("nsamples", 1) for r in light_rows) + tuple(
            inf.get("nsamples", 1) for inf in ro.infinite_lights)
        strategy = ip.find_one_string("strategy", "all")
        return DirectLightingIntegrator(
            mat_set=ms, strategy="one" if strategy == "one" else "all",
            max_depth=depth,
            light_nsamples=nsamp if any(n > 1 for n in nsamp) else ()), None
    if iname == "whitted":
        return WhittedIntegrator(mat_set=ms, max_depth=depth), None
    if iname in ("ao", "ambientocclusion"):
        return AOIntegrator(mat_set=ms,
                            n_samples=ip.find_one_int("nsamples", 16)), None
    if iname == "normal":
        return NormalIntegrator(mat_set=ms), None
    log.warning("integrator %r unknown; using path", iname)
    return PathIntegrator(mat_set=ms, max_depth=5), None


def build_bundle(api, device="cuda") -> SceneBundle:
    ro = api.render_options
    dev = torch.device(device)
    iname = ro.integrator_name
    # the light rows in the reference's order: point and distant lights,
    # quadric area lights, triangle area lights; make_lights appends the
    # infinite lights
    light_rows = list(ro.lights)
    ms = api.material_set
    tex = api.textures.tables()
    if tex["images"]:
        am = build_atlas_meta(tex["images"])
        tex["atlas_meta"] = am["atlas_meta"]
        tex["atlas_levels"] = am["atlas_levels"]
    textures = textures_on(tex, dev)
    quad = _emit_quadrics(api, light_rows)
    tris, alpha, inst = _emit_geometry(
        api, light_rows,
        lambda t: bake_alpha(t, textures, ms.lookups(textures, dev), dev))
    bvh = _bvh(ro, tris, inst)
    geom = make_geometry(tris, bvh=bvh, quadrics=quad, device=dev,
                         alpha=alpha)
    center, radius, world_lo, world_hi = _world_bounds(tris, quad, inst)
    lights = make_lights(light_rows, geom, world_center=center,
                         world_radius=radius,
                         infinite=_infinite_lights(ro), device=dev)
    film = _film(ro)
    camera = _camera(ro, film.full_resolution)
    sampler = _sampler(ro, api.opts.get("quick_render"))

    integ, light_grid = _integrator(ro, ms, lights, light_rows, world_lo,
                                    world_hi)
    _report_build_stats(ro, geom, lights, ms, film, textures, tris, bvh)
    return SceneBundle(
        geom=geom, lights=lights, material_set=ms,
        textures=textures, camera=camera, film=film,
        sampler=sampler, integrator=integ, integrator_name=iname,
        filename=film.filename, light_grid=light_grid, device=dev,
        world_bounds=(world_lo, world_hi))


def _report_build_stats(ro, geom, lights, ms, film, textures, tris, bvh):
    """The scene-build counters (the JAX package's bundle.py
    _report_build_stats; the reference's bvh/mod.rs:19-27, mesh.rs:21-23,
    film.rs:19, mipmap.rs:17-19 and scene.rs counts)."""
    n_tris = int(geom.n_triangles) if tris is not None else 0
    S.counter_add("Scene/Triangles", n_tris)
    S.counter_add("Scene/Quadric shapes", len(ro.quadrics))
    S.counter_add("Scene/Lights", int(lights.n_lights))
    S.counter_add("Scene/Materials", len(ms.materials))
    if tris is not None:
        S.memory_add("Memory/Triangle meshes", sum(
            tris[k].nbytes for k in ("tv_p", "tv_n", "tv_uv", "tv_s",
                                     "t_idx")))
    if bvh is not None and (len(ro.quadrics) + n_tris > 8
                            or ro.instance_list):
        table = np.asarray(bvh["bvh16_table"])
        tag = table[:, 0].view(np.int32)
        leaf = tag < 0
        n_leaf = int(leaf.sum())
        S.counter_add("BVH/16-wide interior nodes",
                      int(((tag >= 1) & (tag <= 16)).sum()) // 8)
        S.counter_add("BVH/16-wide leaf records", n_leaf)
        S.ratio_report("BVH/Triangles per 16-wide leaf",
                       int(-tag[leaf].sum()), n_leaf)
        S.memory_add("Memory/BVH tree", sum(
            np.asarray(v).nbytes for v in bvh.values()
            if isinstance(v, np.ndarray)))
    xr, yr = film.full_resolution
    S.memory_add("Memory/Film pixels", xr * yr * 4 * 4)
    for pyr in textures.get("images", []):
        S.memory_add("Memory/Texture MIP maps",
                     sum(lv.numel() * lv.element_size() for lv in pyr))
