"""The hand-written Hopper kernels of csrc/: build, bind, launch and count.

All kernels live in one shared library with a plain C interface, compiled
with nvcc for sm_90a and bound through ctypes (no PyTorch headers, so the
build takes seconds). Each C entry point launches its kernel on the stream it
is given (the wrappers pass ``torch.cuda.current_stream()``), allocates
nothing and returns ``cudaGetLastError()``.

Routing rule of every wrapper in this package: a tensor on the CPU goes to
the plain PyTorch version beside the kernel; a CUDA tensor launches the
kernel or raises. The only way to run a plain version on the card is the
explicit ``plain_reference()`` scope, which checks the kernels against
their plain versions.

``LAUNCHES`` counts, per C entry point, the launches made outside that scope.
Inside ``annotated()`` each launch is also a torch.profiler range named
after its entry point, so that a trace names the kernels by the port's
names (the command line's ``--profile``).

Autograd cannot see through a ctypes call: a kernel handed a tensor that
requires grad would cut the graph without a word. So ``launch`` raises for
such a tensor while grad mode is on, except inside ``differentiable()``,
the scope in which this package's ``torch.autograd.Function``s launch the
forward kernels and their backward kernels (K9-K11, K7 as its own
transpose).
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import threading

import torch

from ._build import CSRC, compile_shared

CU_SOURCES = ("sampler.cu", "film.cu", "traverse16.cu", "interaction.cu",
              "atlas.cu", "compact.cu", "gather.cu", "film_bwd.cu",
              "atlas_bwd.cu", "gather_bwd.cu", "lightdistrib.cu",
              "quadrics.cu", "lights.cu", "mipmap.cu", "noise.cu",
              "fourier.cu", "mipmap_bwd.cu", "pathshade.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_D = ctypes.c_double
# C entry point -> argument types (the trailing stream argument included)
SIGNATURES = {
    "sample_1d": [_P, _P, _I, _U, _U, _P, _P],
    "sample_2d": [_P, _P, _I, _U, _U, _P, _P],
    "sample_random_1d": [_P, _P, _I, _U, _U, _P, _P],
    "sample_random_2d": [_P, _P, _I, _U, _U, _P, _P],
    # ..., max_lum, the filter's kind and 8 parameters (filters.py
    # Filter.kernel_params), stream
    "film_add_samples": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                         _F, _F, _I, _I, _F, _I] + [_F] * 8 + [_P],
    # the arguments of film_add_samples, then the lanes' layout (the first
    # lane's row-major index in the sample bounds, their first column and
    # row, width and height), the tap window (first and last offset of a
    # target pixel from a lane's pixel, x and y) and the film rows the
    # launch covers (first, count), stream
    "film_add_samples_det": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                             _F, _F, _I, _I, _F, _I] + [_F] * 8
    + [_I] * 5 + [_I] * 4 + [_I] * 2 + [_P],
    "traverse16_closest": [_P, _I, _P, _I, _P, _P, _P, _I,
                           _P, _P, _P, _P, _P, _P],
    "traverse16_any": [_P, _I, _P, _I, _P, _P, _P, _I,
                       _P, _P, _P, _P, _P, _P],
    # K1's instanced, alpha and instanced-alpha walks: table, n_rows,
    # roots, depth, o, d, t_max, n, hit, t, prim, inst, counts, next_ray,
    # then t_shade, the two alpha columns, the atlas and its meta, stream
    **{f"traverse16_{kind}_{q}": [_P, _I, _P, _I, _P, _P, _P, _I]
       + [_P] * 6 + [_P] * 5 + [_P]
       for kind in ("inst", "alpha", "inst_alpha")
       for q in ("closest", "any")},
    # t_shade, n_tris, nq, whether a quadric is real (the kernel with the
    # quadric branch), the 7 quadric tables (scene/tables.py QUADRIC_KEYS),
    # the rays and hits, n, 15 outputs, stream
    "build_interaction": [_P, _I, _I, _I] + [_P] * 7 + [_P] * 6 + [_I]
    + [_P] * 15 + [_P],
    # K2's instance branch: the arguments of build_interaction, then the
    # hits' instances and the instance tables (o2w, w2o, flip), stream
    "build_interaction_inst": [_P, _I, _I, _I] + [_P] * 7 + [_P] * 6 + [_I]
    + [_P] * 15 + [_P] * 4 + [_P],
    "atlas_lookup_ewa": [_P, _I, _P, _I] + [_P] * 11 + [_I] + [_F] * 9
    + [_P, _P],
    "alive_first_order": [_P, _I, _P, _P, _P, _P, _P],
    "slab_take": [_P, _I, _I, _P, _P, _P, _P],
    "slab_put": [_P, _I, _I, _P, _P, _P, _P],
    "row_gather": [_P, _P, _I, _I, _P, _P],
    # ..., g_rad, the film's sample-bounds width and first column (the
    # renderer's sample layout), stream
    "film_add_samples_bwd": [_P, _P, _P, _I, _P, _I, _I, _I, _I,
                             _F, _F, _I, _I, _F, _I] + [_F] * 8
    + [_P, _I, _I, _P],
    "atlas_lookup_ewa_bwd": [_P, _I, _P, _I] + [_P] * 11 + [_I] + [_F] * 9
    + [_P, _I, _P],
    "row_gather_bwd": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    # the grid's lo, voxel extent and voxel counts, halton, n_probes, the
    # light tables, n_lights, out, stream
    "spatial_grid_contrib": [_F] * 6 + [_I] * 3 + [_P, _I] + [_P] * 5
    + [_I, _P, _P],
    # the grid as above, halton, n_probes, the 17 light tables of
    # scene/lights.py (types, quadrics, infinite maps), n_lights, out,
    # stream
    "spatial_grid_contrib_lights": [_F] * 6 + [_I] * 3 + [_P, _I]
    + [_P] * 17 + [_I, _P, _P],
    "spatial_light_pick": [_P, _P, _I] + [_F] * 6 + [_I] * 3
    + [_P, _P, _I, _P, _P, _P],
    "spatial_pmf_lookup": [_P, _P, _I] + [_F] * 6 + [_I] * 3
    + [_P, _I, _P, _P],
    # q_type, q_w2o, q_params, nq, o, d, t_max, n, outputs, stream
    "quadric_closest": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P],
    "quadric_any": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P],
    # lid, p, u, n, row_inf, n_lights, emit, the infinite lights' flat
    # table, descriptors and l2w, world_radius, 4 outputs, stream
    "infinite_sample": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _F]
    + [_P] * 4 + [_P],
    # d, mask, prev_pdf, prev_spec, pmfs, pmf_const, mis, n, n_inf, scale,
    # flat table, descriptors, w2l, out, stream
    "infinite_escape": [_P] * 5 + [_F, _I, _I, _I] + [_P] * 5 + [_P],
    # texels, stride, meta, n_levels, wrap, mode, st, dst0, dst1, width,
    # max_aniso, n, the 8 tap weights, their sum, exp(-2), out, stream
    "mipmap_lookup": [_P, _I, _P, _I, _I, _I] + [_P] * 4 + [_F, _I]
    + [_F] * 10 + [_P, _P],
    # g_out, meta, n_levels, wrap, mode, st, dst0, dst1, width, max_aniso,
    # n, the 8 tap weights, their sum, exp(-2), g_tex, n_texels, the
    # threads a lookup (0: each block's choice), stream
    "mipmap_lookup_bwd": [_P, _P, _I, _I, _I] + [_P] * 4 + [_F, _I]
    + [_F] * 10 + [_P, _I, _I, _P],
    # p, dpdx, dpdy, n, omega, max_octaves, turbulence, out, stream
    "noise_fbm": [_P, _P, _P, _I, _D, _I, _I, _P, _P],
    # mode, the table set's 8 tables, n_mu, nc, m_pad, tid, wo, wi or u,
    # mask, n, f, pdf, wi out, stream
    "fourier_bsdf": [_I] + [_P] * 8 + [_I] * 3 + [_P] * 4 + [_I]
    + [_P] * 3 + [_P],
    # K21: the hit's valid, arealight, material, n, wo, p, the ray's d,
    # the state's L, beta, prev_p, alive, prev_pdf, prev_spec, path_len,
    # the pmf table, pmf_const, first, n, n_lights, the light rows'
    # twosided, emit, area, 4 outputs, stream
    "path_hit_emit": [_P] * 14 + [_P, _F, _I, _I, _I] + [_P] * 3 + [_P] * 4
    + [_P],
    # K22: the hit's p, p_error, n, ns, ss, ts, wo, valid, the lobe's
    # params and active, the state's alive, beta, eta_scale, lid, the
    # pmf table, pmf_const, u_light, u2, u_rr, the threshold, n,
    # n_lights, the light rows' tri_p, emit, area, tri_rev, twosided, 11
    # outputs, stream
    "path_scatter_lambert": [_P] * 15 + [_F] + [_P] * 3
    + [_F, _I, _I] + [_P] * 5 + [_P] * 11 + [_P],
    # K23: L, pending, occluded, n, out, stream
    "path_nee_add": [_P] * 3 + [_I, _P, _P],
}
# host functions of the library (no launch, not counted): name -> argument
# types; each returns an int
HOST_SIGNATURES = {"row_gather_bwd_blocks": [_I, _I, _I]}
# the backward kernels (K9-K11, K20), launched only by autograd's backward
# pass (K20 only for a scene with per-texture image lookups); K7 is its own
# transpose and counts as slab_take / slab_put
BACKWARD_KERNELS = ("film_add_samples_bwd", "atlas_lookup_ewa_bwd",
                    "row_gather_bwd", "mipmap_lookup_bwd")
# the spatial light grid's kernels (K12, K13), launched only for a scene
# with a grid (scene/lightdistrib.py); the scenes built in code have none
GRID_KERNELS = ("spatial_grid_contrib", "spatial_light_pick",
                "spatial_pmf_lookup")
# the quadrics' hit search (K14), launched only for a scene with a sphere,
# cylinder or disk; the dragon and the Cornell box have none
QUADRIC_KERNELS = ("quadric_closest", "quadric_any")
# the kernels of the lights other than triangle area lights: K12's
# branches for point, distant, quadric area and infinite lights (a grid
# over a scene that holds one) and the infinite lights' sample and escape
# radiance (K15, K16, a scene with an infinite light)
LIGHT_KERNELS = ("spatial_grid_contrib_lights", "infinite_sample",
                 "infinite_escape")
# the kernels of shading beyond the dragon's: the per-texture mipmap
# lookups (K17: image textures outside the atlas, a bump map's moved
# lookups), the noise textures (K18) and the Fourier BSDF (K19), launched
# only for a scene that holds them
SHADING_KERNELS = ("mipmap_lookup", "noise_fbm", "fourier_bsdf")
# the geometry beyond triangles and quadrics: K1's walks of instanced
# tables and of tables with alpha cutouts, and K2's instance branch,
# launched only for a scene that holds instances or alpha maps
GEOMETRY_KERNELS = tuple(
    f"traverse16_{kind}_{q}" for kind in ("inst", "alpha", "inst_alpha")
    for q in ("closest", "any")) + ("build_interaction_inst",)
# the run surface's kernels: the random sampler's (K3r), launched only for
# a scene with Sampler "random", and the deterministic splat (K4d) of the
# checkpointed render
RUN_KERNELS = ("sample_random_1d", "sample_random_2d",
               "film_add_samples_det")
# the path integrator's chain for Lambertian surfaces under triangle lights
# (K21-K23), launched by every forward render of such a scene (the
# dragons, the Cornell boxes, the gallery) outside a train step
PATH_KERNELS = ("path_hit_emit", "path_scatter_lambert", "path_nee_add")
# the kernels of the textured dragon's forward render (PATH_KERNELS
# among them)
FORWARD_KERNELS = tuple(k for k in SIGNATURES if k not in
                        BACKWARD_KERNELS + GRID_KERNELS + QUADRIC_KERNELS
                        + LIGHT_KERNELS + SHADING_KERNELS + GEOMETRY_KERNELS
                        + RUN_KERNELS)
LAUNCHES = {name: 0 for name in SIGNATURES}

_lock = threading.Lock()
_lib = None
_lib_error = None


class _Route(threading.local):
    function = False


_route = _Route()
# the plain_reference() scope; one for the process, not a thread's: autograd
# runs a CUDA backward pass in a thread of its own, whose kernels' plain
# versions the scope must reach too
_plain = [False]


@contextlib.contextmanager
def plain_reference():
    """Run the plain PyTorch versions, also on CUDA tensors, inside this
    scope (the backward passes it starts included): the reference the
    kernels are checked against."""
    prev = _plain[0]
    _plain[0] = True
    try:
        yield
    finally:
        _plain[0] = prev


_annotate = [False]


@contextlib.contextmanager
def annotated():
    """Name each launch inside this scope as a torch.profiler range (its C
    entry point's name)."""
    prev = _annotate[0]
    _annotate[0] = True
    try:
        yield
    finally:
        _annotate[0] = prev


@contextlib.contextmanager
def differentiable():
    """The scope of this package's autograd Functions: launches inside it
    may take tensors that require grad (the Function carries the
    gradient)."""
    prev = _route.function
    _route.function = True
    try:
        yield
    finally:
        _route.function = prev


def check_grad(name: str, tensors):
    """Raise if grad mode is on, the call is outside ``differentiable()``
    and one of ``tensors`` requires grad: the kernel would cut the graph."""
    if _route.function or not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"kernel {name}: a tensor argument requires grad, and a kernel "
            "launch is invisible to autograd; call it through its "
            "differentiable wrapper")


def refuse_grad(what: str, tensors, item: str = "B12"):
    """Raise NotImplementedError naming ROADMAP item ``item`` (of section
    B) if grad mode is on and one of ``tensors`` requires grad: ``what``
    carries no gradient in the port yet, on the CPU as on the card."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md, section B, item {item})")


def use_kernel(t: torch.Tensor) -> bool:
    """True when a wrapper given ``t`` must launch its kernel."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return not _plain[0]
    raise ValueError(f"no kernel or plain route for device {t.device}")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def library_path() -> str:
    """Compile the kernel library if its build is missing; return its path."""
    return compile_shared(
        "rustracer_kernels", [os.path.join(CSRC, s) for s in CU_SOURCES],
        [nvcc_path(), *NVCC_FLAGS])


def load(path: str, names=tuple(SIGNATURES) + tuple(HOST_SIGNATURES)):
    """ctypes handle of the kernel library at ``path`` with its entry points
    ``names`` bound to their SIGNATURES (or HOST_SIGNATURES)."""
    lib = ctypes.CDLL(path)
    for name in names:
        fn = getattr(lib, "rt_" + name)
        fn.argtypes = SIGNATURES.get(name) or HOST_SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library, built on first use. A build that failed
    is not tried again in this process: its error is raised again."""
    global _lib, _lib_error
    with _lock:
        if _lib_error is not None:
            raise _lib_error
        if _lib is None:
            try:
                _lib = load(library_path())
            except RuntimeError as e:
                _lib_error = e
                raise
        return _lib


def host_call(name: str, *args, lib=None) -> int:
    """The int that host function ``rt_<name>`` of the kernel library (or of
    ``lib``) returns for ``args`` (HOST_SIGNATURES); nothing is launched."""
    return getattr(lib or library(), "rt_" + name)(*args)


def _arg(a):
    if isinstance(a, torch.Tensor):
        return a.data_ptr()
    return a


def launch(name: str, *args, lib=None):
    """Call C entry point ``rt_<name>`` on the current stream; raise if the
    launch failed. A launch of the kernel library is counted; ``lib``, a
    ``load``ed other build of an entry point, is launched uncounted.
    Raises for a tensor that requires grad (``check_grad``)."""
    check_grad(name, args)
    fn = getattr(lib or library(), "rt_" + name)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.profiler.record_function(name) if _annotate[0] \
            else contextlib.nullcontext():
        rc = fn(*[_arg(a) for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {rc}")
    if lib is None:
        LAUNCHES[name] += 1


def check(t: torch.Tensor, name: str, dtype, shape, device,
          align: int = 1):
    """Raise unless ``t`` is a contiguous tensor of this dtype, shape and
    device whose data starts on an ``align``-byte boundary (the kernels
    read raw pointers)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data is not {align}-byte aligned")
