#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rustracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the hand kernels from rustracer_tpu_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, with the
     kernel's device time (torch.profiler, by kernel name, or where three
     traces lost every record of it, CUDA events around the call, which
     the row's ms_by says; K1's from CUDA
     events around 20 launches; K4's with L2 evicted before each launch,
     as a render's one splat a step finds it), the plain version's (CUDA
     events around 20 calls; K1's around one) and its bound (the larger of its bytes over 3.35
     TB/s and its operations over 33.5 T/s, the float32 rate without FMAs,
     counted on this run's inputs): K1-K4 at the matte render's
     shapes on the full 327,680-triangle dragon, K1 bit for bit (hit, prim,
     t, counts) on 2^18 camera rays, 2^18 bounce rays and a 2^16-lane slab
     with dead lanes (rustracer_tpu_torch.tools.traverse_work), K4 bit for
     bit on the splat of 2^18 samples into the 1024^2 film; then one
     step of the textured dragon's full-width tile 2 is recorded
     (tools/bench_step_kernels.capture_step): K5 (atlas EWA, both texel
     layouts, bounded by tools/atlas_work.py) on the inputs of its four
     calls, K6 (alive-first order, one launch, three calls in a row) on
     the step's alive mask and on that of tile 0 after bounce 0, K7 (slab
     take/put, bit for bit, timed warm) on tile 0's state; K8 (row
     gather) through the gather
     microbenchmark's entry point (rustracer_tpu_torch.tools.bench_gather,
     its defaults), on the dragon's own bvh16_table and on the step's
     material rows;
  4. the matte dragon at 1024^2, 8 spp, depth 5 through the Renderer, with
     its kernels' launch counts from that run;
  5. a 128^2 crop of it at 1 spp, kernel path against the all-plain path,
     within the golden-image tolerance of tests/test_golden.py;
  6. the textured headline dragon (64-spp config, an 8-sample slice, 2^18
     lanes, slab compaction on) at 1024^2, with every kernel's launch count
     and the slab tiers taken in that run;
  7. a 1024 x 128 crop of it at 1 spp in 2^16-lane tiles (one takes the B/4
     slab, one the B/2 slab), kernel path against the all-plain path;
  8. the launches of one full-width textured step (tile 2);
  9. the backward kernels against their plain versions on the recorded
     backward pass of a full-width textured step
     (tools/bench_step_kernels.capture_grad_step): K9 (the splat's
     radiance gradient, bit for bit), K10 (the atlas EWA texel gradient,
     within 1e-5 of the plain result's largest magnitude: atomic sums in
     another order) and K11 (the material rows' gradient: each entry sums
     some 10^5 terms of both signs, so within 1e-4 of the sum of its terms'
     magnitudes) on tile 2, K7 as its own transpose (the take's and the
     put's backward, bit for bit) on tile 0, each timed with its bound and
     yardstick;
 10. the Cornell box at 256^2 with atlas imagemap walls: 3 train steps
     (parallel/mesh.make_train_step, lr 0.1, sample 0, the target its
     render with every albedo scaled by 0.5), counted, the loss falling and
     every gradient finite; then its fwd+bwd loss timed
     (tools/bench_fwdbwd.py: 4 samples, depth 5, compaction off);
 11. one train step of the textured dragon at 1024^2 (sample 0, 2^18-lane
     tiles, compaction on, the target its render with the hero's albedo
     scaled by 0.5), counted, with its wall time and peak device memory;
     then its 1024 x 128 crop in 2^16-lane tiles (both slab tiers taken),
     the gradient of every float leaf of the kernel path against the
     all-plain path within the CPU parity bound (||d|| / ||g|| <= 1e-3,
     every element within 1e-2 max |g|);
 12. the Cornell box through the port's command line on the card, in a
     subprocess (python -m rustracer_tpu_torch.utils.cli
     scenes/cornell-box.pbrt -o <tmp>.exr -v): its phase timings (parse,
     BVH, spatial grid K12, render) and launches, its image read back with
     the port's reader and held to tests/goldens/cornell-box.npz with
     tests/test_golden.py's tolerance (mean 2e-3, p99 2e-2) and structural
     checks;
 13. the same scene parsed and rendered (16 spp) in this process, counted,
     against the golden; K12 in one launch over its whole 64 x 63 x
     64-voxel grid (the parse launched it once) against its plain version
     (each sum within 1e-5 relative), timed and bounded; K12's lights
     kernel on the same table, bit for bit with it, timed beside it;
 14. the headline dragon through a scene file (tools/dragon_scene.py: the
     327,680-triangle mesh as a binary PLY, the hero texture as EXR) at
     1024^2, samples [0, 8) in 2^18-lane tiles: with the uniform strategy
     its tables bit for bit build_dragon's and its image within the golden
     tolerance of phase 6's; with the spatial grid (K12, K13) finite, its
     1024 x 128 crop at 1 spp against the all-plain path, and K13 on the
     recorded inputs of one full-width step (tile 2), bit for bit, and K12
     on the file's whole 64 x 11 x 64 grid as in phase 13; camera rays/s
     of both and of build_dragon; the uniform file's K4 splat of one
     full-width step (tile 2) through each radius-2 filter is recorded,
     with that step's launches of K4, and the K9 call of that step's
     backward (tools/bench_step_kernels.filtered_grad_step), with its
     launches of K9, for phase 15; then one full-width train step of the
     uniform file with PixelFilter mitchell (parallel/mesh.make_train_step,
     2^18-lane tiles), counted: K9 launched, the loss finite;
 15. the Cornell box parsed from a scene string once for each of the
     triangle, Gaussian and Mitchell filters, 1 spp, kernel against
     all-plain image; K4 and K9 with each filter on its recorded splat,
     against their plain versions (K4 within 1e-5 relative, K9 triangle
     bit for bit, Gaussian and Mitchell within 1e-5 relative), timed; K4
     with each filter on the dragon file's full-width splat (2^18
     samples, 1024^2, rendered with that filter), in the step's order
     (warp sums) and permuted (per tap), each within 1e-5 relative,
     timed with L2 evicted; K9 with each filter on the recorded backward
     of that step, held as on the Cornell splat, timed warm (the film's
     gradient just written, as the backward leaves it); one fwd+bwd
     train step of the Cornell with each filter (K9 under autograd),
     counted;
 16. the quadrics: K14 (quadric_closest, quadric_any) on 2^18 seeded rays
     against the 16 mixed quadrics of tools/quadric_work.py (full and
     clipped spheres, cylinders, disks with an inner radius; rotated,
     scaled and reverse-oriented) over a ground triangle, hit and quadric
     id bit for bit with the plain loop, t within 1e-6 relative, and K2
     on those rays' hits (quadric and triangle lanes, within 1e-5
     absolute or relative), each timed and bounded; scenes/testball-
     matte.pbrt parsed with its film at 1024^2 and rendered, samples
     [0, 8) in 2^18-lane tiles, depth 7, counted (K14 closest and any
     and K2 launched); one full-width step (tile 2) recorded
     (tools/quadric_work.capture_quadric_step) and K14 and K2 checked and
     timed on its inputs, with that step's launches; a 128^2 crop at 1
     spp against the all-plain path; then the scene through the port's
     command line in a subprocess at its own 64^2, 16 spp, depth 7,
     against tests/goldens/testball-matte.npz (mean 2e-3, p99 2e-2);
 17. the specular and microfacet lobes: the seven material testballs
     (glass, mirror, plastic, metal, roughglass, roughmetal, textured)
     parsed and rendered in process at their own 64^2, 16 spp, depth 7
     (textured 5), counted (K14 and K2 launched on each), each against
     tests/goldens/testball-<m>.npz (mean 2e-3, p99 2e-2); testball-glass
     with its film at 1024^2, 8 samples, 2^18-lane tiles, compaction on,
     counted and timed; in one full-width glass step (tile 2) every K14
     closest and K2 call recorded, and the one with the most rays leaving
     the ball from inside held against the plain versions (hit, quadric
     id and t bit for bit; K2 as in phase 16), timed and bounded; K14's
     any hit likewise on the shadow rays of a full-width roughglass step
     that start inside the ball; K8 at 32 floats a row (two lobes) on a
     full-width plastic step, bit for bit; K5 on the calls of a
     full-width textured step, its sphere lanes counted; then
     testball-glass through the port's command line in a subprocess
     against its golden;
 18. the other analytic materials: testball-substrate and testball-disney
     parsed and rendered in process at their own 64^2, 16 spp, depth 7,
     counted (K14, K2 and K8 launched on each), each against its golden
     (mean 2e-3, p99 2e-2), and testball-disney through the port's command
     line against its golden; a translucent, an uber (opacity 0.5, Kr and
     Kt) and a mix of substrate and Disney over a checkerboard amount
     (tools/profile_step.py BALLS) each rendered at 128^2, 4 spp, counted,
     through the kernels and through the all-plain path, held within the
     crop tolerance of phase 16; testball-disney with its film at 1024^2,
     8 samples, 2^18-lane tiles, compaction on, counted and timed (camera
     rays/s beside testball-matte's of phase 16 and testball-glass's of
     phase 17); K8 on the material rows of a full-width Disney step (96
     floats a row) and of a full-width mix step (112), bit for bit, timed
     and bounded; one tile-2 step of each of testball-matte, -glass and
     -disney at 1024^2 profiled (tools/profile_step.profile_tile: device
     kernels, busy share, hand-kernel ms);
 19. the lights: scenes/veach-mis.pbrt (sphere lights: the cone, K12's
     lights kernel), envmap-dof.pbrt (the sky: K15, K16) and
     bathroom.pbrt (triangle, sphere and sky lights under the spatial
     grid, 18 imagemaps) through the port's command line in a subprocess
     and parsed and rendered in process, as written, counted, each
     against its golden (mean 2e-3, p99 2e-2); the bathroom with its film
     at 1920 x 1080, one sample in 2^18-lane tiles, counted and timed
     (camera rays/s beside testball-matte's of phase 16); every K15 and
     K16 call of one full-width step (tile 2) against the plain versions
     (K15's radiance bit for bit, which pins its integer searches; the
     rest within 1e-5 relative, K16 plus 1e-5 / sin theta near a pole
     and off the texel edges of the map's pdf), bounce 0's K15 call, the
     camera rays' K16 call and bounce 1's timed and bounded
     (tools/light_work.py); K12's lights kernel on the bathroom's whole
     grid and on each branch alone (each light of tools/light_work.py
     MIXED_SCENE in a scene of its own, light_scene, over the mixed
     scene's grid: point, distant, the full sphere's cone, clipped
     sphere, disk, cylinder, triangle, sky), each sum within 1e-5
     relative of the plain version, timed and bounded;
 20. a JSON line of the kernels (times, bounds, library yardsticks,
     launches in the counted path that runs them and per step; K8 has a
     row for the tool's shape and ones for the render's at 16, 32, 96 and
     112 floats, K7 rows for its moves and for its transposes, K4 and K9 rows
     for the filters, on the Cornell splat and at full width, K12 rows
     for both grids, K14 and K2 rows on the quadric table, the testball
     step and the glass steps, K5 rows on the dragon and the textured
     testball, K15, K16 and the rows of K12's light branches; each row's
     ms_by: "profiler", "queued" or, for K8 at the tool's shape,
     "events"), the card line, and the result line.
The dragon, Cornell and dragon-file paths launch no K14 (no quadric);
every testball does. Only the light scenes launch K15, K16 and K12's
lights kernel.
Each path (the gather tool, the matte render, the textured render, the
textured step, the Cornell train steps, the dragon train steps, each scene
parse and render and each filtered dragon-file step and backward of
phases 13-15, the testball render and step of phase 16, each testball
render and the glass render and steps of phase 17, each render and step
of phase 18, each light scene's parse and render and the bathroom's
full-width render and step of phase 19) is
run with the launch counts set to 0 just before it and read just after;
the CLI's subprocess prints its own.
Any failed check raises; there is no CPU fallback.
"""
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SUB = 7          # bumpy_sphere(7): 327,680 mesh triangles
RES = (1024, 1024)
SPP = 8          # the matte config's samples (its 64-spp config draws these)
SAMPLES = 8      # the textured 64-spp config's timed slice
LANES = 1 << 18
CROP = (0.4375, 0.4375, 0.5625, 0.5625)     # 128^2 around the image centre
# rows 64-191 above and through the dragon's crown: two 2^16-lane tiles,
# about 6% and 38% of whose lanes hit, so one takes each slab tier
TEX_CROP = (0.0, 0.0625, 1.0, 0.1875)
TEX_CROP_LANES = 1 << 16
SOURCES = {
    "sample_1d": ("rustracer_tpu_torch/csrc/sampler.cu",
                  "rustracer_tpu/render/sampler.py:34"),
    "sample_2d": ("rustracer_tpu_torch/csrc/sampler.cu",
                  "rustracer_tpu/render/sampler.py:40"),
    "traverse16_closest": ("rustracer_tpu_torch/csrc/traverse16.cu",
                           "rustracer_tpu/accel/traverse16.py:137"),
    "traverse16_any": ("rustracer_tpu_torch/csrc/traverse16.cu",
                       "rustracer_tpu/accel/traverse16.py:137"),
    "build_interaction": ("rustracer_tpu_torch/csrc/interaction.cu",
                              "rustracer_tpu/scene/tables.py:549"),
    "film_add_samples": ("rustracer_tpu_torch/csrc/film.cu",
                         "rustracer_tpu/render/film.py:67"),
    "atlas_lookup_ewa": ("rustracer_tpu_torch/csrc/atlas.cu",
                         "rustracer_tpu/scene/atlas.py:174"),
    "alive_first_order": ("rustracer_tpu_torch/csrc/compact.cu",
                          "rustracer_tpu/integrators/path.py:382"),
    "slab_take": ("rustracer_tpu_torch/csrc/compact.cu",
                  "rustracer_tpu/integrators/path.py:65"),
    "slab_put": ("rustracer_tpu_torch/csrc/compact.cu",
                 "rustracer_tpu/integrators/path.py:87"),
    "row_gather": ("rustracer_tpu_torch/csrc/gather.cu",
                   "tools/bench_gather_pallas.py:26"),
    "film_add_samples_bwd": ("rustracer_tpu_torch/csrc/film_bwd.cu",
                             "rustracer_tpu/render/film.py:67"),
    "atlas_lookup_ewa_bwd": ("rustracer_tpu_torch/csrc/atlas_bwd.cu",
                             "rustracer_tpu/scene/atlas.py:174"),
    "row_gather_bwd": ("rustracer_tpu_torch/csrc/gather_bwd.cu",
                       "tools/bench_gather_pallas.py:26"),
    "spatial_grid_contrib": ("rustracer_tpu_torch/csrc/lightdistrib.cu",
                             "rustracer_tpu/scene/lightdistrib.py:91"),
    "spatial_light_pick": ("rustracer_tpu_torch/csrc/lightdistrib.cu",
                           "rustracer_tpu/scene/lightdistrib.py:141"),
    "spatial_pmf_lookup": ("rustracer_tpu_torch/csrc/lightdistrib.cu",
                           "rustracer_tpu/scene/lightdistrib.py:159"),
    "quadric_closest": ("rustracer_tpu_torch/csrc/quadrics.cu",
                        "rustracer_tpu/scene/tables.py:234"),
    "quadric_any": ("rustracer_tpu_torch/csrc/quadrics.cu",
                    "rustracer_tpu/scene/tables.py:522"),
    "infinite_sample": ("rustracer_tpu_torch/csrc/lights.cu",
                        "rustracer_tpu/scene/lights.py:461"),
    "infinite_escape": ("rustracer_tpu_torch/csrc/lights.cu",
                        "rustracer_tpu/scene/lights.py:593"),
    "spatial_grid_contrib_lights": ("rustracer_tpu_torch/csrc/lightdistrib.cu",
                                    "rustracer_tpu/scene/lightdistrib.py:91"),
}
# K2's quadric branch (rustracer_tpu/scene/tables.py:556-595)
QUADRIC_BRANCH = "rustracer_tpu/scene/tables.py:556"
# the transposes of K7 (rustracer_tpu/integrators/path.py _perm_take_bwd,
# _perm_put_bwd)
TRANSPOSES = {"slab_take transpose": "rustracer_tpu/integrators/path.py:74",
              "slab_put transpose": "rustracer_tpu/integrators/path.py:96"}
# rows whose kernel replaces another line than its SOURCES entry: the
# transposes, and K16's camera-ray form (infinite_le)
ROW_REPLACES = dict(TRANSPOSES, **{
    "infinite_escape": "rustracer_tpu/scene/lights.py:391",
    "infinite_escape envmap-dof": "rustracer_tpu/scene/lights.py:391"})
# the rows of the kernels line: result key -> (kernel, the inputs timed)
ROWS = {
    "sample_1d": ("sample_1d", "2^18 lanes of the matte render's tile 2"),
    "sample_2d": ("sample_2d", "2^18 lanes of the matte render's tile 2"),
    "traverse16_closest": ("traverse16_closest",
                           "mean of 2^18 camera and 2^18 bounce rays"),
    "traverse16_any": ("traverse16_any",
                       "mean of 2^18 camera and 2^18 bounce rays"),
    "build_interaction": ("build_interaction",
                              "2^18 camera hits, matte tile 2"),
    "film_add_samples": ("film_add_samples",
                         "2^18 samples into the 1024^2 film, L2 evicted "
                         "before each launch"),
    "atlas_lookup_ewa": ("atlas_lookup_ewa",
                         "mean of the 4 calls of a full-width textured "
                         "step (tile 2), quad rows"),
    "alive_first_order": ("alive_first_order",
                          "alive mask after bounce 0 of a full-width "
                          "textured step (tile 2)"),
    "slab_take": ("slab_take", "12 fields of textured tile 0 into its slab"),
    "slab_put": ("slab_put", "12 fields of textured tile 0 from its slab"),
    "row_gather": ("row_gather", "the gather tool: 2^20 rows of 512 B"),
    "row_gather material rows": ("row_gather",
                                 "the render: 2^18 lanes' material rows of "
                                 "16 float32"),
    "film_add_samples_bwd": ("film_add_samples_bwd",
                             "the radiance gradient of a full-width "
                             "textured step's splat (tile 2)"),
    "atlas_lookup_ewa_bwd": ("atlas_lookup_ewa_bwd",
                             "mean of the 4 calls of a full-width textured "
                             "step's backward (tile 2), quad layout"),
    "row_gather_bwd": ("row_gather_bwd",
                       "mean of the 4 material-row gradients of a "
                       "full-width textured step's backward (tile 2)"),
    "slab_take transpose": ("slab_put",
                            "the take's backward: the slab's 2 float "
                            "gradients put into full-width zeros (tile 0)"),
    "slab_put transpose": ("slab_take",
                           "the put's backward: a take of the 2 float "
                           "gradients and a put of zeros, two launches "
                           "(tile 0)"),
    "spatial_grid_contrib": ("spatial_grid_contrib",
                             "the parsed Cornell box's whole grid (64 x 63 "
                             "x 64 voxels x 2 lights x 128 probes), one "
                             "launch"),
    "spatial_light_pick": ("spatial_light_pick",
                           "bounce 0's pick in a full-width step (tile 2) "
                           "of the dragon scene file, spatial grid"),
    "spatial_pmf_lookup": ("spatial_pmf_lookup",
                           "bounce 1's lookup in that step"),
    "film_add_samples triangle": ("film_add_samples",
                                  "the parsed Cornell box's splat, 64^2 "
                                  "samples, PixelFilter triangle (16 taps)"),
    "film_add_samples gaussian": ("film_add_samples",
                                  "the same, PixelFilter gaussian"),
    "film_add_samples mitchell": ("film_add_samples",
                                  "the same, PixelFilter mitchell"),
    "film_add_samples_bwd triangle": ("film_add_samples_bwd",
                                      "the radiance gradient of the "
                                      "triangle Cornell splat"),
    "film_add_samples_bwd gaussian": ("film_add_samples_bwd",
                                      "the same, PixelFilter gaussian"),
    "film_add_samples_bwd mitchell": ("film_add_samples_bwd",
                                      "the same, PixelFilter mitchell"),
    "film_add_samples triangle full width": (
        "film_add_samples", "a full-width step's splat of the dragon scene "
        "file (2^18 samples, 1024^2 film), PixelFilter triangle (16 taps), "
        "L2 evicted before each launch"),
    "film_add_samples gaussian full width": (
        "film_add_samples", "the same, PixelFilter gaussian"),
    "film_add_samples mitchell full width": (
        "film_add_samples", "the same, PixelFilter mitchell"),
    "film_add_samples_bwd triangle full width": (
        "film_add_samples_bwd", "the radiance gradient of that full-width "
        "splat's backward, PixelFilter triangle, the film's gradient warm "
        "in L2 as the backward leaves it"),
    "film_add_samples_bwd gaussian full width": (
        "film_add_samples_bwd", "the same, PixelFilter gaussian"),
    "film_add_samples_bwd mitchell full width": (
        "film_add_samples_bwd", "the same, PixelFilter mitchell"),
    "spatial_grid_contrib dragon file": (
        "spatial_grid_contrib", "the dragon scene file's whole grid (64 x "
        "11 x 64 voxels x 2 lights x 128 probes), one launch"),
    "quadric_closest": ("quadric_closest",
                        "2^18 seeded rays against the 16-quadric table "
                        "(tools/quadric_work.py)"),
    "quadric_any": ("quadric_any", "the same rays, any hit"),
    "build_interaction quadrics": ("build_interaction",
                                   "the quadric branch: those rays' closest "
                                   "hits (16 quadrics over a triangle)"),
    "quadric_closest testball": ("quadric_closest",
                                 "camera rays of a full-width testball-matte "
                                 "step (tile 2, 2^18 lanes, one sphere)"),
    "quadric_any testball": ("quadric_any",
                             "the first shadow rays of that step"),
    "build_interaction testball": ("build_interaction",
                                   "the camera hits of that step (sphere "
                                   "and floor lanes)"),
    "quadric_closest glass": ("quadric_closest",
                              "the call of a full-width testball-glass "
                              "step (tile 2, 2^18 lanes) with the most rays "
                              "leaving the ball from inside"),
    "build_interaction glass": ("build_interaction",
                                "the hits of that call, back-side sphere "
                                "hits among them"),
    "quadric_any roughglass": ("quadric_any",
                               "the shadow rays of a full-width "
                               "testball-roughglass step (tile 2) with the "
                               "most starting inside the ball"),
    "row_gather material rows W=32": ("row_gather",
                                      "the render: 2^18 lanes' material "
                                      "rows of 32 float32 (two lobes), "
                                      "bounce 0 of a full-width "
                                      "testball-plastic step"),
    "row_gather material rows W=96": ("row_gather",
                                      "the render: 2^18 lanes' material "
                                      "rows of 96 float32 (Disney's six "
                                      "lobes), bounce 0 of a full-width "
                                      "testball-disney step"),
    "row_gather material rows W=112": ("row_gather",
                                       "the render: 2^18 lanes' material "
                                       "rows of 112 float32 (a mix of "
                                       "substrate and Disney), bounce 0 of "
                                       "a full-width step of that ball"),
    "atlas_lookup_ewa testball-textured": (
        "atlas_lookup_ewa", "mean of the calls of a full-width "
        "testball-textured step (tile 2): the ball's and the floor's "
        "imagemaps, quad rows"),
    "infinite_sample": ("infinite_sample",
                        "bounce 0's NEE in a full-width bathroom step (tile "
                        "2, 2^18 lanes, 1920 x 1080)"),
    "infinite_escape": ("infinite_escape",
                        "the camera rays of that step (weight 1)"),
    "infinite_escape mis": ("infinite_escape",
                            "bounce 1's rays of that step, MIS against the "
                            "grid's pmfs"),
    "infinite_escape envmap-dof": ("infinite_escape",
                                   "the camera rays of a full-width "
                                   "envmap-dof step at 1024^2 (tile 0, the "
                                   "sky in view; weight 1)"),
    "spatial_grid_contrib_lights": (
        "spatial_grid_contrib_lights", "the bathroom's whole grid (35 x 21 "
        "x 64 voxels, 2 sphere, 2 triangle and 1 infinite lights), one "
        "launch"),
    "spatial_grid_contrib_lights point": (
        "spatial_grid_contrib_lights", "tools/light_work.py light_scene's "
        "point light alone, over MIXED_SCENE's grid (64 x 32 x 64 voxels)"),
    "spatial_grid_contrib_lights distant": (
        "spatial_grid_contrib_lights", "light_scene's distant light alone"),
    "spatial_grid_contrib_lights sphere": (
        "spatial_grid_contrib_lights", "light_scene's full sphere alone "
        "(the cone from outside)"),
    "spatial_grid_contrib_lights clipped sphere": (
        "spatial_grid_contrib_lights", "light_scene's clipped two-sided "
        "sphere alone (uniform area)"),
    "spatial_grid_contrib_lights disk": (
        "spatial_grid_contrib_lights", "light_scene's disk alone"),
    "spatial_grid_contrib_lights cylinder": (
        "spatial_grid_contrib_lights", "light_scene's cylinder alone"),
    "spatial_grid_contrib_lights triangle": (
        "spatial_grid_contrib_lights", "light_scene's triangle light alone "
        "(two triangles; the triangle kernel's code)"),
    "spatial_grid_contrib_lights infinite": (
        "spatial_grid_contrib_lights", "light_scene's sky alone"),
}
# the kernels a testball's CLI render must launch (phases 16-18)
TESTBALL_NEED = ("quadric_closest", "quadric_any", "build_interaction")
# phase 19: the scenes of the lights through the CLI and in process, as
# written, each against its golden; the kernels each one's parse and
# render must launch
LIGHT_SCENES = ("veach-mis", "envmap-dof", "bathroom")
LIGHT_NEEDS = {
    "veach-mis": (("spatial_grid_contrib_lights",),
                  ("quadric_closest", "quadric_any", "spatial_light_pick")),
    "envmap-dof": ((), ("infinite_sample", "infinite_escape",
                        "quadric_closest")),
    "bathroom": (("spatial_grid_contrib_lights",),
                 ("infinite_sample", "infinite_escape", "quadric_closest",
                  "atlas_lookup_ewa", "spatial_light_pick")),
}
# the full-width bathroom, 1 sample
BATH_RES = (1920, 1080)
# the rows of K12's lights kernel on each branch: row key -> the light of
# tools/light_work.py's MIXED_SCENE that it computes alone (light_scene),
# over the mixed scene's grid
K12_BRANCHES = {
    "spatial_grid_contrib_lights point": "point",
    "spatial_grid_contrib_lights distant": "distant",
    "spatial_grid_contrib_lights sphere": "full sphere (cone)",
    "spatial_grid_contrib_lights clipped sphere": "clipped sphere",
    "spatial_grid_contrib_lights disk": "disk",
    "spatial_grid_contrib_lights cylinder": "cylinder",
    "spatial_grid_contrib_lights triangle": "triangle",
    "spatial_grid_contrib_lights infinite": "infinite"}
# the material testballs of phase 17
TESTBALLS = ("glass", "mirror", "plastic", "metal", "roughglass",
             "roughmetal", "textured")
# phase 18: the testballs with a golden, and the balls without one
# (tools/profile_step.py BALLS) rendered at 128^2, 4 spp
LAYERED = ("substrate", "disney")
PLAIN_BALLS = ("translucent", "uber", "mix")
BALL_RES, BALL_SPP = (128, 128), 4
# the pixel filters the parsed Cornell box is rendered with (no file of
# scenes/ names a PixelFilter)
FILTER_KINDS = ("triangle", "gaussian", "mitchell")
REPO = os.path.dirname(os.path.abspath(__file__))
# the rows of the kernels line whose kernel time (one of the times behind
# it) was taken by CUDA events around the call, the profiler having lost
# every record of the kernel in three traces (kernel_time): ms_by "queued"
QUEUED_ROWS = set()
CORNELL_PBRT = os.path.join(REPO, "scenes", "cornell-box.pbrt")
CORNELL_GOLDEN = os.path.join(REPO, "tests", "goldens", "cornell-box.npz")
# the rows whose launches are counted in the dragon train step
TRAIN_ROWS = ("film_add_samples_bwd", "atlas_lookup_ewa_bwd",
              "row_gather_bwd", "slab_take transpose", "slab_put transpose")
# the kernels the matte render runs (no texture, no slab at its widths)
MATTE_PATH = ("sample_1d", "sample_2d", "traverse16_closest",
              "traverse16_any", "build_interaction", "film_add_samples",
              "row_gather")
# operations a lane does, for the bounds of K2 and K3 (32-bit integer and
# float operations both counted at one instruction each): the sampler's hash
# (5 mixing rounds of 7 operations, plus the 2D dimension's 32-step Sobol'
# loop), K2's rebuild of the surface frame; K1's and K5's bounds count the
# work of their inputs (tools/traverse_work.py, tools/atlas_work.py)
LANE_OPS = {"sample_1d": 45, "sample_2d": 190, "build_interaction": 300}


def log(msg):
    print(msg, flush=True)


def bound(moved, ops=0.0):
    """-> dict(bound_ms, bound_by): the larger of ``moved`` bytes over
    the H100 SXM's device-memory rate and ``ops`` operations over its
    float32 instruction rate without FMAs (tools/traverse_work.py)."""
    from rustracer_tpu_torch.tools.traverse_work import (PEAK_BYTES_PER_S,
                                                         PEAK_OPS_PER_S)
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def k2_off(field, a, b):
    """-> bool mask of K2's lanes where ``field`` of the kernel (a) and the
    plain version (b) disagree: 1e-5 absolute or relative, p_error (gamma
    times |p|, 1e-7 to 1e-6 a lane) 1e-5 relative alone."""
    d = (a - b).abs()
    if field == "p_error":
        return d > 1e-5 * b.abs() + 1e-30
    return (d > 1e-5) & (d > 1e-5 * b.abs())


def kernel_time(row, fn, reps, names, cold=False):
    """The device time of the kernels ``names`` in one call of ``fn`` for
    the kernels line's row ``row`` (tools/timing.py device_ms, L2 cold
    where ``cold``): torch.profiler's records, or where three traces lost
    them all, CUDA events around the call, and the row then reads ms_by
    "queued" (QUEUED_ROWS)."""
    from rustracer_tpu_torch.tools.timing import device_ms
    ms, by = device_ms(fn, reps, names, cold)
    if by != "profiler":
        QUEUED_ROWS.add(row)
        log(f"{row}: the profiler lost every record of {names} in 3 traces; "
            f"{ms:.4f} ms by CUDA events around the call")
    return ms


def both(fn, kernel, reps=20, *, row):
    """-> (kernel output, plain output, kernel ms, plain ms): the device
    time of the kernel named ``kernel`` (``kernel_time`` for row ``row``),
    and CUDA events around ``reps`` plain calls (the host's issue time
    included where the plain version is host-bound)."""
    from rustracer_tpu_torch.cuda import plain_reference
    from rustracer_tpu_torch.tools.timing import events_ms
    out = fn()
    with plain_reference():
        ref = fn()
        plain_ms = events_ms(fn, reps)
    return out, ref, kernel_time(row, fn, reps, kernel), plain_ms


def check_kernels(ctx, cam, film, sampler, renderer, results):
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.accel.traverse16 import traverse16
    from rustracer_tpu_torch.scene.tables import build_interaction
    from rustracer_tpu_torch.tools import traverse_work as TW
    from rustracer_tpu_torch.tools.bench_step_kernels import k4_moved
    from rustracer_tpu_torch.tools.timing import cold_ms, events_ms

    dev = ctx.geom.tv_p.device
    px, py, valid = renderer.tiles[len(renderer.tiles) // 2]
    pixel_idx = (py.long() * RES[0] + px.long())
    sample_idx = torch.full_like(pixel_idx, 3)
    pixel_xy = torch.stack([px, py], -1).float()

    # K3: sampler dims, bit-equal
    for name, fn in (("sample_1d", lambda: sampler.get_1d(pixel_idx,
                                                          sample_idx, 5)),
                     ("sample_2d", lambda: sampler.get_2d(pixel_idx,
                                                          sample_idx, 6))):
        out, ref, ms, pms = both(fn, "sample_kernel", row=name)
        if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"{name}: kernel and plain differ in bits")
        results[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms,
                             **bound(nbytes(pixel_idx, sample_idx, out),
                                     LANES * LANE_OPS[name]))
        log(f"[3] {name}: bit-equal on {LANES} lanes; kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms, bound {results[name]['bound_ms']:.4f} ms")

    # camera rays of this tile and their hits (K2's and K4's inputs)
    p_film = pixel_xy + sampler.get_2d(pixel_idx, sample_idx, 0)
    cam_ray = cam.generate_ray_differential(p_film)
    hit, t, tid = traverse16(ctx.geom, cam_ray.o, cam_ray.d, cam_ray.t_max,
                             any_hit=False)
    prim = torch.where(hit, tid + ctx.geom.n_quadrics, 0)
    log(f"[3] camera rays hit {hit.float().mean().item():.4f} of the tile")

    # K1: closest and any hit on the camera rays, bounce rays from their
    # hits and a 2^16-lane slab with dead lanes, bit-equal to the plain walk
    waves = TW.wavefronts(ctx, cam, sampler, renderer.tiles)
    if not bool((waves["slab"].t_max <= 0).any()):
        raise AssertionError("the slab case holds no dead lane")
    for name, any_hit in (("traverse16_closest", False),
                          ("traverse16_any", True)):
        full = []
        for label, ray in waves.items():
            ref, work = TW.k1_work(ctx.geom, ray, any_hit)
            out = traverse16(ctx.geom, ray.o, ray.d, ray.t_max,
                             any_hit=any_hit, with_counts=True)
            if not TW.equal_outputs(out, ref):
                raise AssertionError(f"{name} {label}: hit, prim, t bits or "
                                     "counts differ from the plain walk")

            def fn(ray=ray):
                return traverse16(ctx.geom, ray.o, ray.d, ray.t_max,
                                  any_hit=any_hit)
            ms = events_ms(fn, 20)
            with K.plain_reference():
                pms = events_ms(fn, 1)
            bound_ms, bound_by = TW.k1_bound(work)
            n = work["rays"]
            log(f"[3] {name} {label}: {n} rays ({int((ray.t_max <= 0).sum())}"
                f" dead), bit-equal with counts {out[3].tolist()}; kernel "
                f"{ms:.4f} ms ({n / ms * 1e-6:.3f} G rays/s), plain "
                f"{pms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
                f"{100 * bound_ms / ms:.2f}% of it")
            if label != "slab":
                full.append((ms, pms, bound_ms, bound_by))
        results[name] = dict(
            max_abs_err=0.0, ms=float(np.mean([f[0] for f in full])),
            plain_ms=float(np.mean([f[1] for f in full])),
            bound_ms=float(np.mean([f[2] for f in full])),
            bound_by=full[0][3])

    # K2: every interaction field within 1e-5 abs or rel (p_error rel)
    def k2():
        return build_interaction(ctx.geom, cam_ray, hit, t, prim)
    out, ref, ms, pms = both(k2, "build_interaction_kernel",
                             row="build_interaction")
    err = 0.0
    for f in ("p", "p_error", "n", "uv", "dpdu", "dpdv", "ns", "ss", "ts",
              "dndu", "dndv", "wo"):
        a, b = getattr(out, f), getattr(ref, f)
        d = (a - b).abs()
        bad = k2_off(f, a, b)
        if bad.any():
            raise AssertionError(f"build_interaction: {f} differs on "
                                 f"{int(bad.sum())} lanes, max {d.max()}")
        err = max(err, d.max().item())
    for f in ("material", "arealight", "prim_id"):
        if not torch.equal(getattr(out, f), getattr(ref, f)):
            raise AssertionError(f"build_interaction: {f} differs")
    # the lanes' rays and hits in, every field out, and the shading row of
    # each distinct triangle hit
    rows = torch.unique(prim[hit]).numel()
    moved = nbytes(cam_ray.o, cam_ray.d, cam_ray.t_max, hit, t, prim) \
        + nbytes(*[getattr(out, f) for f in (
            "p", "p_error", "n", "uv", "dpdu", "dpdv", "ns", "ss", "ts",
            "dndu", "dndv", "wo", "material", "arealight", "prim_id")]) \
        + rows * ctx.geom.t_shade.shape[1] * 4
    results["build_interaction"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms,
        **bound(moved, LANES * LANE_OPS["build_interaction"]))
    log(f"[3] build_interaction: fields max abs err {err:.3g}; kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{results['build_interaction']['bound_ms']:.4f} ms")

    # K4: splat into the full film, bit for bit (box 0.5: a pixel takes at
    # most two taps, and a + b == b + a); timed with L2 evicted before each
    # launch, as a render's one splat a step finds it
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rad = torch.rand((LANES, 3), generator=gen, device=dev) * 4.0

    out = film.add_samples(film.init_state(dev), p_film, rad, valid=valid)
    with K.plain_reference():
        ref = film.add_samples(film.init_state(dev), p_film, rad, valid=valid)
    acc = film.init_state(dev)

    def k4():
        return film.add_samples(acc, p_film, rad, valid=valid)
    ms = kernel_time("film_add_samples", k4, 20, "film_add_kernel",
                     cold=True)
    with K.plain_reference():
        pms = cold_ms(k4, 20)
    d = (out.rgb - ref.rgb).abs()
    if not (torch.equal(out.rgb.view(torch.int32), ref.rgb.view(torch.int32))
            and torch.equal(out.wsum.view(torch.int32),
                            ref.wsum.view(torch.int32))):
        raise AssertionError(f"film_add_samples differs in bits from the "
                             f"plain splat, max {d.max()}")
    # samples in; each pixel they touch read and written once (16 bytes)
    results["film_add_samples"] = dict(
        max_abs_err=d.max().item(), ms=ms, plain_ms=pms,
        **bound(k4_moved(film, p_film, rad, valid)))
    log(f"[3] film_add_samples: bit-equal with the plain splat; L2 "
        f"evicted before each launch: kernel {ms:.4f} ms, plain {pms:.4f} "
        f"ms, bound {results['film_add_samples']['bound_ms']:.4f} ms "
        f"({100 * results['film_add_samples']['bound_ms'] / ms:.1f}%)")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing runs on the CPU")
    from rustracer_tpu_torch import cuda as K

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    path = K.library_path()
    K.library()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
        f"{path}")
    run(torch.device("cuda:0"), card)


def camera_tile(cam, sampler, tile, sample):
    """-> (lanes, camera rays with the sampler's differential scale) of one
    renderer tile at sample index ``sample``."""
    from rustracer_tpu_torch.render.renderer import Lanes
    px, py, _ = tile
    pix = py.long() * RES[0] + px.long()
    lanes = Lanes(pixel_idx=pix, sample_idx=torch.full_like(pix, sample))
    p_film, _, _ = sampler.get_camera_sample(
        torch.stack([px, py], -1).float(), lanes.pixel_idx,
        lanes.sample_idx)
    ray = cam.generate_ray_differential(p_film)
    return lanes, ray.scaled_differentials(1.0 / np.sqrt(sampler.spp))


def check_atlas(ctx, cap, results):
    """K5 on the inputs of its four calls in one full-width textured step
    (tile 2), both texel layouts; timed and bounded on the quad rows the
    render uses."""
    from rustracer_tpu_torch.scene import atlas as A
    from rustracer_tpu_torch.tools.atlas_work import k5_bound, k5_work

    flat = A.atlas_texels(ctx.textures["images"]).to(cap["k5"][0]["reg"]
                                                     .device)
    rows = []
    for li, c in enumerate(cap["k5"]):
        if not c["quad"]:
            raise AssertionError("the hero atlas should use the quad rows")
        reg, si = c["reg"], c["si"]
        outs = []
        for label, q, tex in (("quad rows (T, 12)", True, c["texels"]),
                              ("texels (T, 3)", False, flat)):
            def fn(q=q, tex=tex):
                return A.atlas_lookup_ewa(tex, c["meta"], c["levels"],
                                          c["regs"], reg, si, quad=q)
            out, ref, ms_k, ms_p = both(fn, "atlas_ewa_kernel",
                                        row="atlas_lookup_ewa")
            d = (out - ref).abs().max(-1).values
            off = (d > 1e-5).float().mean().item()
            work = k5_work(c["meta"], c["levels"], c["regs"], reg, si, q)
            bound_ms, bound_by = k5_bound(work)
            log(f"[3] atlas_lookup_ewa call {li} {label}: {reg.shape[0]} "
                f"lanes, {work['textured'] / reg.shape[0]:.4f} textured, "
                f"{work['rows']} distinct rows read; max abs err "
                f"{d.max().item():.3g}, lanes beyond 1e-5 {off:.3g} "
                f"(<= 1e-3); kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), "
                f"{100 * bound_ms / ms_k:.1f}%")
            if off > 1e-3 or bool(out[reg < 0].any()):
                raise AssertionError(f"atlas_lookup_ewa {label} differs")
            if q:
                rows.append((ms_k, ms_p, bound_ms, bound_by,
                             d.max().item()))
            outs.append(out)
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError("atlas_lookup_ewa: the two layouts differ")
    by = [r[3] for r in rows]
    results["atlas_lookup_ewa"] = dict(
        max_abs_err=max(r[4] for r in rows),
        ms=float(np.mean([r[0] for r in rows])),
        plain_ms=float(np.mean([r[1] for r in rows])),
        bound_ms=float(np.mean([r[2] for r in rows])),
        bound_by=max(set(by), key=by.count))


def check_compaction(ctx, cam, sampler, integ, tile, cap, results):
    """K6 on the alive mask of the full-width step ``cap`` and of
    ``tile`` after bounce 0; K7 on that tile's state."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.integrators.path import SLAB_FIELDS
    from rustracer_tpu_torch.ops import compact as C
    from rustracer_tpu_torch.render.sampler import DimAllocator
    from rustracer_tpu_torch.tools.bench_step_kernels import k7_moved
    from rustracer_tpu_torch.tools.timing import queued_ms

    lanes, ray = camera_tile(cam, sampler, tile, 0)
    st = integ.bounce0(ctx, ray, lanes, sampler, DimAllocator())
    step_alive = cap["k6"][0]
    # bit-equal on both masks, three calls in a row each: every call finds
    # the status words the one before left at 0
    for label, alive in (("step (tile 2)", step_alive), ("tile 0", st.alive)):
        with K.plain_reference():
            ref = C.alive_first_order(alive)
        n0 = K.LAUNCHES["alive_first_order"]
        for _ in range(3):
            out = C.alive_first_order(alive)
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise AssertionError(f"alive_first_order differs from the "
                                     f"plain sort on the {label} mask")
        if K.LAUNCHES["alive_first_order"] != n0 + 3:
            raise AssertionError("alive_first_order is not one launch a "
                                 "call")
        log(f"[3] alive_first_order {label} mask: {int(ref[2])} of "
            f"{alive.shape[0]} lanes alive, bit-equal three calls in a row")
    # timed on the step's mask
    out, _, ms, pms = both(lambda: C.alive_first_order(step_alive),
                           "alive_first_kernel", row="alive_first_order")
    q_ms = queued_ms(lambda: C.alive_first_order(step_alive), 20)
    lib_ms = queued_ms(lambda: torch.argsort(~step_alive, stable=True), 20)
    results["alive_first_order"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=pms, library_ms=lib_ms,
        **bound(nbytes(step_alive, *out)))
    log(f"[3] alive_first_order step mask: kernel {ms:.4f} ms ({q_ms:.4f} "
        f"ms queued behind the host), plain {pms:.4f} ms, "
        f"torch.argsort(~alive, stable=True) {lib_ms:.4f} ms, bound "
        f"{results['alive_first_order']['bound_ms']:.4f} ms")

    # K7 on tile 0's state, into a slab of its alive-first order
    n = st.alive.shape[0]
    order, _, n_alive = C.alive_first_order(st.alive)
    w = integ.slab_width(n, int(n_alive.item()))
    w = w if w < n else n // 2

    fields = [getattr(st, f).contiguous() for f in SLAB_FIELDS] \
        + [lanes.pixel_idx, lanes.sample_idx]
    subs, ref, ms, pms = both(lambda: C.slab_take(fields, order, w),
                              "slab_kernel", row="slab_take")
    if not all(torch.equal(a, b) for a, b in zip(subs, ref)):
        raise AssertionError("slab_take differs from the plain take")
    # the slab's order entries, and each field's slab read and written once
    moved = k7_moved(fields, w)
    results["slab_take"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms,
                                **bound(moved))
    log(f"[3] slab_take: {len(fields)} fields into a {w}-lane slab, "
        f"equal; kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{results['slab_take']['bound_ms']:.4f} ms "
        f"({100 * results['slab_take']['bound_ms'] / ms:.1f}%)")
    zeros = [torch.zeros_like(f) for f in fields]
    out = C.slab_put([z.clone() for z in zeros], subs, order, w)
    with K.plain_reference():
        ref = C.slab_put([z.clone() for z in zeros], subs, order, w)
    if not all(torch.equal(a, b) for a, b in zip(out, ref)):
        raise AssertionError("slab_put differs from the plain put")
    _, _, ms, pms = both(lambda: C.slab_put(zeros, subs, order, w),
                         "slab_kernel", row="slab_put")
    results["slab_put"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms,
                               **bound(moved))
    log(f"[3] slab_put: equal; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
        f"bound {results['slab_put']['bound_ms']:.4f} ms "
        f"({100 * results['slab_put']['bound_ms'] / ms:.1f}%)")


def check_gather(geom, cap, results):
    """K8 through the gather microbenchmark's entry point (its own path,
    counted), on the dragon's bvh16_table, and at the render's shape: the
    material parameter rows of the full-width step's bounce 0."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.ops.gather import row_gather
    from rustracer_tpu_torch.tools import bench_gather
    from rustracer_tpu_torch.tools.timing import queued_ms

    torch.cuda.synchronize()
    K.reset_launches()
    r = bench_gather.main([])
    n = K.LAUNCHES["row_gather"]
    log(f"[3] row_gather: the tool's defaults (2^17 x 128 table, 2^20 rows) "
        f"launched it {n} times; equal={r['equal']}")
    if n <= 0 or not r["equal"]:
        raise AssertionError("the gather tool did not run K8 or it differs")
    # the plain version is the library call, table[idx]; 2^20 indices
    # in, 2^20 rows of 512 bytes read and written
    results["row_gather"] = dict(max_abs_err=0.0, ms=r["ms"], ms_by="events",
                                 plain_ms=r["plain_ms"],
                                 library_ms=r["plain_ms"],
                                 **bound((1 << 20) * (4 + 2 * 512)))
    table = geom.bvh16_table
    gen = torch.Generator(device=table.device)
    gen.manual_seed(5)
    idx = torch.randint(0, table.shape[0], (LANES,), generator=gen,
                        device=table.device, dtype=torch.int32)
    r = bench_gather.measure(table, idx, reps=20)
    for line in bench_gather.report(r, "[3] bvh16_table "):
        log(line)
    if not r["equal"]:
        raise AssertionError("row_gather differs on the bvh16_table")

    tab, mid = cap["k8"][0]
    out, ref, ms, pms = both(lambda: row_gather(tab, mid),
                             "row_gather_kernel",
                             row="row_gather material rows")
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("row_gather differs on the material rows")
    lib_ms = queued_ms(lambda: torch.index_select(tab, 0, mid), 20)
    # the lanes' ids in, their rows out, each distinct row read once
    rows = torch.unique(mid).numel()
    results["row_gather material rows"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=pms, library_ms=lib_ms,
        **bound(nbytes(mid, out) + rows * tab.shape[1] * 4))
    log(f"[3] row_gather material rows ({tab.shape[0]} x {tab.shape[1]} "
        f"float32, {mid.shape[0]} lanes, {rows} distinct): equal; kernel "
        f"{ms:.4f} ms, plain table[idx.long()] {pms:.4f} ms, "
        f"torch.index_select {lib_ms:.4f} ms, bound "
        f"{results['row_gather material rows']['bound_ms']:.4f} ms")


def compare_crop(label, renderer, film, ctx):
    """Kernel path against the all-plain path, 1 spp, golden tolerance.
    -> (kernel-run slab tiers, plain-run slab tiers)."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.integrators import path as P
    runs = []
    for plain in (False, True):
        P.reset_tiers()
        t0 = time.perf_counter()
        with K.plain_reference() if plain else contextlib.nullcontext():
            img = film.to_image(renderer.render_state(ctx, sample_stop=1))
        torch.cuda.synchronize()
        runs.append((img, time.perf_counter() - t0, dict(P.TIERS)))
    (img_k, t_k, tiers_k), (img_p, t_p, tiers_p) = runs
    err = (img_k - img_p).abs()
    scale = max(img_p.mean().item(), 1e-3)
    mean_err = err.mean().item() / scale
    p99 = float(np.percentile(err.cpu().numpy(), 99)) / scale
    log(f"{label} crop {tuple(img_k.shape)} 1 spp: mean err {mean_err:.3g} "
        f"(<= 2e-3), p99 {p99:.3g} (<= 2e-2); kernel path {t_k:.3f} s, "
        f"plain path {t_p:.3f} s; slab tiers kernel {tiers_k}, plain "
        f"{tiers_p}")
    if not bool(torch.isfinite(img_k).all()):
        raise AssertionError("non-finite radiance in the crop")
    if not (mean_err <= 2e-3 and p99 <= 2e-2):
        raise AssertionError("kernel and plain renders disagree")
    return tiers_k, tiers_p


def step_launches(renderer, ctx, tile):
    """Launches of each kernel in one full-width step (sample 1) of
    ``tile``, counted from 0."""
    from rustracer_tpu_torch import cuda as K
    px, py, v = tile
    fs = renderer.film.init_state(renderer.device)
    torch.cuda.synchronize()
    K.reset_launches()
    renderer.step(ctx, fs, px, py, 1, v)
    torch.cuda.synchronize()
    return dict(K.LAUNCHES)


def render_counted(label, renderer, film, ctx, samples, card, depth=5,
                   res=RES):
    """One counted render of the main path -> (launches, tiers, image,
    camera rays/s)."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.integrators import path as P
    torch.cuda.synchronize()
    K.reset_launches()
    P.reset_tiers()
    t0 = time.perf_counter()
    img = film.to_image(renderer.render_state(ctx, sample_stop=samples))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, tiers = dict(K.LAUNCHES), dict(P.TIERS)
    mean = img.mean().item()
    log(f"{label} render {res[0]}x{res[1]} {samples} samples depth {depth}: "
        f"{wall:.3f} s wall, {res[0] * res[1] * samples / wall:.1f} camera "
        f"rays/s, image mean {mean:.5f} on {card}")
    log(f"{label} launches: {launches}; slab tiers {tiers}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite radiance in the render")
    if not mean > 1e-4:
        raise AssertionError(f"render is black (mean {mean})")
    return launches, tiers, img, res[0] * res[1] * samples / wall


def check_backward(renderer, ctx, results):
    """K9, K10 and K11 on the recorded backward pass of one full-width
    textured step (tile 2), K7's transposes on that of tile 0, each
    against its plain version, timed, bounded and with its yardstick."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.ops import compact as C
    from rustracer_tpu_torch.ops.gather import row_gather_bwd
    from rustracer_tpu_torch.scene import atlas as A
    from rustracer_tpu_torch.tools.atlas_work import (k10_atomics, k10_work,
                                                      k5_bound)
    from rustracer_tpu_torch.tools.bench_step_kernels import (
        capture_grad_step, k4_touched, k7_moved)
    from rustracer_tpu_torch.tools.timing import queued_ms

    cap = capture_grad_step(renderer, ctx, renderer.tiles[2])
    slab = capture_grad_step(renderer, ctx, renderer.tiles[0])
    log(f"[9] recorded the backward of textured tile 2: "
        f"{len(cap['k9'])} K9, {len(cap['k10'])} K10, {len(cap['k11'])} "
        f"K11 calls; of tile 0: {len(slab['take_t'])} take and "
        f"{len(slab['put_t'])} put transposes")

    # K9, bit for bit
    (film, g_acc, p_film, rad, valid), _ = cap["k9"][0]
    out, ref, ms, pms = both(
        lambda: film.add_samples_bwd(g_acc, p_film, rad, valid),
        "film_add_bwd_kernel", row="film_add_samples_bwd")
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("film_add_samples_bwd differs in bits from "
                             "the plain gather")
    h, w = g_acc.shape[:2]
    iy, ix, fw, ok = next(film.taps(p_film, valid, h, w))
    iy, ix = iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long()
    fw = torch.where(ok, fw, 0.0)[:, None]
    g_rgb = g_acc[..., :3]
    lib_ms = queued_ms(lambda: g_rgb[iy, ix] * fw, 20)
    # samples in, their gradients out, each touched pixel's 16 bytes read
    results["film_add_samples_bwd"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=pms, library_ms=lib_ms,
        **bound(nbytes(p_film, rad, out) + valid.numel()
                + 16 * k4_touched(film, p_film, valid)))
    log(f"[9] film_add_samples_bwd: bit-equal on {p_film.shape[0]} samples; "
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms, g_rgb[iy, ix] * fw (one "
        f"tap) {lib_ms:.4f} ms, bound "
        f"{results['film_add_samples_bwd']['bound_ms']:.4f} ms")

    # K10 on its 4 calls, within 1e-5 of the plain result's max
    rows = []
    for i in range(len(cap["k10"])):
        (g, texels, meta, levels, regs, reg, si, qidx), _ = cap["k10"][i]

        def k10(g=g, texels=texels, meta=meta, levels=levels, regs=regs,
                reg=reg, si=si, qidx=qidx):
            return A.atlas_lookup_ewa_bwd(g, texels, meta, levels, regs, reg,
                                          si, qidx)
        out, ref, ms, pms = both(k10, "atlas_ewa_bwd_kernel",
                                 row="atlas_lookup_ewa_bwd")
        err = (out - ref).abs().max().item()
        top = ref.abs().max().item()
        work = k10_work(meta, levels, regs, reg, si, texels.shape[0])
        bound_ms, bound_by = k5_bound(work)
        atomics = k10_atomics(meta, levels, regs, reg, si, qidx is not None,
                              g, texels.shape[0])
        log(f"[9] atlas_lookup_ewa_bwd call {i}: {reg.shape[0]} lanes, "
            f"{work['textured']} textured, {texels.shape[0]} texels, quad "
            f"{qidx is not None}; max abs err {err:.3g} of max {top:.3g} "
            f"(<= 1e-5 of it); kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}); global atomics "
            f"(tools/atlas_work.py k10_atomics) {atomics}")
        if not err <= 1e-5 * top or not bool(torch.isfinite(out).all()):
            raise AssertionError("atlas_lookup_ewa_bwd differs from the "
                                 "plain backward")
        rows.append((ms, pms, bound_ms, bound_by, err))
    by = [r[3] for r in rows]
    results["atlas_lookup_ewa_bwd"] = dict(
        max_abs_err=max(r[4] for r in rows),
        ms=float(np.mean([r[0] for r in rows])),
        plain_ms=float(np.mean([r[1] for r in rows])),
        bound_ms=float(np.mean([r[2] for r in rows])),
        bound_by=max(set(by), key=by.count))

    # K11 on its 4 calls; the plain version is the library call,
    # index_add_ (atomics on the card too). A table entry sums some 10^5
    # lanes' gradients of both signs, so the two orders' rounding is held
    # to the sum of the terms' magnitudes (as tests/test_torch_cuda.py):
    # each entry within 1e-4 of it; the error against the plain result's
    # largest entry is printed beside
    rows = []
    for i in range(len(cap["k11"])):
        (g, idx, n_rows), _ = cap["k11"][i]
        out, ref, ms, pms = both(lambda g=g, idx=idx, n_rows=n_rows:
                                 row_gather_bwd(g, idx, n_rows),
                                 "row_gather_bwd_kernel",
                                 row="row_gather_bwd")
        with K.plain_reference():
            ref_abs = row_gather_bwd(g.abs(), idx, n_rows)
        d = (out - ref).abs()
        err, top = d.max().item(), ref.abs().max().item()
        of_abs = (d / ref_abs.clamp(min=1e-30)).max().item()
        log(f"[9] row_gather_bwd call {i}: {g.shape[0]} x {g.shape[1]} into "
            f"{n_rows} rows; max abs err {err:.3g}, {err / top:.3g} of the "
            f"plain result's max {top:.3g}, {of_abs:.3g} of its entry's "
            f"sum of magnitudes (<= 1e-4)")
        if not of_abs <= 1e-4:
            raise AssertionError("row_gather_bwd differs from index_add_")
        if not torch.equal(out.view(torch.int32),
                           row_gather_bwd(g, idx, n_rows).view(torch.int32)):
            raise AssertionError("row_gather_bwd: two launches differ in "
                                 "bits")
        b = bound(nbytes(g, idx, out))
        rows.append((ms, pms, b["bound_ms"], err))
        log(f"[9] row_gather_bwd call {i}: kernel {ms:.4f} ms, index_add_ "
            f"{pms:.4f} ms, bound {b['bound_ms']:.4f} ms")
    results["row_gather_bwd"] = dict(
        max_abs_err=max(r[3] for r in rows),
        ms=float(np.mean([r[0] for r in rows])),
        plain_ms=float(np.mean([r[1] for r in rows])),
        library_ms=float(np.mean([r[1] for r in rows])),
        bound_ms=float(np.mean([r[2] for r in rows])), bound_by="bytes")

    # K7 as its own transpose, bit for bit, on tile 0's slab
    (order, w, g_subs, shapes), _ = slab["take_t"][0]
    fields = [torch.empty(s_, dtype=d, device=order.device)
              for s_, d in shapes]
    out, ref, ms, pms = both(lambda: C.take_transpose(order, w, g_subs,
                                                      shapes), "slab_kernel",
                             row="slab_take transpose")
    if not all(torch.equal(a, b) for a, b in zip(out, ref)):
        raise AssertionError("the take's transpose differs from the plain")
    results["slab_take transpose"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=pms, **bound(k7_moved(fields, w)))
    log(f"[9] slab_take transpose: {len(g_subs)} gradients of a {w}-lane "
        f"slab, equal; K7 {ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{results['slab_take transpose']['bound_ms']:.4f} ms")
    (order, w, g_full), _ = slab["put_t"][0]
    out, ref, _, pms = both(lambda: C.put_transpose(order, w, g_full),
                            "slab_kernel", row="slab_put transpose")
    if not all(torch.equal(a, b) for a, b in zip(out[0] + out[1],
                                                 ref[0] + ref[1])):
        raise AssertionError("the put's transpose differs from the plain")
    # two K7 launches a call (the take, the put of zeros): their mean by
    # name, twice
    ms = 2 * kernel_time("slab_put transpose",
                         lambda: C.put_transpose(order, w, g_full), 20,
                         "slab_kernel")
    results["slab_put transpose"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=pms,
        **bound(2 * k7_moved(g_full, w)))
    log(f"[9] slab_put transpose: {len(g_full)} gradients, equal; K7 "
        f"{ms:.4f} ms (two launches), plain {pms:.4f} ms, bound "
        f"{results['slab_put transpose']['bound_ms']:.4f} ms")


def _finite(tensors):
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def cornell_train(dev, card):
    """3 counted train steps of the 256^2 Cornell with imagemap walls (the
    loss must fall, every gradient be finite), then its fwd+bwd rays/s."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.parallel.mesh import (float_leaves,
                                                   make_train_step)
    from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
    from rustracer_tpu_torch.scenes import build_cornell
    from rustracer_tpu_torch.tools import bench_fwdbwd

    ctx, cam, film, sampler, integ = build_cornell(imagemap_walls=(1, 2),
                                                   device=dev)
    config = RenderConfig(max_lanes=1 << 16)
    target = bench_fwdbwd.half_albedo_target(
        Renderer(integ.li, cam, film, sampler, config, device=dev), ctx,
        scale_const=True)
    step = make_train_step(integ.li, cam, film, sampler, lr=0.1,
                           config=config, device=dev)
    losses = []
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    for _ in range(3):
        new, loss = step(ctx, target, 0)
        old, _ = float_leaves(ctx.textures)
        grads = [(p - q) / 0.1 for p, q in
                 zip(old, float_leaves(new.textures)[0])]
        if not _finite(grads):
            raise AssertionError("non-finite Cornell gradient")
        losses.append(loss.item())
        ctx = new
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[10] Cornell 256^2 imagemap walls, 3 train steps (sample 0, lr "
        f"0.1) in {wall:.3f} s: losses {losses}; launches "
        f"{dict(K.LAUNCHES)}")
    if not (losses[0] > losses[1] > losses[2]):
        raise AssertionError(f"the Cornell loss did not fall: {losses}")
    r = bench_fwdbwd.bench_cornell(dev)
    log(f"[10] Cornell fwd+bwd (tools/bench_fwdbwd.py: 256^2 x "
        f"{bench_fwdbwd.SPP_BWD} spp, depth 5, compaction off): "
        f"{r['rays_per_s']:.1f} rays/s, best {r['best_s']:.4f} s of "
        f"{r['times_s']}, loss {r['loss']:.7g}, gradients finite "
        f"{r['grads_finite']}, on {card}")
    if not r["grads_finite"]:
        raise AssertionError("non-finite Cornell fwd+bwd gradient")


def dragon_train(dev, card, geometry, ctx, cam, sampler, integ):
    """One counted train step of the 1024^2 textured dragon with its wall
    time and peak memory; then the 1024 x 128 crop's gradients, kernel
    path against the all-plain path. -> the step's launches."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.integrators import path as P
    from rustracer_tpu_torch.parallel.mesh import (float_leaves, grad_errors,
                                                   make_train_step)
    from rustracer_tpu_torch.render.film import Film
    from rustracer_tpu_torch.render.filters import Filter
    from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
    from rustracer_tpu_torch.tools.bench_fwdbwd import half_albedo_target

    film = Film(full_resolution=RES, filter=Filter("box", 0.5, 0.5))
    config = RenderConfig(max_lanes=LANES)
    target = half_albedo_target(Renderer(integ.li, cam, film, sampler,
                                         config, device=dev), ctx)
    step = make_train_step(integ.li, cam, film, sampler, lr=0.1,
                           config=config, device=dev)
    step(ctx, target)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launches()
    P.reset_tiers()
    t0 = time.perf_counter()
    new, loss = step(ctx, target)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, tiers = dict(K.LAUNCHES), dict(P.TIERS)
    peak = torch.cuda.max_memory_allocated(dev)
    old, _ = float_leaves(ctx.textures)
    grads = [(p - q) / 0.1 for p, q in zip(old, float_leaves(
        new.textures)[0])]
    log(f"[11] dragon train step {RES[0]}x{RES[1]}, sample 0, 2^18-lane "
        f"tiles: {wall:.3f} s wall, loss {loss.item():.7g}, peak "
        f"torch.cuda.max_memory_allocated {peak} bytes "
        f"({peak / 2 ** 30:.3f} GiB), slab tiers {tiers}, on {card}")
    log(f"[11] launches: {launches}")
    if not (_finite(grads) and bool(torch.isfinite(loss))):
        raise AssertionError("non-finite dragon loss or gradient")
    if max(g.abs().max().item() for g in grads) <= 0:
        raise AssertionError("the dragon's gradient is zero")

    crop_film = Film(full_resolution=RES, crop_window=TEX_CROP,
                     filter=Filter("box", 0.5, 0.5))
    crop_config = RenderConfig(max_lanes=TEX_CROP_LANES)
    crop_target = half_albedo_target(Renderer(integ.li, cam, crop_film,
                                              sampler, crop_config,
                                              device=dev), ctx)
    crop_step = make_train_step(integ.li, cam, crop_film, sampler, lr=1.0,
                                config=crop_config, device=dev)
    runs = []
    for plain in (False, True):
        P.reset_tiers()
        with K.plain_reference() if plain else contextlib.nullcontext():
            new, loss = crop_step(ctx, crop_target)
        runs.append(([p - q for p, q in zip(old, float_leaves(
            new.textures)[0])], loss.item(), dict(P.TIERS)))
    (g_k, l_k, tiers_k), (g_p, l_p, tiers_p) = runs
    rel, elem = grad_errors(g_k, g_p)
    log(f"[11] crop {TEX_CROP} in 2^16-lane tiles: loss kernel {l_k:.7g}, "
        f"plain {l_p:.7g}; gradients ||d|| / ||g|| {rel:.3g} (<= 1e-3), "
        f"max |d| / max |g| {elem:.3g} (<= 1e-2); slab tiers kernel "
        f"{tiers_k}, plain {tiers_p}")
    if tiers_k[2] == 0 or tiers_k[4] == 0:
        raise AssertionError(f"the crop missed a slab tier: {tiers_k}")
    if not (rel <= 1e-3 and elem <= 1e-2 and _finite(g_k)):
        raise AssertionError("the crop's gradients differ from the plain "
                             "path's")
    return launches


def image_errors(img, ref):
    """-> (mean, 99th percentile) relative error of ``img`` against
    ``ref`` (numpy), as tests/test_golden.py measures them."""
    err = np.abs(img - ref)
    scale = max(float(ref.mean()), 1e-3)
    return float(err.mean()) / scale, float(np.percentile(err, 99)) / scale


def check_cornell_image(label, img):
    """The Cornell box against its golden image (mean 2e-3, p99 2e-2) and
    tests/test_golden.py's structural checks."""
    ref = np.load(CORNELL_GOLDEN)["img"]
    if img.shape != ref.shape or not np.isfinite(img).all():
        raise AssertionError(f"{label}: image {img.shape} not finite or not "
                             f"the golden's {ref.shape}")
    mean_err, p99 = image_errors(img, ref)
    h, w, _ = img.shape
    left = img[h // 4: 3 * h // 4, : w // 5]
    right = img[h // 4: 3 * h // 4, -w // 5:]
    yx = np.unravel_index(np.argmax(img.sum(-1)), (h, w))
    structure = (left[..., 0].mean() > 1.5 * left[..., 1].mean()
                 and right[..., 1].mean() > 1.5 * right[..., 0].mean()
                 and yx[0] < h // 3 and w // 4 < yx[1] < 3 * w // 4
                 and img.max() <= 20.0 and 0.05 < img.mean() < 1.0)
    log(f"{label} against tests/goldens/cornell-box.npz: mean err "
        f"{mean_err:.3g} (< 2e-3), p99 {p99:.3g} (< 2e-2); structure "
        f"{structure}")
    if not (mean_err < 2e-3 and p99 < 2e-2 and structure):
        raise AssertionError(f"{label}: the Cornell box differs from its "
                             "golden image")


def cornell_cli():
    """The Cornell box through the port's command line on the card, in a
    subprocess: its image read back with the port's reader and held to
    the golden image; the launches it prints must include K12 and K13."""
    from rustracer_tpu_torch.render.imageio import read_image
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "cornell.exr")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rustracer_tpu_torch.utils.cli",
             CORNELL_PBRT, "-o", out, "-v"], cwd=REPO, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"[12] cli: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"the CLI failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-4000:]}")
        img = read_image(out)
    launches = json.loads(next(
        line for line in proc.stdout.splitlines()
        if line.startswith("launches "))[len("launches "):])
    log(f"[12] python -m rustracer_tpu_torch.utils.cli "
        f"scenes/cornell-box.pbrt -o cornell.exr: {wall:.2f} s in all; "
        f"K12 {launches['spatial_grid_contrib']}, K13 "
        f"{launches['spatial_light_pick']} picks and "
        f"{launches['spatial_pmf_lookup']} lookups")
    if min(launches[k] for k in ("spatial_grid_contrib", "spatial_light_pick",
                                 "spatial_pmf_lookup")) <= 0:
        raise AssertionError("the CLI's render did not launch K12 and K13")
    check_cornell_image("[12] the CLI's image", img)


def parse_counted(label, path=None, text=None, dev="cuda"):
    """-> (bundle, the launches of the parse): ``path`` or ``text`` parsed
    on ``dev`` with the launch counts set to 0 before, and its phase
    timings printed."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.scene.api import parse_scene, parse_scene_string
    from rustracer_tpu_torch.utils import stats
    stats.init_stats()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    api = parse_scene(path, device=dev) if path else \
        parse_scene_string(text, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ph = stats.phases()
    log(f"{label} parsed in {wall:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in sorted(ph.items())))
    return api.scene, dict(K.LAUNCHES)


def check_grid_contrib(label, key, scene, bundle, launches, results):
    """K12 over the whole grid of ``bundle``'s (the parse of ``scene``)
    lights and bounds, one launch, against its plain version on the card (each sum within 1e-5
    relative, 1e-6 of the largest absolute), timed and bounded; its row
    ``results[key]``, its launches those of the scene's parse."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.scene import lightdistrib as LD
    from rustracer_tpu_torch.tools.timing import events_ms
    lt, dev = bundle.lights, bundle.device
    lo = bundle.geom.tv_p.min(0).values.cpu().numpy()
    hi = bundle.geom.tv_p.max(0).values.cpu().numpy()
    nv, _, ext = LD.voxels(lo, hi)
    halton = torch.as_tensor(LD._radical_inverse_table(LD.N_SAMPLES),
                             device=dev)

    def fn():
        return LD.grid_contrib(lt, lo, ext, nv, halton)
    n0 = K.LAUNCHES["spatial_grid_contrib"]
    out = fn()
    if K.LAUNCHES["spatial_grid_contrib"] != n0 + 1:
        raise AssertionError("spatial_grid_contrib is not one launch a grid")
    with K.plain_reference():
        ref = fn()
    d = (out - ref).abs()
    top = ref.abs().max().item()
    bad = (d > 1e-5 * ref.abs()) & (d > 1e-6 * top)
    v = int(np.prod(nv))
    log(f"{label} spatial_grid_contrib: {tuple(int(x) for x in nv)} voxels "
        f"x {lt.n_lights} lights x {LD.N_SAMPLES} probes in one launch (the "
        f"parse launched {launches['spatial_grid_contrib']}); max abs err "
        f"{d.max().item():.3g} of max {top:.3g}, {int(bad.sum())} sums "
        "beyond 1e-5 relative")
    if bad.any() or not bool(torch.isfinite(out).all()) \
            or launches["spatial_grid_contrib"] != 1:
        raise AssertionError("spatial_grid_contrib differs from its plain "
                             "version or the parse did not launch it once")
    ms = kernel_time(key, fn, 20, "grid_contrib_kernel")
    with K.plain_reference():
        pms = events_ms(fn, 3)
    probes = v * lt.n_lights * LD.N_SAMPLES
    moved = nbytes(halton, lt.l_tri_p, lt.l_tri_rev, lt.l_twosided,
                   lt.l_emit, lt.l_area) + v * lt.n_lights * 4
    b = bound(moved, probes * LD.K12_PROBE_OPS)
    results[key] = dict(
        max_abs_err=d.max().item(), ms=ms, plain_ms=pms,
        launches=launches["spatial_grid_contrib"],
        counted_in=f"the parse of {scene}", **b)
    # the lights kernel on the same table: a triangle row runs the
    # triangle kernel's code, so the same bits; its time beside the
    # triangle kernel's says whether a scene of triangle lights needs a
    # kernel of its own
    n0 = K.LAUNCHES["spatial_grid_contrib_lights"]
    lout = LD.grid_contrib_lights(lt, lo, ext, nv, halton)
    if K.LAUNCHES["spatial_grid_contrib_lights"] != n0 + 1 \
            or not torch.equal(lout, out):
        raise AssertionError("the lights kernel's triangle rows differ from "
                             "spatial_grid_contrib")
    lms = kernel_time(f"{key}, lights kernel",
                      lambda: LD.grid_contrib_lights(lt, lo, ext, nv, halton),
                      20, "grid_contrib_lights_kernel")
    log(f"{label} the same grid through spatial_grid_contrib_lights: bit "
        f"for bit; kernel {lms:.4f} ms against spatial_grid_contrib's "
        f"{ms:.4f} ms ({lms / ms:.3f}x)")
    log(f"{label} spatial_grid_contrib, the whole grid ({probes} probes): "
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {b['bound_ms']:.4f} "
        f"ms ({b['bound_by']}, {LD.K12_PROBE_OPS} operations a probe; "
        f"the per-chunk kernel's count of 42: "
        f"{bound(moved, probes * 42)['bound_ms']:.4f} ms), "
        f"{100 * b['bound_ms'] / ms:.1f}% of it")


def check_grid_picks(cap, results, launches):
    """K13's pick and lookup on their recorded inputs (a full-width step
    of the dragon scene file), bit for bit with the plain versions, timed
    and bounded; the pick's yardstick torch.searchsorted on the rows
    already gathered."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.scene import lightdistrib as LD
    from rustracer_tpu_torch.tools.timing import events_ms, queued_ms
    for i, ((grid, p, u), _) in enumerate(cap["pick"]):
        lid, pmf = LD.sample_light(grid, p, u)
        with K.plain_reference():
            rlid, rpmf = LD.sample_light(grid, p, u)
        if not (torch.equal(lid, rlid) and torch.equal(
                pmf.view(torch.int32), rpmf.view(torch.int32))):
            raise AssertionError(f"spatial_light_pick call {i} differs")
    for i, ((grid, p, q), _) in enumerate(cap["lookup"]):
        out = LD.pmf_lookup(grid, p, q)
        with K.plain_reference():
            ref = LD.pmf_lookup(grid, p, q)
        if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"spatial_pmf_lookup call {i} differs")
    (grid, p, u), _ = cap["pick"][0]
    n, n_l = p.shape[0], grid.n_lights
    flat = LD.voxel_index(grid, p)
    lid, _ = LD.sample_light(grid, p, u)
    rows = torch.unique(flat).numel()
    pairs = torch.unique(flat * n_l + lid.long()).numel()
    ms = kernel_time("spatial_light_pick",
                     lambda: LD.sample_light(grid, p, u), 20,
                     "light_pick_kernel")
    with K.plain_reference():
        pms = events_ms(lambda: LD.sample_light(grid, p, u), 20)
    gathered = grid.cdf[flat]
    lib_ms = queued_ms(lambda: torch.searchsorted(gathered, u[:, None],
                                                  right=True), 20)
    b = bound(n * (12 + 4 + 4 + 4) + rows * n_l * 4 + pairs * 4)
    results["spatial_light_pick"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=pms, library_ms=lib_ms,
        launches=launches["spatial_light_pick"],
        counted_in="the 1024^2 render of the dragon scene file", **b)
    log(f"[14] spatial_light_pick: {len(cap['pick'])} recorded calls bit "
        f"for bit; bounce 0 ({n} lanes, {rows} voxels): kernel {ms:.4f} "
        f"ms, plain {pms:.4f} ms, torch.searchsorted on the gathered rows "
        f"(the gather not counted) {lib_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    (grid, p, q), _ = cap["lookup"][0]
    n = p.shape[0]
    flat = LD.voxel_index(grid, p)
    pairs = torch.unique(flat * n_l + q.long().clamp(0, n_l - 1)).numel()
    ms = kernel_time("spatial_pmf_lookup",
                     lambda: LD.pmf_lookup(grid, p, q), 20,
                     "pmf_lookup_kernel")
    with K.plain_reference():
        pms = events_ms(lambda: LD.pmf_lookup(grid, p, q), 20)
    b = bound(n * (12 + 4 + 4) + pairs * 4)
    results["spatial_pmf_lookup"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=pms,
        launches=launches["spatial_pmf_lookup"],
        counted_in="the 1024^2 render of the dragon scene file", **b)
    log(f"[14] spatial_pmf_lookup: {len(cap['lookup'])} recorded calls "
        f"bit for bit; bounce 1 ({n} lanes): kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")


def capture_grid_calls(renderer, ctx, tile, sample=1):
    """The inputs of K13's calls in one step of ``tile``: {"pick": [((grid,
    p, u), {})], "lookup": [((grid, p, lid), {})]}, tensors cloned."""
    from rustracer_tpu_torch.scene import lightdistrib as LD
    from rustracer_tpu_torch.tools.bench_step_kernels import _recording
    cap = {"pick": [], "lookup": []}
    px, py, v = tile
    fs = renderer.film.init_state(renderer.device)
    with _recording(LD, "sample_light", cap["pick"], copy=True), \
            _recording(LD, "pmf_lookup", cap["lookup"], copy=True):
        renderer.step(ctx, fs, px, py, sample, v)
    torch.cuda.synchronize()
    return cap


def check_k4_full(kind, full, launches, results):
    """K4 with filter ``kind`` (PBRT's radius 2) on the full-width splat
    ``full`` of one dragon-file step rendered with that filter, which
    launched K4 ``launches`` times: in the step's order (its lanes 32
    consecutive pixels of a row: the warp-summed path) and permuted (the
    per-tap path), each within 1e-5 relative of the plain splat; both
    timed with L2 evicted before each launch, the step's order in the
    kernels line."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.tools.bench_step_kernels import (
        check_k4_filtered, k4_call, k4_moved, k4_ops, permuted)
    from rustracer_tpu_torch.tools.timing import cold_ms
    film, p_film = full["film"], full["p_film"]
    n = p_film.shape[0]
    b = bound(k4_moved(film, p_film, full["radiance"], full["valid"]),
              k4_ops(film, n))
    row = {}
    for path, case in (("warp sums", full), ("per tap", permuted(full))):
        call, sums = k4_call(None, case)
        call()
        with K.plain_reference():
            pcall, psums = k4_call(None, case)
            pcall()
        err = check_k4_filtered(sums(), psums(), f"film_add_samples {kind} "
                                f"full width, {path}")
        ms = kernel_time(f"film_add_samples {kind} full width", call, 20,
                         "film_add_kernel", cold=True)
        with K.plain_reference():
            pms = cold_ms(pcall, 5)
        log(f"[15] film_add_samples {kind}, the dragon file's full-width "
            f"splat ({n} samples, 1024^2 film), {path}: max abs err "
            f"{err:.3g} (within 1e-5 relative); L2 evicted before each "
            f"launch: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
            f"{100 * b['bound_ms'] / ms:.1f}% of it")
        row = row or dict(max_abs_err=err, ms=ms, plain_ms=pms,
                          launches=launches,
                          counted_in="one full-width step (tile 2) of the "
                          f"uniform dragon file with PixelFilter {kind}",
                          **b)
    results[f"film_add_samples {kind} full width"] = row


def check_k9_full(kind, case, launches, counted_in, results):
    """K9 with filter ``kind`` (PBRT's radius 2) on ``case``, the recorded
    backward of one full-width dragon-file step rendered with that filter
    (tools/bench_step_kernels.filtered_grad_step), against its plain
    version (``check_k9``: the triangle bit for bit, the others within
    1e-5 relative), timed warm: the film's gradient is written just
    before K9 in the backward, so it finds it in L2. ``launches``: K9's
    in the path ``counted_in``."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.tools.bench_step_kernels import (
        check_k9, k4_touched, k9_call, k9_moved, k9_ops)
    from rustracer_tpu_torch.tools.timing import events_ms
    (film, g_acc, p_film, rad, valid), _ = case
    n = p_film.shape[0]
    label = f"film_add_samples_bwd {kind} full width"
    out = k9_call(None, case)
    with K.plain_reference():
        ref = k9_call(None, case)
    err = check_k9(out, ref, kind, label)
    held = "bit for bit" if kind == "triangle" else "within 1e-5 relative"
    ms = kernel_time(label, lambda: k9_call(None, case), 20,
                     "film_add_bwd_kernel")
    with K.plain_reference():
        pms = events_ms(lambda: k9_call(None, case), 5)
    b = bound(k9_moved(film, p_film, rad, valid), k9_ops(film, n))
    log(f"[15] {label}: the backward of the dragon file's full-width step "
        f"({n} samples onto {k4_touched(film, p_film, valid)} pixels of "
        f"the {tuple(g_acc.shape)} gradient), max abs err {err:.3g} "
        f"({held}); warm: kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}), {100 * b['bound_ms'] / ms:.1f}% of it; "
        f"launches {launches} in {counted_in}")
    results[label] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                          launches=launches, counted_in=counted_in, **b)


def filter_cornells(dev, card, results, splats, grads):
    """The Cornell box parsed from a scene string once for each
    PixelFilter, 1 sample, counted: the kernel path's image against the
    all-plain path's (golden tolerance); K4 and K9 with the filter on the
    render's recorded splat against their plain versions, timed, and on
    the full-width dragon-file splat and backward of that filter
    (``splats[kind]``: the splat and its step's K4 launches,
    ``check_k4_full``; ``grads[kind]``: the K9 call, its launches and the
    path they were counted in, ``check_k9_full``); one fwd+bwd train step
    of the Cornell with the filter (parallel/mesh.py), counted, so K9
    runs under autograd."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.parallel.mesh import make_train_step
    from rustracer_tpu_torch.render.renderer import RenderConfig
    from rustracer_tpu_torch.tools.bench_step_kernels import (capture_step,
                                                              check_k9,
                                                              k4_moved,
                                                              k4_ops,
                                                              k9_moved,
                                                              k9_ops)
    from rustracer_tpu_torch.tools.timing import events_ms
    text = open(CORNELL_PBRT).read()
    for kind in FILTER_KINDS:
        bundle, _ = parse_counted(
            f"[15] Cornell box with PixelFilter {kind!r}",
            text=text.replace("WorldBegin", f'PixelFilter "{kind}"\n'
                              "WorldBegin", 1), dev=dev)
        film, ctx = bundle.film, bundle.context()
        r = bundle.renderer()
        torch.cuda.synchronize()
        K.reset_launches()
        img = film.to_image(r.render_state(ctx, sample_stop=1))
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        with K.plain_reference():
            ref = film.to_image(r.render_state(ctx, sample_stop=1))
        mean_err, p99 = image_errors(img.cpu().numpy(), ref.cpu().numpy())
        log(f"[15] {kind}: film {film.filter}, 1 spp; kernel against "
            f"all-plain image: mean err {mean_err:.3g} (<= 2e-3), p99 "
            f"{p99:.3g} (<= 2e-2); launches {launches}")
        if not (mean_err <= 2e-3 and p99 <= 2e-2
                and bool(torch.isfinite(img).all())):
            raise AssertionError(f"the {kind} Cornell differs from plain")
        if launches["film_add_samples"] <= 0:
            raise AssertionError("the filter render did not launch K4")
        c = capture_step(r, ctx, r.tiles[0], sample=0)["k4"][0]
        p_film, rad, valid = c["p_film"], c["radiance"], c["valid"]

        def k4():
            return film.add_samples(film.init_state(dev), p_film, rad,
                                    valid=valid)
        out = k4()
        with K.plain_reference():
            ref = k4()
        err = max((out.rgb - ref.rgb).abs().max().item(),
                  (out.wsum - ref.wsum).abs().max().item())
        if not (torch.allclose(out.rgb, ref.rgb, rtol=1e-5, atol=1e-6)
                and torch.allclose(out.wsum, ref.wsum, rtol=1e-5,
                                   atol=1e-6)):
            raise AssertionError(f"film_add_samples {kind} differs")
        ms = kernel_time(f"film_add_samples {kind}", k4, 20,
                         "film_add_kernel")
        with K.plain_reference():
            pms = events_ms(k4, 20)
        nx, ny = film._footprint()
        taps = p_film.shape[0] * nx * ny
        b = bound(k4_moved(film, p_film, rad, valid),
                  k4_ops(film, p_film.shape[0]))
        results[f"film_add_samples {kind}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms,
            launches=launches["film_add_samples"],
            counted_in=f"the 1-spp render of the {kind} Cornell box", **b)
        log(f"[15] film_add_samples {kind}: {p_film.shape[0]} samples, "
            f"{taps} taps, max abs err {err:.3g} (within 1e-5 relative); "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{b['bound_ms']:.6f} ms ({b['bound_by']})")
        check_k4_full(kind, *splats[kind], results)
        check_k9_full(kind, *grads[kind], results)
        w, h = film.cropped_resolution
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        g_acc = torch.rand((h, w, 4), generator=gen, device=dev) - 0.5

        def k9():
            return film.add_samples_bwd(g_acc, p_film, rad, valid)
        out = k9()
        with K.plain_reference():
            ref = k9()
        err = check_k9(out, ref, kind, f"film_add_samples_bwd {kind}")
        held = "bit for bit" if kind == "triangle" else \
            "within 1e-5 relative"
        ms = kernel_time(f"film_add_samples_bwd {kind}", k9, 20,
                         "film_add_bwd_kernel")
        with K.plain_reference():
            pms = events_ms(k9, 20)
        b = bound(k9_moved(film, p_film, rad, valid),
                  k9_ops(film, p_film.shape[0]))
        step = make_train_step(bundle.integrator.li, bundle.camera, film,
                               bundle.sampler, lr=0.1,
                               config=RenderConfig(max_lanes=1 << 16),
                               device=dev)
        target = torch.zeros((h, w, 3), device=dev)
        torch.cuda.synchronize()
        K.reset_launches()
        new, loss = step(ctx, target)
        torch.cuda.synchronize()
        train = dict(K.LAUNCHES)
        log(f"[15] {kind} Cornell fwd+bwd train step: loss "
            f"{loss.item():.7g}; launches {train}")
        if train["film_add_samples_bwd"] <= 0 or not bool(
                torch.isfinite(loss)):
            raise AssertionError(f"the {kind} train step did not run K9")
        results[f"film_add_samples_bwd {kind}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms,
            launches=train["film_add_samples_bwd"],
            counted_in=f"a fwd+bwd train step of the {kind} Cornell box",
            **b)
        log(f"[15] film_add_samples_bwd {kind}: max abs err {err:.3g} "
            f"({held}); kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, bound {b['bound_ms']:.6f} ms ({b['bound_by']})")


def timed_render(renderer, ctx):
    """Wall seconds of samples [0, SAMPLES) through ``renderer``, ending
    in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.film.to_image(renderer.render_state(ctx, sample_stop=SAMPLES))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def dragon_file(dev, card, geometry, ref, ref_img, ref_rays, results):
    """The headline dragon through a scene file (tools/dragon_scene.py) at
    1024^2, samples [0, 8) in 2^18-lane tiles: the uniform strategy's
    tables bit for bit build_dragon's and its image within the golden
    tolerance of build_dragon's (``ref_img``, phase 6); the spatial grid's
    render finite, its 1-spp crop against the all-plain path, and K13 on
    the recorded inputs of one full-width step, K12 on the file's whole
    grid. Then the three renders (build_dragon's, ``ref`` = (renderer,
    ctx), the uniform and spatial files') timed in turns, a, b, c, c, b,
    a. -> (splats, grads): {kind: (the K4 splat of one full-width step
    (tile 2) of the uniform file rendered with PixelFilter kind at radius
    2 (filtered_splat), K4's launches in that step)} and {kind: (the K9
    call of that step's backward (filtered_grad_step), K9's launches,
    the path they were counted in: that backward, or for Mitchell one
    full-width train step of the file with PixelFilter mitchell)} for
    FILTER_KINDS."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.render.film import Film
    from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
    from rustracer_tpu_torch.tools.bench_step_kernels import (
        filtered_grad_step, filtered_splat)
    from rustracer_tpu_torch.tools.dragon_scene import write_dragon_scene
    geom = geometry[0]
    rays = {"build_dragon (phase 6)": ref_rays}
    launches = None
    turns = {"build_dragon": ref}
    with tempfile.TemporaryDirectory() as d:
        for strategy in ("uniform", "spatial"):
            t0 = time.perf_counter()
            path = write_dragon_scene(os.path.join(d, strategy), SUB, RES,
                                      strategy)
            log(f"[14] wrote the dragon scene file ({strategy}) in "
                f"{time.perf_counter() - t0:.3f} s")
            bundle, parse_launches = parse_counted(
                f"[14] dragon file, {strategy}:", path=path, dev=dev)
            if strategy == "uniform":
                for f in ("tv_p", "t_idx", "bvh16_table", "bvh16_roots"):
                    a, b = getattr(bundle.geom, f), getattr(geom, f)
                    if not torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)):
                        raise AssertionError(f"dragon file: {f} differs "
                                             "from build_dragon's")
                log("[14] uniform: tv_p, t_idx, bvh16_table and bvh16_roots "
                    "bit for bit build_dragon's")
            r = bundle.renderer(LANES)
            turns[strategy] = (r, bundle.context())
            r.render_state(bundle.context(), sample_stop=1)    # warm-up
            launches, _, img, rays[strategy] = render_counted(
                f"[14] dragon file, {strategy}:", r, bundle.film,
                bundle.context(), SAMPLES, card)
            if strategy == "uniform":
                mean_err, p99 = image_errors(img.cpu().numpy(),
                                             ref_img.cpu().numpy())
                log(f"[14] uniform against build_dragon's render: mean err "
                    f"{mean_err:.3g} (< 2e-3), p99 {p99:.3g} (< 2e-2)")
                if not (mean_err < 2e-3 and p99 < 2e-2):
                    raise AssertionError("the dragon file's render differs "
                                         "from build_dragon's")
                # the splat of one full-width step (tile 2) through each
                # radius-2 filter and its backward's K9 call, with their
                # launches, for phase 15
                splats, grads = {}, {}
                for kind in FILTER_KINDS:
                    torch.cuda.synchronize()
                    K.reset_launches()
                    splat = filtered_splat(r, bundle.context(), 2, kind=kind)
                    torch.cuda.synchronize()
                    n_k4 = K.LAUNCHES["film_add_samples"]
                    K.reset_launches()
                    grad = filtered_grad_step(r, bundle.context(), 2,
                                              kind=kind)
                    torch.cuda.synchronize()
                    n_k9 = K.LAUNCHES["film_add_samples_bwd"]
                    if n_k4 <= 0 or n_k9 <= 0:
                        raise AssertionError(f"the {kind} dragon-file step "
                                             "did not launch K4 and K9")
                    splats[kind] = (splat, n_k4)
                    grads[kind] = (grad, n_k9, "the backward of one "
                                   "full-width step (tile 2) of the uniform "
                                   f"dragon file with PixelFilter {kind}")
                grads["mitchell"] = grads["mitchell"][:1] + mitchell_train(
                    dev, card, bundle)
                continue
            log(f"[14] spatial: grid "
                f"{tuple(int(x) for x in bundle.light_grid.host[2])} "
                f"voxels, K12 launched {parse_launches['spatial_grid_contrib']}"
                " times by the parse")
            if min(launches[k] for k in ("spatial_light_pick",
                                         "spatial_pmf_lookup")) <= 0 \
                    or parse_launches["spatial_grid_contrib"] <= 0:
                raise AssertionError("the spatial render did not launch "
                                     "K12 and K13")
            check_grid_contrib("[14]", "spatial_grid_contrib dragon file",
                               "the dragon scene file (spatial)", bundle,
                               parse_launches, results)
            crop_film = Film(full_resolution=RES, crop_window=TEX_CROP,
                             filter=bundle.film.filter)
            compare_crop("[14] spatial", Renderer(
                bundle.integrator.li, bundle.camera, crop_film,
                bundle.sampler, RenderConfig(max_lanes=TEX_CROP_LANES),
                device=dev), crop_film, bundle.context())
            cap = capture_grid_calls(r, bundle.context(), r.tiles[2])
            check_grid_picks(cap, results, launches)
    log(f"[14] camera rays/s on {card}: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rays.items()))
    order = list(turns)
    secs = {k: [] for k in order}
    for k in order + order[::-1]:
        secs[k].append(timed_render(*turns[k]))
    log(f"[14] in turns {order + order[::-1]}, camera rays/s on {card}: "
        + "; ".join(f"{k} " + " / ".join(
            f"{RES[0] * RES[1] * SAMPLES / t:.1f}" for t in v)
            for k, v in secs.items()))
    return splats, grads


def mitchell_train(dev, card, bundle):
    """One full-width train step (parallel/mesh.make_train_step, 2^18-lane
    tiles, sample 0, lr 0.1, a black target) of the parsed dragon file
    ``bundle`` with PixelFilter mitchell, counted: K9 launched, the loss
    finite -> (K9's launches, the path they were counted in)."""
    import dataclasses
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.parallel.mesh import make_train_step
    from rustracer_tpu_torch.render.filters import make_filter
    from rustracer_tpu_torch.render.renderer import RenderConfig
    film = dataclasses.replace(bundle.film, filter=make_filter("mitchell"))
    step = make_train_step(bundle.integrator.li, bundle.camera, film,
                           bundle.sampler, lr=0.1,
                           config=RenderConfig(max_lanes=LANES), device=dev)
    w, h = film.cropped_resolution
    target = torch.zeros((h, w, 3), device=dev)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    _, loss = step(bundle.context(), target)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(f"[14] uniform dragon file, PixelFilter mitchell: one train step "
        f"{w}x{h}, sample 0, 2^18-lane tiles, {wall:.3f} s wall, loss "
        f"{loss.item():.7g} on {card}; launches {launches}")
    if launches["film_add_samples_bwd"] <= 0 or not bool(
            torch.isfinite(loss)):
        raise AssertionError("the Mitchell dragon-file train step did not "
                             "launch K9 or its loss is not finite")
    return (launches["film_add_samples_bwd"], "one full-width train step of "
            "the uniform dragon file with PixelFilter mitchell")


def check_k14(label, geom, o, d, t_max, key, any_hit, results):
    """K14 on these rays against its plain loop: the closest search's hit
    and quadric id bit for bit and t within 1e-6 relative, the any-hit
    search's flag bit for bit with the closest search's; timed, bounded
    on the call's data (tools/quadric_work.py k14_work)."""
    from rustracer_tpu_torch.scene.tables import (intersect_quadrics_all,
                                                 quadrics_any_hit)
    from rustracer_tpu_torch.tools import quadric_work as QW
    name = "quadric_any" if any_hit else "quadric_closest"

    def fn():
        if any_hit:
            return quadrics_any_hit(geom, o, d, t_max)
        return intersect_quadrics_all(geom, o, d, t_max)
    out, ref, ms, pms = both(fn, name + "_kernel", row=key)
    if any_hit:
        from rustracer_tpu_torch.cuda import plain_reference
        with plain_reference():
            ref_hit = intersect_quadrics_all(geom, o, d, t_max)[0]
        if not (torch.equal(out, ref) and torch.equal(out, ref_hit)):
            raise AssertionError(f"{label} {name}: the hit flags differ")
        err, hit_share = 0.0, out.float().mean().item()
    else:
        (hit, t, qid), (rhit, rt, rqid) = out, ref
        if not (torch.equal(hit, rhit) and torch.equal(qid, rqid)):
            raise AssertionError(f"{label} {name}: hit or quadric id "
                                 "differs from the plain loop")
        d_t = (t[hit] - rt[hit]).abs()
        if bool((d_t > 1e-6 * rt[hit].abs()).any()):
            raise AssertionError(f"{label} {name}: t beyond 1e-6 relative, "
                                 f"max {d_t.max().item()}")
        err = d_t.max().item() if d_t.numel() else 0.0
        hit_share = hit.float().mean().item()
    work = QW.k14_work(geom, o, d, t_max, any_hit)
    bound_ms, bound_by = QW.k14_bound(work)
    results[key] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None)
    log(f"{label} {name}: {work['lanes']} rays x {geom.n_quadrics} quadrics "
        f"({work['tests']} tests), {hit_share:.4f} hit; matches the plain "
        f"loop (t max abs err {err:.3g}); kernel {ms:.4f} ms, plain "
        f"{pms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.1f}% of it")


def check_k2_quadrics(label, geom, ray, hit, t, prim, key, results):
    """K2 on these hits, quadric lanes among them, against its plain
    version: every field within 1e-5 absolute or relative (acosf, sinf,
    atan2f and the normalisations may round apart), p_error within 1e-5
    relative, the ids bit for bit; timed and bounded
    (tools/quadric_work.py k2_bound)."""
    from rustracer_tpu_torch.scene.tables import build_interaction
    from rustracer_tpu_torch.tools import quadric_work as QW

    def fn():
        return build_interaction(geom, ray, hit, t, prim)
    out, ref, ms, pms = both(fn, "build_interaction_kernel", row=key)
    quad = hit & (prim < geom.n_quadrics)
    err = qerr = 0.0
    for f in ("p", "p_error", "n", "uv", "dpdu", "dpdv", "ns", "ss", "ts",
              "dndu", "dndv", "wo"):
        a, b = getattr(out, f), getattr(ref, f)
        dd = (a - b).abs()
        bad = k2_off(f, a, b)
        if bad.any():
            raise AssertionError(f"{label} build_interaction: {f} differs on "
                                 f"{int(bad.sum())} lanes, max {dd.max()}")
        err = max(err, dd.max().item())
        if quad.any():
            qerr = max(qerr, dd[quad].max().item())
    for f in ("material", "arealight", "prim_id", "valid"):
        if not torch.equal(getattr(out, f), getattr(ref, f)):
            raise AssertionError(f"{label} build_interaction: {f} differs")
    bound_ms, bound_by, n_q, n_t = QW.k2_bound(geom, hit, prim)
    results[key] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None)
    log(f"{label} build_interaction: {n_q} quadric and {n_t} triangle lanes "
        f"of {hit.shape[0]}; fields max abs err {err:.3g} (quadric lanes "
        f"{qerr:.3g}); kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it")


def check_quadric_table(dev, results):
    """Phase 16's kernels at full width on the 16-quadric table."""
    from rustracer_tpu_torch.scene.tables import closest_prim
    from rustracer_tpu_torch.tools import quadric_work as QW
    q = QW.quadric_table()
    geom = QW.table_geometry(q, device=dev)
    ray = QW.quadric_rays(q, LANES, device=dev)
    check_k14("[16] table", geom, ray.o, ray.d, ray.t_max, "quadric_closest",
              False, results)
    check_k14("[16] table", geom, ray.o, ray.d, ray.t_max, "quadric_any",
              True, results)
    hit, t, prim = closest_prim(geom, ray)
    check_k2_quadrics("[16] table", geom, ray, hit, t, prim,
                      "build_interaction quadrics", results)


def testball_at_res(label, name, dev):
    """scenes/testball-<name>.pbrt parsed on ``dev`` with its film at
    RES (its textures found beside it)."""
    from rustracer_tpu_torch.tools.profile_step import testball_text
    from rustracer_tpu_torch.utils import fileutil
    text, scenes = testball_text(f"testball-{name}", RES)
    fileutil.set_search_directory(scenes)
    bundle, _ = parse_counted(f"{label} testball-{name} at {RES[0]}^2",
                              text=text, dev=dev)
    if tuple(bundle.film.full_resolution) != RES:
        raise AssertionError(f"film {bundle.film.full_resolution}")
    return bundle


def testball_full(dev, card, results):
    """testball-matte at 1024^2: the counted render, one recorded step's
    K14 and K2 calls, the launches of that step, the crop against the
    all-plain path."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.render.film import Film
    from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
    from rustracer_tpu_torch.tools import quadric_work as QW
    bundle = testball_at_res("[16]", "matte", dev)
    renderer, ctx = bundle.renderer(LANES), bundle.context()
    renderer.render_state(ctx, sample_stop=1)
    launches, _, img, rays = render_counted(
        "[16]", renderer, bundle.film, ctx, SAMPLES, card,
        depth=bundle.integrator.max_depth)
    missing = [k for k in K.QUADRIC_KERNELS + ("build_interaction",)
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the render: {missing}")
    tile = renderer.tiles[2]
    per_step = step_launches(renderer, ctx, tile)
    log(f"[16] launches in one full-width testball step (tile 2): "
        f"{per_step}")
    cap = QW.capture_quadric_step(renderer, ctx, tile)
    geom, o, d, t_max = cap["intersect_quadrics_all"]
    check_k14("[16] step", geom, o, d, t_max, "quadric_closest testball",
              False, results)
    geom, o, d, t_max = cap["quadrics_any_hit"]
    check_k14("[16] step", geom, o, d, t_max, "quadric_any testball", True,
              results)
    check_k2_quadrics("[16] step", *cap["build_interaction"],
                      "build_interaction testball", results)
    for key in ("quadric_closest", "quadric_any", "build_interaction "
                "quadrics", "quadric_closest testball", "quadric_any "
                "testball", "build_interaction testball"):
        name = ROWS[key][0]
        results[key].update(launches=launches[name],
                            launches_per_step=per_step[name],
                            counted_in=f"testball-matte render at "
                            f"{RES[0]}^2")
    crop_film = Film(full_resolution=RES, crop_window=CROP,
                     filter=bundle.film.filter)
    compare_crop("[16]", Renderer(bundle.integrator.li, bundle.camera,
                                  crop_film, bundle.sampler,
                                  RenderConfig(max_lanes=LANES), device=dev),
                 crop_film, ctx)
    return rays


def testball_goldens(dev, card, names=TESTBALLS, phase=17):
    """The material testballs ``names`` parsed and rendered in process on
    the card at their own 64^2, counted, each against its golden. ->
    {name: launches of its render}."""
    from rustracer_tpu_torch import cuda as K
    counts = {}
    for name in names:
        bundle, _ = parse_counted(
            f"[{phase}] testball-{name}",
            path=os.path.join(REPO, "scenes", f"testball-{name}.pbrt"),
            dev=dev)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        img = bundle.render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = launches = dict(K.LAUNCHES)
        img = img.cpu().numpy()
        mean_err, p99 = image_errors(img, golden(f"testball-{name}", img))
        ms = bundle.material_set
        log(f"[{phase}] testball-{name} {bundle.film.full_resolution}, "
            f"{bundle.sampler.spp} spp, depth {bundle.integrator.max_depth}: "
            f"{wall:.3f} s; M {ms.max_lobes}, lobe types "
            f"{ms.types_present()}; against tests/goldens/testball-{name}"
            f".npz: mean err {mean_err:.3g} (< 2e-3), p99 {p99:.3g} (< "
            f"2e-2) on {card}; launches {launches}")
        need = K.QUADRIC_KERNELS + ("build_interaction", "row_gather")
        if name == "textured":
            need += ("atlas_lookup_ewa",)
        missing = [k for k in need if launches[k] <= 0]
        if missing:
            raise AssertionError(f"[{phase}] testball-{name} did not "
                                 f"launch {missing}")
        if not (mean_err < 2e-3 and p99 < 2e-2):
            raise AssertionError(f"[{phase}] testball-{name} differs from "
                                 "its golden image")
    return counts


def inside_call(label, calls, key):
    """-> the index of the recorded call (of ``calls``, the list
    capture_quadric_step(every=True) gives under ``key``) with the most
    live rays starting inside a sphere, and that count; every call's
    count printed."""
    from rustracer_tpu_torch.tools import quadric_work as QW
    counts = []
    for c in calls:
        if key == "build_interaction":
            geom, ray, hit, _, prim = c
            live = hit & (prim < geom.n_quadrics)
            o = ray.o
        else:
            geom, o, _, t_max = c
            live = t_max > 0
        counts.append(int((QW.inside_sphere(geom, o) & live).sum()))
    log(f"{label} {key}: rays starting inside the ball, by call: {counts}")
    i = int(np.argmax(counts))
    if counts[i] <= 0:
        raise AssertionError(f"{label} {key}: no call has a ray leaving the "
                             "ball from inside")
    return i, counts[i]


def check_t_bits(label, geom, o, d, t_max):
    """K14 closest's t bit for bit with the plain loop's on its hits."""
    from rustracer_tpu_torch.cuda import plain_reference
    from rustracer_tpu_torch.scene.tables import intersect_quadrics_all
    hit, t, _ = intersect_quadrics_all(geom, o, d, t_max)
    with plain_reference():
        _, rt, _ = intersect_quadrics_all(geom, o, d, t_max)
    if not torch.equal(t[hit].view(torch.int32), rt[hit].view(torch.int32)):
        raise AssertionError(f"{label}: K14's t differs in bits from the "
                             "plain loop's")


def check_atlas_testball(ctx, cap, ball_reg, results):
    """K5 on every call of a full-width testball-textured step against its
    plain version (lanes beyond 1e-5 at most 1e-3; the ball's lanes'
    largest error printed), timed and bounded as in phase 3."""
    from rustracer_tpu_torch.scene import atlas as A
    from rustracer_tpu_torch.tools.atlas_work import k5_bound, k5_work
    rows = []
    for li, c in enumerate(cap["k5"]):
        reg, si = c["reg"], c["si"]

        def fn(c=c):
            return A.atlas_lookup_ewa(c["texels"], c["meta"], c["levels"],
                                      c["regs"], reg, si, quad=c["quad"])
        out, ref, ms_k, ms_p = both(
            fn, "atlas_ewa_kernel", row="atlas_lookup_ewa testball-textured")
        d = (out - ref).abs().max(-1).values
        off = (d > 1e-5).float().mean().item()
        ball = reg == ball_reg
        work = k5_work(c["meta"], c["levels"], c["regs"], reg, si,
                       c["quad"])
        bound_ms, bound_by = k5_bound(work)
        ball_err = d[ball].max().item() if bool(ball.any()) else 0.0
        log(f"[17] testball-textured atlas_lookup_ewa call {li} (quad "
            f"{c['quad']}): {reg.shape[0]} lanes, {int(ball.sum())} on the "
            f"ball, {int((reg >= 0).sum()) - int(ball.sum())} on the floor; "
            f"max abs err {d.max().item():.3g} (ball {ball_err:.3g}), lanes "
            f"beyond 1e-5 {off:.3g} (<= 1e-3); kernel {ms_k:.4f} ms, plain "
            f"{ms_p:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{100 * bound_ms / ms_k:.1f}%")
        if off > 1e-3 or bool(out[reg < 0].any()):
            raise AssertionError("[17] atlas_lookup_ewa differs on the "
                                 "textured testball")
        rows.append((ms_k, ms_p, bound_ms, bound_by, d.max().item(),
                     int(ball.sum())))
    if sum(r[5] for r in rows) <= 0:
        raise AssertionError("[17] no K5 lane on the textured ball")
    by = [r[3] for r in rows]
    results["atlas_lookup_ewa testball-textured"] = dict(
        max_abs_err=max(r[4] for r in rows),
        ms=float(np.mean([r[0] for r in rows])),
        plain_ms=float(np.mean([r[1] for r in rows])),
        bound_ms=float(np.mean([r[2] for r in rows])),
        bound_by=max(set(by), key=by.count), library_ms=None)


def check_gather_rows(cap, results, width, phase, card=""):
    """K8 at ``width`` floats a row: the material rows of a recorded
    full-width step's bounce 0, bit for bit, timed with its yardstick."""
    from rustracer_tpu_torch.ops.gather import row_gather
    from rustracer_tpu_torch.tools.timing import queued_ms
    tab, mid = cap["k8"][0]
    if tab.shape[1] != width:
        raise AssertionError(f"the material rows are {tab.shape}, not "
                             f"{width} floats wide")
    out, ref, ms, pms = both(lambda: row_gather(tab, mid),
                             "row_gather_kernel",
                             row=f"row_gather material rows W={width}")
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"row_gather differs on {width}-float rows")
    lib_ms = queued_ms(lambda: torch.index_select(tab, 0, mid), 20)
    rows = torch.unique(mid).numel()
    r = results[f"row_gather material rows W={width}"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=pms, library_ms=lib_ms,
        **bound(nbytes(mid, out) + rows * tab.shape[1] * 4))
    log(f"[{phase}] row_gather material rows ({tab.shape[0]} x "
        f"{tab.shape[1]} float32, {mid.shape[0]} lanes, {rows} distinct): "
        f"bit for bit; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
        f"torch.index_select {lib_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({100 * r['bound_ms'] / ms:.1f}%){card and ' on ' + card}")


def glass_steps(dev, card, results, counts):
    """Phase 17 at full width: the counted and timed glass render, K14 and
    K2 on the glass step's inside-origin calls, K14 any on roughglass's,
    K8 at 32 floats on plastic's, K5 on textured's."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.tools import quadric_work as QW
    from rustracer_tpu_torch.tools.bench_step_kernels import capture_step
    bundle = testball_at_res("[17]", "glass", dev)
    renderer, ctx = bundle.renderer(LANES), bundle.context()
    renderer.render_state(ctx, sample_stop=1)
    launches, tiers, _, rays = render_counted(
        "[17] testball-glass", renderer, bundle.film, ctx, SAMPLES, card,
        depth=bundle.integrator.max_depth)
    missing = [k for k in K.QUADRIC_KERNELS + ("build_interaction",)
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the glass render did not launch {missing}")
    tile = renderer.tiles[2]
    per_step = step_launches(renderer, ctx, tile)
    log(f"[17] launches in one full-width glass step (tile 2): {per_step}")
    cap = QW.capture_quadric_step(renderer, ctx, tile, every=True)
    i, n_in = inside_call("[17] glass step", cap["intersect_quadrics_all"],
                          "intersect_quadrics_all")
    for j, c in enumerate(cap["intersect_quadrics_all"]):
        check_t_bits(f"[17] glass step call {j}", *c)
    check_k14(f"[17] glass step call {i} ({n_in} rays from inside)",
              *cap["intersect_quadrics_all"][i], "quadric_closest glass",
              False, results)
    i, n_in = inside_call("[17] glass step", cap["build_interaction"],
                          "build_interaction")
    check_k2_quadrics(f"[17] glass step call {i} ({n_in} back-side hits)",
                      *cap["build_interaction"][i], "build_interaction glass",
                      results)
    for key in ("quadric_closest glass", "build_interaction glass"):
        name = ROWS[key][0]
        results[key].update(launches=launches[name],
                            launches_per_step=per_step[name],
                            counted_in=f"testball-glass render at {RES[0]}^2")

    rough = testball_at_res("[17]", "roughglass", dev)
    rr, rctx = rough.renderer(LANES), rough.context()
    rcap = QW.capture_quadric_step(rr, rctx, rr.tiles[2], every=True)
    i, n_in = inside_call("[17] roughglass step", rcap["quadrics_any_hit"],
                          "quadrics_any_hit")
    check_k14(f"[17] roughglass step call {i} ({n_in} rays from inside)",
              *rcap["quadrics_any_hit"][i], "quadric_any roughglass", True,
              results)
    results["quadric_any roughglass"].update(
        launches=counts["roughglass"]["quadric_any"],
        launches_per_step=step_launches(rr, rctx, rr.tiles[2])[
            "quadric_any"],
        counted_in="testball-roughglass render at 64^2 (phase 17)")

    plastic = testball_at_res("[17]", "plastic", dev)
    pr, pctx = plastic.renderer(LANES), plastic.context()
    check_gather_rows(capture_step(pr, pctx, pr.tiles[2]), results, 32, 17,
                      card)
    results["row_gather material rows W=32"].update(
        launches=counts["plastic"]["row_gather"],
        launches_per_step=step_launches(pr, pctx, pr.tiles[2])["row_gather"],
        counted_in="testball-plastic render at 64^2 (phase 17)")

    tex = testball_at_res("[17]", "textured", dev)
    tr, tctx = tex.renderer(LANES), tex.context()
    ms = tex.material_set
    _, slot_tab, _, _ = ms.atlas_prep()
    ball_reg = int(slot_tab[len(ms.materials) - 1, 0])
    check_atlas_testball(tctx, capture_step(tr, tctx, tr.tiles[2]),
                         ball_reg, results)
    results["atlas_lookup_ewa testball-textured"].update(
        launches=counts["textured"]["atlas_lookup_ewa"],
        launches_per_step=step_launches(tr, tctx, tr.tiles[2])[
            "atlas_lookup_ewa"],
        counted_in="testball-textured render at 64^2 (phase 17)")
    return rays


def plain_balls(dev, card):
    """Phase 18: the balls without a golden (PLAIN_BALLS) at BALL_RES and
    BALL_SPP, counted, through the kernels and through the all-plain path,
    held within the crop tolerance. -> {name: launches of its render}."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.tools.profile_step import testball_text
    from rustracer_tpu_torch.utils import fileutil
    counts = {}
    for name in PLAIN_BALLS:
        text, scenes = testball_text(f"testball-{name}", BALL_RES, BALL_SPP)
        fileutil.set_search_directory(scenes)
        bundle, _ = parse_counted(f"[18] testball-{name}", text=text,
                                  dev=dev)
        runs = []
        for plain in (False, True):
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            with K.plain_reference() if plain else contextlib.nullcontext():
                img = bundle.render()
            torch.cuda.synchronize()
            runs.append((img.cpu().numpy(), time.perf_counter() - t0,
                         dict(K.LAUNCHES)))
        (img, wall, launches), (ref, plain_wall, _) = runs
        counts[name] = launches
        if not np.isfinite(img).all() or not img.mean() > 1e-4:
            raise AssertionError(f"[18] testball-{name}: the image is not "
                                 "finite or is black")
        mean_err, p99 = image_errors(img, ref)
        ms = bundle.material_set
        log(f"[18] testball-{name} {BALL_RES[0]}^2, {BALL_SPP} spp, depth "
            f"{bundle.integrator.max_depth}: M {ms.max_lobes}, lobe types "
            f"{ms.types_present()}; kernel path {wall:.3f} s, plain path "
            f"{plain_wall:.3f} s on {card}; kernel against plain: mean err "
            f"{mean_err:.3g} (<= 2e-3), p99 {p99:.3g} (<= 2e-2); launches "
            f"{launches}")
        missing = [k for k in K.QUADRIC_KERNELS + ("build_interaction",
                                                   "row_gather")
                   if launches[k] <= 0]
        if missing:
            raise AssertionError(f"[18] testball-{name} did not launch "
                                 f"{missing}")
        if not (mean_err <= 2e-3 and p99 <= 2e-2):
            raise AssertionError(f"[18] testball-{name}: kernel and plain "
                                 "renders disagree")
    return counts


def layered_steps(dev, card, results, counts, rays):
    """Phase 18 at full width: the counted and timed Disney render beside
    matte's and glass's rays/s (``rays``), K8 at 96 and 112 floats on the
    Disney and mix steps, and one profiled tile-2 step of testball-matte,
    -glass and -disney."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.tools.bench_step_kernels import capture_step
    from rustracer_tpu_torch.tools.profile_step import profile_tile
    bundle = testball_at_res("[18]", "disney", dev)
    renderer, ctx = bundle.renderer(LANES), bundle.context()
    renderer.render_state(ctx, sample_stop=1)
    launches, _, _, rays["disney"] = render_counted(
        "[18] testball-disney", renderer, bundle.film, ctx, SAMPLES, card,
        depth=bundle.integrator.max_depth)
    missing = [k for k in K.QUADRIC_KERNELS + ("build_interaction",
                                               "row_gather")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the Disney render did not launch {missing}")
    log(f"[18] camera rays/s at {RES[0]}^2, {SAMPLES} samples, on {card}: "
        + ", ".join(f"testball-{k} {v:.1f}" for k, v in rays.items()))
    tile = renderer.tiles[2]
    per_step = step_launches(renderer, ctx, tile)
    log(f"[18] launches in one full-width Disney step (tile 2): {per_step}")
    check_gather_rows(capture_step(renderer, ctx, tile), results, 96, 18,
                      card)
    results["row_gather material rows W=96"].update(
        launches=launches["row_gather"],
        launches_per_step=per_step["row_gather"],
        counted_in=f"testball-disney render at {RES[0]}^2")
    mix = testball_at_res("[18]", "mix", dev)
    mr, mctx = mix.renderer(LANES), mix.context()
    check_gather_rows(capture_step(mr, mctx, mr.tiles[2]), results, 112, 18,
                      card)
    results["row_gather material rows W=112"].update(
        launches=counts["mix"]["row_gather"],
        launches_per_step=step_launches(mr, mctx, mr.tiles[2])["row_gather"],
        counted_in=f"testball-mix render at {BALL_RES[0]}^2 (phase 18)")
    steps = {"disney": (renderer, ctx)}
    for name in ("matte", "glass"):
        b = testball_at_res("[18]", name, dev)
        steps[name] = (b.renderer(LANES), b.context())
    for name in ("matte", "glass", "disney"):
        r, c = steps[name]
        prof = profile_tile(r, c, r.tiles[2])
        log(f"[18] profiled step of testball-{name} (tile 2, {LANES} lanes) "
            f"on {card}: {prof['n_kernels']} device kernels, busy "
            f"{prof['device_busy_ms']:.3f} ms of "
            f"{prof['profiled_step_ms']:.3f} ms "
            f"({100 * prof['busy_share']:.1f}%), step median "
            f"{prof['step_ms_median']:.3f} ms, hand kernels "
            f"{sum(prof['hand_kernels_ms'].values()):.4f} ms "
            f"{json.dumps(prof['hand_kernels_ms'])}; top "
            f"{json.dumps(prof['top_device_ms'][:5])}")


def scene_cli(name, phase, need):
    """scenes/<name>.pbrt through the port's command line on the card, in a
    subprocess, as written: the kernels ``need`` launched (the parse's and
    the render's, which the CLI prints as one line), the image held to its
    golden (mean 2e-3, p99 2e-2)."""
    from rustracer_tpu_torch.render.imageio import read_image
    scene = os.path.join(REPO, "scenes", f"{name}.pbrt")
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, f"{name}.exr")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rustracer_tpu_torch.utils.cli",
             scene, "-o", out, "-v"], cwd=REPO, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"[{phase}] cli: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"the CLI failed ({proc.returncode}):\n"
                                 f"{proc.stderr[-4000:]}")
        img = read_image(out)
    launches = json.loads(next(
        line for line in proc.stdout.splitlines()
        if line.startswith("launches "))[len("launches "):])
    mean_err, p99 = image_errors(img, golden(name, img))
    log(f"[{phase}] python -m rustracer_tpu_torch.utils.cli "
        f"scenes/{name}.pbrt: {wall:.2f} s in all; launches of {need}: "
        f"{[launches[k] for k in need]}; against tests/goldens/{name}.npz: "
        f"mean err {mean_err:.3g} (< 2e-3), p99 {p99:.3g} (< 2e-2)")
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the CLI's {name} did not launch {missing}")
    if not (mean_err < 2e-3 and p99 < 2e-2):
        raise AssertionError(f"the CLI's {name} differs from its golden")


def golden(name, img):
    """tests/goldens/<name>.npz, checked against ``img``'s shape and
    finiteness."""
    ref = np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npz"))["img"]
    if img.shape != ref.shape or not np.isfinite(img).all():
        raise AssertionError(f"{name}: image {img.shape} not finite or not "
                             f"the golden's {ref.shape}")
    return ref


def light_goldens(dev, card):
    """Phase 19: veach-mis, envmap-dof and bathroom parsed and rendered in
    process on the card as written, each parse and render counted (the
    kernels of LIGHT_NEEDS launched), each image against its golden."""
    from rustracer_tpu_torch import cuda as K
    for name in LIGHT_SCENES:
        bundle, parse = parse_counted(
            f"[19] scenes/{name}.pbrt",
            path=os.path.join(REPO, "scenes", f"{name}.pbrt"), dev=dev)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        img = bundle.render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        img = img.cpu().numpy()
        mean_err, p99 = image_errors(img, golden(name, img))
        lt = bundle.lights
        w, h = bundle.film.full_resolution
        log(f"[19] {name} {w}x{h}, {bundle.sampler.spp} spp, depth "
            f"{bundle.integrator.max_depth}: {lt.n_lights} lights "
            f"({sorted(lt.kinds)}), grid "
            f"{None if bundle.light_grid is None else bundle.light_grid.host[2].tolist()}; "
            f"render {wall:.3f} s on {card}; against tests/goldens/"
            f"{name}.npz: mean err {mean_err:.3g} (< 2e-3), p99 {p99:.3g} "
            f"(< 2e-2); parse launches {parse}; render launches {launches}")
        parse_needs, render_needs = LIGHT_NEEDS[name]
        missing = [k for k in parse_needs if parse[k] <= 0] + \
            [k for k in render_needs if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{name} did not launch {missing}")
        if not (mean_err < 2e-3 and p99 < 2e-2):
            raise AssertionError(f"{name} differs from its golden")


def check_k15(calls, results, counts):
    """K15 on every infinite_sample call of the recorded step against its
    plain version: li bit for bit (a function of the sample's uv alone, so
    it pins the marginal's and the row's find_interval and the uv), wi,
    the target and the pdf within 1e-5 relative (sinf and cosf against
    torch's); the first call (bounce 0's NEE) timed and bounded."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.scene import lights as L
    from rustracer_tpu_torch.tools import light_work as LW
    from rustracer_tpu_torch.tools.timing import events_ms
    worst = 0.0
    for i, (lt_, lid, p, u) in enumerate(calls):
        out = L.infinite_sample(lt_, lid, p, u)
        with K.plain_reference():
            ref = L.infinite_sample(lt_, lid, p, u)
        wi, pdf, li, pt = out
        rwi, rpdf, rli, rpt = ref
        errs = []
        for a, b in ((wi, rwi), (pt, rpt)):
            errs.append(((a - b).abs().max(-1).values
                         / b.abs().max(-1).values.clamp(min=1e-30)).max()
                        .item())
        errs.append(((pdf - rpdf).abs() / rpdf.abs().clamp(min=1e-30))
                    .max().item())
        n_inf = int(sum(int((lid == r).sum()) for r in lt_.inf_rows))
        log(f"[19] K15 call {i}: {lid.shape[0]} lanes, {n_inf} on the "
            f"sky; li bit for bit: {torch.equal(li, rli)}; relative err wi "
            f"{errs[0]:.3g}, target {errs[1]:.3g}, pdf {errs[2]:.3g} "
            "(<= 1e-5)")
        if not torch.equal(li, rli) or max(errs) > 1e-5:
            raise AssertionError("infinite_sample differs from its plain "
                                 "version")
        worst = max(worst, (wi - rwi).abs().max().item(),
                    (pt - rpt).abs().max().item(),
                    (pdf - rpdf).abs().max().item())
    lt_, lid, p, u = calls[0]

    def fn():
        return L.infinite_sample(lt_, lid, p, u)
    ms = kernel_time("infinite_sample", fn, 20, "infinite_sample_kernel")
    with K.plain_reference():
        pms = events_ms(fn, 5)
    work = LW.k15_work(lt_, lid)
    b = bound(work["moved"], work["ops"])
    b_ms, by = b["bound_ms"], b["bound_by"]
    results["infinite_sample"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=pms, **b, **counts)
    log(f"[19] K15 infinite_sample, bounce 0's NEE ({work['lanes']} lanes, "
        f"{work['infinite_lanes']} on the sky): kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {b_ms:.4f} ms ({by}: {work['moved']} bytes, "
        f"{work['ops']} operations), {100 * b_ms / ms:.1f}% of it")


def check_k16(label, calls, results, counts,
              keys=("infinite_escape", "infinite_escape mis")):
    """K16 on every infinite_escape call of the recorded step against its
    plain version: the radiance within 1e-5 relative plus 1e-5 / sin theta
    (acos near a pole, tests/test_torch_lights.py) on the lanes whose
    direction is not within 1e-4 of a texel edge of a light's map (the
    piecewise-constant pdf may pick the neighbour on an ulp: counted, at
    most 1%); the camera rays' call and the first call after a bounce
    timed and bounded as rows ``keys`` (None: not timed)."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.scene import lights as L
    from rustracer_tpu_torch.tools import light_work as LW
    from rustracer_tpu_torch.tools.timing import events_ms
    worst = {False: 0.0, True: 0.0}
    for i, args in enumerate(calls):
        lt_, d, mask = args[:3]
        out = L.infinite_escape(*args)
        with K.plain_reference():
            ref = L.infinite_escape(*args)
            st = torch.stack([L._inf_dir_to_uv(lt_, k, d)[1]
                              for k in range(lt_.n_infinite)]).min(0).values
            edge = torch.zeros_like(mask)
            for k in range(lt_.n_infinite):
                h, w = lt_.inf_maps[k].shape[:2]
                x = L._inf_dir_to_uv(lt_, k, d)[0] * torch.tensor(
                    [w, h], device=d.device)
                edge |= ((x - x.round()).abs() < 1e-4).any(-1)
        keep = mask & ~edge
        err = (out - ref).abs().max(-1).values
        bound_ = (1e-5 + 1e-5 / st.clamp(min=1e-12)) \
            * ref.abs().max(-1).values + 1e-7
        bad = keep & (err > bound_)
        mis = len(args) > 3
        worst[mis] = max(worst[mis], err[keep].max().item()
                         if bool(keep.any()) else 0.0)
        log(f"{label} K16 call {i} ({'MIS' if mis else 'camera'}): "
            f"{int(mask.sum())} of {mask.shape[0]} lanes escaped, "
            f"{int((mask & edge).sum())} at a texel edge; max abs err "
            f"{err[keep].max().item() if bool(keep.any()) else 0.0:.3g}, "
            f"{int(bad.sum())} lanes beyond the bound; zero off the mask: "
            f"{bool((out[~mask] == 0).all())}")
        if bad.any() or not bool((out[~mask] == 0).all()) \
                or int((mask & edge).sum()) > 0.01 * max(int(mask.sum()), 1):
            raise AssertionError("infinite_escape differs from its plain "
                                 "version")
    for key, args in zip(keys, calls):
        if key is None:
            continue

        def fn(args=args):
            return L.infinite_escape(*args)
        ms = kernel_time(key, fn, 20, "infinite_escape_kernel")
        with K.plain_reference():
            pms = events_ms(fn, 5)
        mis = len(args) > 3
        work = LW.k16_work(args[0], args[2], mis)
        b = bound(work["moved"], work["ops"])
        b_ms, by = b["bound_ms"], b["bound_by"]
        results[key] = dict(max_abs_err=worst[mis], ms=ms, plain_ms=pms,
                            **b, **counts)
        log(f"{label} K16 {key}, {ROWS[key][1]} ({work['escaped']} "
            f"of {work['lanes']} lanes escaped): kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, bound {b_ms:.4f} ms ({by}: {work['moved']} "
            f"bytes, {work['ops']} operations), {100 * b_ms / ms:.1f}% of "
            "it")


def check_k12_lights(label, key, lt, grid, results, counts):
    """K12's lights kernel (scene/lightdistrib.py grid_contrib_lights) on
    table ``lt`` over ``grid`` = (lo, voxel extent, voxel counts), one
    launch, against the plain version on the card (each sum within 1e-5
    relative or 1e-6 of the column's largest), timed and bounded
    (tools/light_work.py k12_light_work): row ``results[key]``."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.scene import lightdistrib as LD
    from rustracer_tpu_torch.tools import light_work as LW
    from rustracer_tpu_torch.tools.timing import events_ms
    lo, ext, nv = grid
    dev = lt.l_emit.device
    v = int(np.prod(nv))
    halton = torch.as_tensor(LD._radical_inverse_table(LD.N_SAMPLES),
                             device=dev)

    def fn():
        return LD.grid_contrib_lights(lt, lo, ext, nv, halton)
    n0 = K.LAUNCHES["spatial_grid_contrib_lights"]
    out = fn()
    if K.LAUNCHES["spatial_grid_contrib_lights"] != n0 + 1:
        raise AssertionError(f"{key} is not one launch")
    with K.plain_reference():
        ref = fn()
    d = (out - ref).abs()
    top = ref.abs().max(0).values
    bad = (d > 1e-5 * ref.abs()) & (d > 1e-6 * top)
    ms = kernel_time(key, fn, 10, "grid_contrib_lights_kernel")
    with K.plain_reference():
        pms = events_ms(fn, 2)
    moved, ops = nbytes(halton), 0
    for j in range(lt.n_lights):
        cone = 0
        if bool(lt.l_cone[j]):
            corners = LD.voxel_corners(lo, ext, nv, 0, v, dev)
            pts = corners[None] + halton[:, None, :3] * torch.as_tensor(
                ext, device=dev)
            c = lt.l_q_o2w[j, :3, 3]
            r = lt.l_q_params[j, 0]
            cone = int((((pts - c) ** 2).sum(-1) > r * r).sum())
        w = LW.k12_light_work(lt, j, v, LD.N_SAMPLES, cone)
        moved, ops = moved + w["moved"], ops + w["ops"]
    b = bound(moved, ops)
    results[key] = dict(max_abs_err=d.max().item(), ms=ms, plain_ms=pms,
                        **b, **counts)
    log(f"{label} K12 {key}: {tuple(int(x) for x in nv)} voxels x "
        f"{LD.N_SAMPLES} probes, {ROWS[key][1]}; max abs err "
        f"{d.max().item():.3g} of max {top.max().item():.3g}, "
        f"{int(bad.sum())} sums beyond 1e-5 relative; kernel {ms:.4f} "
        f"ms, plain {pms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}: {moved} bytes, {ops} operations), "
        f"{100 * b['bound_ms'] / ms:.1f}% of it")
    if bad.any() or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{key} differs from its plain version")


def grid_of(bundle):
    """(lo, voxel extent, voxel counts) of the spatial grid over
    ``bundle``'s world bounds (scene/lightdistrib.py voxels)."""
    from rustracer_tpu_torch.scene import lightdistrib as LD
    lo, hi = bundle.world_bounds
    nv, _, ext = LD.voxels(lo, hi)
    return lo, ext, nv


def bathroom_full(dev, card, results, rays):
    """Phase 19 at full width: the bathroom with its film at BATH_RES, one
    sample in 2^18-lane tiles, counted and timed (camera rays/s beside
    testball-matte's); one step (tile 2) recorded: K15 and K16 on its
    calls; K12's lights kernel on the bathroom's whole grid, and on each
    branch: one light of tools/light_work.py's MIXED_SCENE alone
    (light_scene) over the mixed scene's grid (K12_BRANCHES)."""
    from rustracer_tpu_torch.tools import light_work as LW
    from rustracer_tpu_torch.utils import fileutil
    with open(os.path.join(REPO, "scenes", "bathroom.pbrt")) as f:
        text = f.read()
    small = '"integer xresolution" [320] "integer yresolution" [180]'
    if small not in text:
        raise AssertionError("bathroom.pbrt's Film line changed")
    text = text.replace(small, f'"integer xresolution" [{BATH_RES[0]}] '
                        f'"integer yresolution" [{BATH_RES[1]}]')
    fileutil.set_search_directory(os.path.join(REPO, "scenes"))
    bundle, parse = parse_counted(f"[19] bathroom at {BATH_RES[0]}x"
                                  f"{BATH_RES[1]}", text=text, dev=dev)
    renderer, ctx = bundle.renderer(LANES), bundle.context()
    renderer.render_state(ctx, sample_stop=1)
    launches, tiers, _, rays["bathroom"] = render_counted(
        "[19] bathroom", renderer, bundle.film, ctx, 1, card,
        depth=bundle.integrator.max_depth, res=BATH_RES)
    missing = [k for k in ("infinite_sample", "infinite_escape")
               if launches[k] <= 0]
    if missing or parse["spatial_grid_contrib_lights"] != 1:
        raise AssertionError(f"the bathroom did not launch {missing} or its "
                             "grid not once")
    log(f"[19] camera rays/s on {card}: bathroom at {BATH_RES[0]}x"
        f"{BATH_RES[1]}, 1 sample, {rays['bathroom']:.1f}; testball-matte "
        f"at {RES[0]}^2, {SAMPLES} samples (phase 16), {rays['matte']:.1f}")
    tile = renderer.tiles[2]
    per_step = step_launches(renderer, ctx, tile)
    log(f"[19] launches in one full-width bathroom step (tile 2): "
        f"{per_step}")
    cap = LW.capture_light_step(renderer, ctx, tile)
    where = f"bathroom render at {BATH_RES[0]}x{BATH_RES[1]}, 1 sample"
    check_k15(cap["infinite_sample"], results, dict(
        launches=launches["infinite_sample"],
        launches_per_step=per_step["infinite_sample"], counted_in=where))
    check_k16("[19] bathroom", cap["infinite_escape"], results, dict(
        launches=launches["infinite_escape"],
        launches_per_step=per_step["infinite_escape"], counted_in=where))
    check_k12_lights("[19] bathroom", "spatial_grid_contrib_lights",
                     bundle.lights, grid_of(bundle), results,
                     dict(launches=parse["spatial_grid_contrib_lights"],
                          launches_per_step=0,
                          counted_in="the parse of scenes/bathroom.pbrt"))
    sky = os.path.join(REPO, "scenes", "textures", "sky.exr")

    def scene(text):
        return text.replace('"textures/sky.exr"', f'"{sky}"')
    mixed, mparse = parse_counted(
        "[19] tools/light_work.py MIXED_SCENE", dev=dev,
        text=scene(LW.MIXED_SCENE).replace(
            '"string lightsamplestrategy" "uniform"',
            '"string lightsamplestrategy" "spatial"'))
    if mparse["spatial_grid_contrib_lights"] != 1:
        raise AssertionError("the mixed scene's grid is not one launch")
    counts = dict(launches=mparse["spatial_grid_contrib_lights"],
                  launches_per_step=0,
                  counted_in="the parse of tools/light_work.py MIXED_SCENE")
    for key, name in K12_BRANCHES.items():
        one, _ = parse_counted(f"[19] light_scene({name!r})",
                               text=scene(LW.light_scene(name)), dev=dev)
        check_k12_lights("[19] mixed scene", key, one.lights,
                         grid_of(mixed), results, counts)
    envmap_step(dev, results)


def envmap_step(dev, results):
    """K16's camera-ray form where camera rays see the sky: one step of
    scenes/envmap-dof.pbrt with its film at RES (tile 0: the top rows),
    recorded, checked and timed as on the bathroom (whose camera sees no
    sky)."""
    from rustracer_tpu_torch.tools import light_work as LW
    with open(os.path.join(REPO, "scenes", "envmap-dof.pbrt")) as f:
        text = f.read()
    small = '"integer xresolution" [64] "integer yresolution" [64]'
    if small not in text:
        raise AssertionError("envmap-dof.pbrt's Film line changed")
    text = text.replace(small, f'"integer xresolution" [{RES[0]}] '
                        f'"integer yresolution" [{RES[1]}]')
    bundle, _ = parse_counted(f"[19] envmap-dof at {RES[0]}^2", text=text,
                              dev=dev)
    renderer, ctx = bundle.renderer(LANES), bundle.context()
    tile = renderer.tiles[0]
    per_step = step_launches(renderer, ctx, tile)
    cap = LW.capture_light_step(renderer, ctx, tile)
    check_k16("[19] envmap-dof", cap["infinite_escape"], results, dict(
        launches_per_step=per_step["infinite_escape"],
        counted_in=f"a full-width envmap-dof step at {RES[0]}^2 (tile 0)",
        launches=per_step["infinite_escape"]),
        keys=("infinite_escape envmap-dof", None))


def no_quadric_launches(label, launches):
    """A path without quadrics launches no K14."""
    from rustracer_tpu_torch import cuda as K
    if any(launches[k] for k in K.QUADRIC_KERNELS):
        raise AssertionError(f"{label} launched K14 without a quadric: "
                             f"{launches}")


def run(dev, card):
    """Phases 3 to 20 on device ``dev``."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.render.film import Film
    from rustracer_tpu_torch.render.filters import Filter
    from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
    from rustracer_tpu_torch.scenes import (build_dragon, build_dragon_matte,
                                            dragon_geometry)
    from rustracer_tpu_torch.tools.bench_step_kernels import capture_step

    t0 = time.perf_counter()
    geometry = dragon_geometry(SUB, dev)
    ctx, cam, film, sampler, integ, n_tris = build_dragon_matte(
        sub=SUB, res=RES, spp=SPP, device=dev, geometry=geometry)
    tctx, tcam, tfilm, tsampler, tinteg, _ = build_dragon(
        sub=SUB, res=RES, device=dev, geometry=geometry)
    log(f"[3] dragon: {n_tris} triangles, BVH depth "
        f"{ctx.geom.bvh16_depth}, {ctx.geom.bvh16_table.shape[0]} records, "
        f"matte and textured scenes built in {time.perf_counter() - t0:.1f} "
        f"s; textured config {tsampler.spp} spp, {SAMPLES} rendered")
    renderer = Renderer(integ.li, cam, film, sampler,
                        RenderConfig(max_lanes=LANES), device=dev)
    trenderer = Renderer(tinteg.li, tcam, tfilm, tsampler,
                         RenderConfig(max_lanes=LANES), device=dev)
    results = {}
    check_kernels(ctx, cam, film, sampler, renderer, results)
    # the inputs of K5, K6 and K8 in one full-width textured step
    cap = capture_step(trenderer, tctx, trenderer.tiles[2])
    log(f"[3] recorded one step of textured tile 2: {len(cap['k5'])} K5, "
        f"{len(cap['k6'])} K6 and {len(cap['k8'])} K8 calls")
    check_atlas(tctx, cap, results)
    check_compaction(tctx, tcam, tsampler, tinteg, trenderer.tiles[0], cap,
                     results)
    check_gather(ctx.geom, cap, results)

    # 4-5: the matte path, counted, and its crop against the plain path
    launches, _, _, _ = render_counted("[4]", renderer, film, ctx, SPP,
                                       card)
    missing = [k for k in MATTE_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the render: {missing}")
    no_quadric_launches("[4]", launches)
    crop_film = Film(full_resolution=RES, crop_window=CROP,
                     filter=Filter("box", 0.5, 0.5))
    compare_crop("[5]", Renderer(integ.li, cam, crop_film, sampler,
                                 RenderConfig(max_lanes=LANES), device=dev),
                 crop_film, ctx)

    # 6-7: the textured headline, counted after a 1-sample warm-up, and its
    # crop in 2^16-lane tiles, where both slab tiers run in both paths
    trenderer.render_state(tctx, sample_stop=1)
    launches, tiers, dragon_img, dragon_rays = render_counted(
        "[6]", trenderer, tfilm, tctx, SAMPLES, card)
    missing = [k for k in K.FORWARD_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the render: {missing}")
    no_quadric_launches("[6]", launches)
    if tiers[2] + tiers[4] == 0:
        raise AssertionError(f"the render took no slab tier: {tiers}")
    crop_film = Film(full_resolution=RES, crop_window=TEX_CROP,
                     filter=Filter("box", 0.5, 0.5))
    crop = Renderer(tinteg.li, tcam, crop_film, tsampler,
                    RenderConfig(max_lanes=TEX_CROP_LANES), device=dev)
    for tiers in compare_crop("[7]", crop, crop_film, tctx):
        if tiers[2] == 0 or tiers[4] == 0:
            raise AssertionError(f"the crop missed a slab tier: {tiers}")

    # launches per step: tile 2 of the textured render, all floor and
    # dragon, at full width
    per_step = step_launches(trenderer, tctx, trenderer.tiles[2])
    log(f"[8] launches in one full-width textured step (tile 2): {per_step}")

    # 9-11: the gradient path
    check_backward(trenderer, tctx, results)
    cornell_train(dev, card)
    train_launches = dragon_train(dev, card, geometry, tctx, tcam, tsampler,
                                  tinteg)

    # 12-15: the scene front end
    cornell_cli()
    bundle, parse_launches = parse_counted("[13] scenes/cornell-box.pbrt",
                                           path=CORNELL_PBRT, dev=dev)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    img = bundle.render()
    torch.cuda.synchronize()
    log(f"[13] parsed Cornell box {bundle.film.full_resolution}, "
        f"{bundle.sampler.spp} spp, depth {bundle.integrator.max_depth}: "
        f"{time.perf_counter() - t0:.3f} s; launches {dict(K.LAUNCHES)}")
    if min(K.LAUNCHES[k] for k in K.GRID_KERNELS[1:]) <= 0:
        raise AssertionError("the parsed Cornell box did not launch K13")
    no_quadric_launches("[13]", K.LAUNCHES)
    check_cornell_image("[13] the in-process render", img.cpu().numpy())
    check_grid_contrib("[13]", "spatial_grid_contrib",
                       "scenes/cornell-box.pbrt", bundle, parse_launches,
                       results)
    splats, grads = dragon_file(dev, card, geometry, (trenderer, tctx),
                                dragon_img, dragon_rays, results)
    filter_cornells(dev, card, results, splats, grads)

    # 16: the quadrics
    check_quadric_table(dev, results)
    rays = {"matte": testball_full(dev, card, results)}
    scene_cli("testball-matte", 16, TESTBALL_NEED)

    # 17: the specular and microfacet lobes
    counts = testball_goldens(dev, card)
    rays["glass"] = glass_steps(dev, card, results, counts)
    scene_cli("testball-glass", 17, TESTBALL_NEED)

    # 18: substrate, translucent, uber, mix and Disney
    testball_goldens(dev, card, LAYERED, 18)
    scene_cli("testball-disney", 18, TESTBALL_NEED)
    layered_steps(dev, card, results, plain_balls(dev, card), rays)

    # 19: the lights
    for name in LIGHT_SCENES:
        scene_cli(name, 19, sum(LIGHT_NEEDS[name], ()))
    light_goldens(dev, card)
    bathroom_full(dev, card, results, rays)

    kernels = []
    for key, (name, case) in ROWS.items():
        r = results[key]
        train = key in TRAIN_ROWS
        own = "launches" in r
        replaces = QUADRIC_BRANCH if key.startswith("build_interaction ") \
            else ROW_REPLACES.get(key, SOURCES[name][1])
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name][0],
            replaces=replaces,
            launches=r["launches"] if own
            else (train_launches if train else launches)[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            ms_by=r.get("ms_by", "queued" if key in QUEUED_ROWS
                        else "profiler"),
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r.get("library_ms"),
            launches_per_step=r.get("launches_per_step",
                                    None if train or own else per_step[name]),
            launches_counted_in=r["counted_in"] if own
            else "dragon train step" if train else "textured render",
            case=case))
    missing = [k for k in K.BACKWARD_KERNELS if train_launches[k] <= 0]
    if missing:
        raise AssertionError(f"backward kernels not launched: {missing}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
