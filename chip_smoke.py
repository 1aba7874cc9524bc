"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py               # all phases
    python3 chip_smoke.py --phases ABC  # build and kernel checks only
    python3 chip_smoke.py --phases F    # build, checkpoints, sharding
    python3 chip_smoke.py --phases R    # build, the Philox draw kernel
    python3 chip_smoke.py --phases S    # build, the PT wavefront's shading
    python3 chip_smoke.py --phases V    # build, the VPT wavefront's step
    python3 chip_smoke.py --phases T    # build, BDPT's steps and rounds
    python3 chip_smoke.py --phases G    # build, the golden runner
    python3 chip_smoke.py --cards 4     # F's sharding over 4 cards only
    python3 chip_smoke.py --out DIR     # write the PNGs and reports to DIR
    python3 chip_smoke.py --baseline DIR  # also time DIR's K1-K4, K2 (E),
                                          # pt_shade (S), vpt_shade.cu (V),
                                          # bdpt_step and bdpt_connect (T)

Builds the port's nine CUDA kernel sources from csrc/, holds each against its
plain PyTorch version on the card, drives the main paths (the CLI's
path-traced Cornell box, environment-lit and textured scenes and
large-mesh scenes, its volumetric path tracer on the smoke scene, and
its other integrators: AO, BSSRDF, LT, BDPT, IR, SPPM and MLT, at
1024x1024, depth 5) and times the kernels against their plain versions.
Phases:

  A  build the dense-hit kernel (K1), the path-trace megakernel (K2), the
     block-culled hit kernel (K3), the BVH8 walk (K4) and the media
     tracking kernel (track.cu, K5's counterpart), the Philox draw
     kernel (rng.cu), the PT wavefront's shading kernel
     (pt_shade.cu), the VPT wavefront's step kernels (vpt_shade.cu:
     vpt_shade, vpt_tr_round, vpt_finish) and BDPT's kernels (bdpt.cu:
     bdpt_start, bdpt_step, bdpt_connect, bdpt_finish), one nvcc each,
     all at once,
     and the native BVH builder (g++)
  B  K1 vs plain: 1,048,576 rays, closest and any hit, its triangles-only
     and all-kinds variants on cornell_port's table, the all-kinds one on
     a 512-row synthetic table of all three kinds, a table of exact twins
     (cornell_port's twice: every tie lane must take the plain version's
     row), 30% of the lanes with empty intervals (each must miss), and
     N = 1M - 37; K3 (scenes/knot_port/blocked.json), K4 flat
     (scene.json) and K4 instanced (forest.json) vs plain on 1,048,576
     random, primary and first-bounce rays each, closest and any hit; K3
     also in its all-kinds variant, on blocked.json's table twice over
     (exact ties across blocks), with 30% empty intervals, at N = 1M - 37,
     on cornell_port's table twice over and on the synthetic table cut
     into blocks, and the blocks a ray enters (in row order, before its
     hit, along the whole ray; mean, p99) with how far a warp's lanes
     share them; K3 vs K4 on
     blocked.json's rays; K4's stack-overflow flag; on 1,048,576 rays
     through scenes/smoke_port's smoke box: track's segment_majorants
     (K5's function) bit-equal to the plain version, with and without
     the global-majorant fallback and at an N that is not a multiple of
     its block, its walk vs the plain walk in sample mode and in tr mode
     for ett 0, 1 and 2 (bit-equal on >= 99.99% of lanes, equal
     candidate counts) on the phase-B lanes, on a sparse set (three
     quarters of 1M lanes in vacuum or the fog, at random), on a set
     where no lane walks (an empty queue) and at an N that is not a
     multiple of the block size, with a per-lane call site (the VPT
     step's one walk: against the plain walk and bit-equal to each site's
     own walk), and rays that miss the box (Tr exactly 1, no candidate);
     the walk's launch shapes (occupancy API)
  C  K2 vs plain: 65,536 lanes at depth 5 on both bundled scenes and on
     its environment, textured and mixed variants' scenes
     (scenes/env_port/scene.json, scenes/cornell_port/textured.json,
     scenes/env_port/mixed.json) and on a sky alone of zero power (its
     texel [0, 0] black, written to --out), from a primary-sample
     matrix and from in-kernel Philox; the wavefront over
     K1 vs the same plain version, on those and on many_lights.json (72
     lights, which pt.render_lanes routes to the wavefront: K1's launches
     there are recorded as `launches_wavefront_route`); the wavefront over
     K3, K4 flat and K4 instanced vs the plain wavefront on the knot
     scenes and on knot_port/sky.json (textures, the sky), 65,536 lanes,
     from Philox and from a primary-sample matrix; the VPT wavefront over
     K1, track and the step's kernels (vpt_shade.cu) vs the all-plain VPT
     on smoke_port and on smoke_port/sky.json, 65,536 lanes, and its rays
     traced (from Philox: VPT takes no primary-sample matrix, as in the
     JAX package); the
     programs of the other integrators, each over the kernels against
     the same program all-plain (`plain=True`), 65,536 lanes at depth 5:
     AO, light tracing and BDPT on cornell_port, the path tracer on
     cornell_port/bssrdf.json (dipole BSSRDFs: the wavefront's
     subsurface hook), light tracing and BDPT on smoke_port (the Tr walks
     of track.cu; BDPT over bdpt.cu's kernels), BDPT on knot_port (K4,
     its any-hit serving the queue), on knot_port/blocked.json (K3, whose
     any-hit skips the queue's empty tmax-0 slots) and at depth 17 (323
     queue slots a lane) on cornell_port and on smoke_port (the Tr walks
     over the live slots), with the run's seconds and peak device
     memory; a splat
     film and the per-lane radiance are held to the radiance limits
     apart (the film on the pixels either run touched); BDPT at depth 17
     over the kernels on the 1M-lane tile, its lanes in queue-sized
     chunks, its time and peak device memory; instant radiosity on
     cornell_port, 65,536 lanes, its VPL
     store of 32 light paths held field by field, and K1's any hit at
     the JAX package's gather shape (32 slots x 1,048,576 lanes in one
     call) against the same rays in calls of 1,048,576; SPPM and MLT,
     which couple all pixels, as whole 256x256 images for 2 iterations:
     SPPM's radius, photon statistic and film, MLT's bootstrap
     candidates, chain luminance and film, on cornell_port and on
     cornell_port/mlt_slit.json (its depth 10: K2 reading [84, 65,536])
  R  (after C) rng.cu vs its plain version (core/rng.py::
     philox_uniform_torch), bit for bit: 1,048,576 lanes x 136 rows (an
     MLT step's shape), lanes up to 2**32 - 1 at N = 1M - 37, a first
     block of 7, tags 0-6, keys 0 and 2**32 - 1, uniform_rows at 1, 7,
     135 and 136 rows and a PhiloxStream across blocks; one cornell_port
     spp through K2, one MLT step of 1M chains (state and image) and one
     knot scene.json spp over K4, each with its draws from the kernel
     and from the plain version (`plain_draws`), bit-equal; the
     kernel, the plain version and the bound (bytes, or the kernel's
     SASS instructions at the issue peak) in turns at the camera's shape
     (1M lanes x 4 rows) and MLT's
  S  (after R) pt_shade.cu vs its plain version (integrators/pt_shade.py::
     shade_wave_torch over shade_torch) on copies of the same state (a
     pt_shade.Wave: the lane records, the next ray, the shadow ray, the
     keys, the counts and the list of the sorted rows, the radiance by
     slot): one bounce of 1,048,576 lanes captured from a wavefront spp
     over the kernels (SHADE_CASES: knot scene.json bounces 0, 1 and the
     epilogue, bounce 1 from a psample, knot sky.json, many_lights.json's
     72 lights (also with its light picks at the CDF's steps),
     textured.json, env_port's scene.json and mixed.json, materials.json's
     lines, spheres and six models, bssrdf.json's subsurface lanes), every
     word of the state bit for bit (the appended list as a set) and the
     ray counts; one spp of knot scene.json, forest.json,
     many_lights.json and bssrdf.json at 1024^2 depth 5 over the kernels
     vs all-plain (`SHADE_FILMS`), and all but forest's also with the shading
     kernel over the plain hit queries, bit for bit; the kernel alone (its
     entry point on the wrapper's structure, the state put back) at each
     bounce of knot scene.json's spp against its recounted bound
     (`shade_work`: a field where a lane reads it, a word where its value
     changes), with --baseline DIR also DIR's pt_shade.cu alone on the
     same states in its own layout, in turns; the plain version at
     bounce 1; registers and blocks an SM
  V  (after S) vpt_shade.cu vs its plain versions (integrators/
     vpt_shade.py::shade_torch, tr_round_torch, finish_torch) on the same
     inputs, captured by name from a VPT spp over the kernels at 1024^2
     (VPT_CASES: smoke_port at steps 0, 1, 6 and 13, the last, where
     lanes only collect credit; the camera in the fog; the camera in the
     smoke, whose camera rays reach the light through it (emitter
     walks); smoke_port/sky.json; cornell_port without media;
     materials.json's lines and spheres; textured.json; bssrdf.json):
     vpt_shade at the step, vpt_tr_round at its rounds 0 and 1 (each on
     a copy of its inputs, which it updates in place) and vpt_finish
     after the last step, every output bit for bit on every lane (float32
     compared as int32 bits; the walk as later launches read it,
     vpt_shade.live_walk) and the ray counts, and the lists each kernel
     read and appended against the plain helpers' (shade_list,
     round_list) as sets; the launch shapes (occupancy API); each kernel
     alone (its entry point on the wrapper's argument structure, the
     state put back before each launch), its plain version and its
     recounted bound (the bytes the listed lanes must read, a word
     written where its value changes, and the lists) in turns on
     smoke_port's inputs (step 1, its round 1, the finish after the
     last step), and each wrapper's host microseconds a call; one
     spp of smoke_port under torch.profiler: each step's and round's
     kernel ms, list length and bound, and their sums a spp; with
     --baseline DIR, DIR's vpt_shade.cu built here and driven by DIR's
     vpt_shade.py and vpt.py: a whole spp of smoke_port bit-equal to
     this checkout's, both kernels alone in turns with this checkout's
     at steps 1 and 6 (against the recounted bounds), and DIR's spp by
     launch
  T  (after V) bdpt.cu vs its plain versions (integrators/bdpt_shade.py::
     start_torch, step_torch, connect_torch, finish_torch) on the same
     inputs: one
     BDPT sample over the kernels at 1024^2 depth 5 on 1M lanes
     (BDPT_CASES: cornell_port, the bench row's shape; smoke_port, with
     smoke, fog, interfaces, sample walks and Tr walks; materials.json's
     six BSDFs, lines and spheres; textured.json) and at depth 17 on
     cornell_port's first 65,536 lanes (K = 18: one lane a warp in
     bdpt_connect), each kernel call held against its
     plain version on a copy of its input (the table slots at and above
     a row's count, which the kernels leave unwritten, set to the plain
     tables' empty values): bdpt_start's and bdpt_step's vertex tables
     below the count and rows' state, bdpt_connect's t0 radiance and queue
     (flags and tmax on every slot, shadow ray, credit, medium and pixel
     on the live ones) and bdpt_finish's radiance bit for bit, the rays
     equal, the film within the radiance limits; on smoke_port the
     queue's one Tr walk against a walk per round, bit for bit; then
     each kernel, its plain version and its byte bound in turns on
     cornell_port's inputs (the start, step 1, the connection rounds,
     the finish); bdpt_connect's bound also by operations (the
     instructions of its staged vertices, items by round and kept slots,
     CONNECT_OPS, at the issue peak), its registers,
     stack frame and launch shape (the occupancy API) at K = 6 and 18;
     bdpt_step alone (its entry point on the wrapper's structure, the
     rows' state put back) at each step of cornell_port's sample against
     its recounted bound (`bdpt_step_bound`: every row's flag, the live
     rows' fields where read, a word where its value changes), its
     registers and blocks an SM; bdpt_finish alone on cornell_port's
     queue, its registers and blocks an SM; with --baseline DIR, DIR's
     bdpt.cu built here: its bdpt_step alone at each step in turns with
     this checkout's, its bdpt_finish (li bit for bit, the film within
     the radiance limits) alone in turns with this checkout's, and its
     bdpt_connect held bit for bit against this checkout's and timed in
     turns with it on the same inputs. Phase C holds every bdpt_step and
     bdpt_finish call of its BDPT runs the same way (bdpt_checked)
  D  the main paths through the CLI, each with every launch count set to
     0 just before it and read just after, then timed from where its
     render stands by the bench's windows (run/bench.py: D_WINDOWS
     windows of at least 2 spp and 0.5 s; median spp/s with the windows'
     min and max, Mrays/s): scenes/cornell_port at 1024^2 through the
     megakernel (the radiance against the plain version's lane by lane);
     env_port/scene.json and cornell_port/textured.json through K2's
     environment and textured variants (one warm-up spp held against the
     plain version on all lanes, then 8 timed spp);
     scenes/knot_port/scene.json at 1024^2 through K4 (one warm-up spp
     held against the plain wavefront on all 1,048,576 lanes, whose
     bounce-1 closest-hit and shadow calls are captured for phase E, then
     8 timed spp: spp/s, Mrays/s, host build seconds); forest.json (K4
     instanced, its host build timed cold on an emptied BVH cache and on
     a cache hit) and blocked.json (K3; bounce 1's closest-hit call of its
     warm-up spp captured for phase E) the same with 2 timed spp, and
     knot_port/sky.json (K4 with textures and the sky) with its host build
     timed cold (an emptied BVH cache) and on a cache hit, beside the
     numpy BVH builder's time on the same prims;
     scenes/smoke_port with --integrator vpt (one warm-up spp held
     against the plain VPT on all lanes, whose first Tr walk of step 1
     is captured for phase E and whose K1 calls report, per step, the
     lanes alive and K1's warps wholly empty, then 2 timed spp; K1,
     track, vpt_shade, vpt_tr_round, vpt_finish and rng must launch,
     nothing else,
     with their launches a spp); then the other integrators through
     the CLI at 1024^2 depth 5 (one warm-up spp held against the
     program all-plain on all lanes, then timed spp: spp/s, Mrays/s,
     launches per kernel, plain-version calls on CUDA, which must be 0,
     and torch.cuda.max_memory_allocated()): AO on cornell_port (K1) and
     on knot_port/scene.json (K4, its probe an any-hit query ending at
     maxDist) with 8 spp each, the path tracer on cornell_port/bssrdf.json
     (K1) with 8, light tracing and BDPT on cornell_port (K1; BDPT also
     bdpt.cu's three kernels, with their launches a spp) with 2,
     and on cornell_port IR (K1, 8 iterations), SPPM (K1, 4 iterations
     at the scene's 100,000 photons) and MLT (K2 reading the chains'
     [44, 1M] primary-sample matrix, 8 steps; the bootstrap is made
     before the CLI's timed window), their warm-up iteration held
     against the program all-plain (MLT's from the kernels' bootstrap,
     whose candidates are held too), with the largest K1 call's rays
  E  times, in windows of about one second, kernel and plain in turns:
     K1 vs plain at 1M rays; K2 alone vs plain from the same primary
     rays at 1024^2 depth 5, and the camera that makes those rays; K2's
     other variants the same on their scenes (env, textured, mixed,
     materials.json); K3 on
     blocked.json, K4 flat on scene.json, K4 instanced on forest.json
     vs plain on the 1M primary and first-bounce rays, each with its
     bound; K3 on the call captured from blocked.json's main path, with
     its bound and blocks entered (K3's bound counts the least work of
     its culling levels, `k3_work`); K4 on the two calls captured from
     scene.json's main path; K4's bounds count the nodes, leaves and
     records any walk of its table must test before each ray's hit
     (`k4_work`), printed per live ray; K4 flat on
     blocked.json's table beside K3; segment_majorants vs plain vs the
     one PyTorch call of K5's lookup (med_sv_max[idx] on the same
     [1M, 42] indices); the tracking walk vs plain on the phase-B rays
     and on the main path's captured call.
     Each kernel's bound (bytes over 3.35 TB/s or float32 operations
     over 67 TFLOP/s, whichever is larger) is computed from these calls.
     With --baseline DIR (another checkout, e.g. `git archive` of the
     parent commit unpacked under build/), K1-K4 of DIR and of this
     checkout are then timed on the same saved calls (K1's 1M phase-E
     rays and two calls of the VPT warm-up spp, K2's primary rays of
     each variant, K3's and K4's primary, bounce and main-path calls),
     each checkout in its own process, in turns; K2's outputs on its
     calls must be bit-equal between the checkouts.
  F  checkpoints and sharding (run/checkpoint.py, parallel/dist.py), at
     1024^2 depth 5: PT on cornell_port (K2) and on knot_port/scene.json
     (K4), VPT on smoke_port (K1 + track) and IR, SPPM and MLT on
     cornell_port each render 2 iterations, save a checkpoint (its MB and
     write seconds), render 2 more; a new renderer loads the file (read
     seconds) and renders 2: PT, VPT and IR bit-equal, SPPM's radius and
     photon statistic and MLT's chain luminance equal, their films within
     the radiance limits. PT, VPT, LT, BDPT, IR, SPPM and MLT render 2
     iterations unsharded, then through Renderer(shard=True) on a group of
     one NCCL rank (this process, a file:// store) and on 2 gloo ranks
     on cuda:0 (this script under torchrun, `--rank-of gloo`), each held
     against the unsharded render (PT, VPT, IR bit-equal; LT, BDPT within
     the radiance limits; SPPM, MLT as above; the rays equal), with the
     all_reduce milliseconds per iteration and of the film's read; then
     whether NCCL takes 2 ranks on one card (`--rank-of nccl-pair`,
     killed after 120 s). Last, the CLI with --profile for 1 spp of cornell_port:
     the trace must name K2's pt_fused_kernel. Every path's launches must
     be its kernels' (> 0 each) and its plain-version calls on CUDA 0.
  G  the golden suite's runner (run/golden.py) at its own settings, 256
     high and 128 spp, over repo scenes whose goldens it writes itself
     with run/reference.py's all-plain route at the same seed
     (GOLDEN_G): cornell_port (PT through K2; golden at 256^2, 128
     spp), smoke_port (VPT through K1, track and vpt_shade.cu, under
     golden._smoke_mask; golden 1 spp at 1024^2, its radiance averaged
     down by 4 before the tonemap) and env_port at 16:9 (K2's sky
     variant at 455x256; golden at 1280x720, 32 spp, which run_one
     resamples with its BOX); each golden.run_one with every launch
     count set to 0 just before it and read just after: its RMSE under
     its gate, its seconds, the kernels it launched (those of its route,
     no other, no plain version on CUDA). Then, where
     golden.RESULT exists, the five real goldens through
     golden.main, each RMSE printed beside the JAX package's TPU RMSE in
     GOLDEN_r5.json (a FAIL fails the phase); where it is absent, a line
     says so

Every check that fails exits non-zero before the last line. The last two
lines are the kernels' JSON record and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Outputs (PNGs, compiler reports, the BVH cache) go to build/chip_smoke/
unless --out names another directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "chip_smoke")   # set by --out
SCENES = ("scenes/cornell_port/scene.json", "scenes/cornell_port/materials.json")
MANY_LIGHTS = "scenes/cornell_port/many_lights.json"   # 72 lights: wavefront
K2_VARIANTS = {   # K2's variants: the scene each one's main path renders
    "env": "scenes/env_port/scene.json",            # the sky alone
    "textured": "scenes/cornell_port/textured.json",  # graph-paper floor
    "mixed": "scenes/env_port/mixed.json",   # texture, area light and sky
}
KNOT = {   # the large-mesh scenes, by the kernel their route runs
    "blocked": "scenes/knot_port/blocked.json",   # 16,012 prims: K3
    "scene": "scenes/knot_port/scene.json",       # 100,012 prims: K4 flat
    "forest": "scenes/knot_port/forest.json",     # 1,000,012: K4 instanced
    "sky": "scenes/knot_port/sky.json",   # 100,004, textured, sky: K4 flat
}
SMOKE = "scenes/smoke_port/scene.json"   # VPT: smoke grid + fog, 25 prims
SMOKE_SKY = "scenes/smoke_port/sky.json"   # the same under the sky
BSSRDF = "scenes/cornell_port/bssrdf.json"   # dipole BSSRDF boxes: wavefront
# the other integrators' programs of phase C: (integrator, scene)
PROGRAMS_C = (("ao", SCENES[0]), ("lt", SCENES[0]), ("bdpt", SCENES[0]),
              ("pt", BSSRDF), ("lt", SMOKE), ("bdpt", SMOKE))
MLT_SLIT = "scenes/cornell_port/mlt_slit.json"   # a room lit through a slit
# the deepest scenes' maxDepth (scenes/cornell_dof, scenes/fur, whose
# meshes lie outside the repository): cornell_port runs BDPT at it
DEEP = 17
# BDPT beyond the bench row's shape in phase C, over the kernels against
# all-plain: (scene, depth, its hit kernel): through K4 and K3, whose
# any-hit then serves the queue too (K3 skipping its empty tmax-0 slots),
# and at depth 17 (323 queue slots a lane) without and with media (the
# Tr walks over the live slots)
BDPT_C = ((KNOT["scene"], 5, "bvh8_walk"), (KNOT["blocked"], 5, "blocked"),
          (SCENES[0], DEEP, "dense_hit"), (SMOKE, DEEP, "dense_hit"))
# the programs that couple all pixels, as whole images in phase C:
# (integrator, scene)
COUPLED_C = (("sppm", SCENES[0]), ("mlt", SCENES[0]), ("mlt", MLT_SLIT))
# and the main paths of phase D: (integrator, scene, timed spp or
# iterations, kernel)
PROGRAMS_D = (("ao", SCENES[0], 8, "dense_hit"),
              ("ao", KNOT["scene"], 8, "bvh8_walk"),
              ("pt", BSSRDF, 8, "dense_hit"),
              ("lt", SCENES[0], 2, "dense_hit"),
              ("bdpt", SCENES[0], 2, "dense_hit"),
              ("ir", SCENES[0], 8, "dense_hit"),
              ("sppm", SCENES[0], 4, "dense_hit"),
              ("mlt", SCENES[0], 8, "pt_fused"))
# what the VPT launches on the card: the hit kernel of smoke_port's regime,
# the tracking walk, the step's kernels, the camera's draws
VPT_KERNELS = ("dense_hit", "track", "vpt_shade", "vpt_tr_round",
               "vpt_finish", "rng")
# and BDPT's per-lane kernels around the hit kernel (and track in media)
BDPT_KERNELS = ("bdpt_start", "bdpt_step", "bdpt_connect", "bdpt_finish")
KERNELS = {   # name: (source, TPU kernel it replaces)
    "dense": ("gpu_pathtracer_tpu_torch/csrc/dense.cu",
              "gpu_pathtracer_tpu/geom/dense_tpu.py:29"),
    "pt_fused": ("gpu_pathtracer_tpu_torch/csrc/pt_fused.cu",
                 "gpu_pathtracer_tpu/integrators/pt_fused.py:977"),
    "blocked": ("gpu_pathtracer_tpu_torch/csrc/blocked.cu",
                "gpu_pathtracer_tpu/geom/dense_tpu.py:316"),
    "bvh8_walk": ("gpu_pathtracer_tpu_torch/csrc/bvh8_walk.cu",
                  "gpu_pathtracer_tpu/geom/packet_tpu.py:126"),
    "track": ("gpu_pathtracer_tpu_torch/csrc/track.cu",
              "gpu_pathtracer_tpu/ops/small_gather.py:30"),
    "rng": ("gpu_pathtracer_tpu_torch/csrc/rng.cu",
            "no Pallas kernel; the JAX package's `jax.random` draws and "
            "`pt_fused.py:910`'s in-kernel generator"),
    "pt_shade": ("gpu_pathtracer_tpu_torch/csrc/pt_shade.cu",
                 "no Pallas kernel; the JAX package's jitted wavefront "
                 "bounce, `gpu_pathtracer_tpu/integrators/pt.py:167`"),
    "vpt_shade": ("gpu_pathtracer_tpu_torch/csrc/vpt_shade.cu",
                  "no Pallas kernel; the JAX package's jitted VPT step, "
                  "`gpu_pathtracer_tpu/integrators/vpt.py:128`"),
    "vpt_tr_round": ("gpu_pathtracer_tpu_torch/csrc/vpt_shade.cu",
                     "no Pallas kernel; the JAX package's jitted VPT step's "
                     "Tr walk, `gpu_pathtracer_tpu/shade/media.py:950`"),
    "vpt_finish": ("gpu_pathtracer_tpu_torch/csrc/vpt_shade.cu",
                   "no Pallas kernel; the JAX package's jitted VPT render's "
                   "NaN guard, `gpu_pathtracer_tpu/integrators/vpt.py:311`"),
    "bdpt_start": ("gpu_pathtracer_tpu_torch/csrc/bdpt.cu",
                   "no Pallas kernel; the JAX package's jitted BDPT "
                   "subpaths' vertex 0 and first ray, `gpu_pathtracer_tpu/"
                   "integrators/bdpt.py:312` and `:344`"),
    "bdpt_step": ("gpu_pathtracer_tpu_torch/csrc/bdpt.cu",
                  "no Pallas kernel; the JAX package's jitted BDPT subpath "
                  "step, `gpu_pathtracer_tpu/integrators/bdpt.py:182`"),
    "bdpt_connect": ("gpu_pathtracer_tpu_torch/csrc/bdpt.cu",
                     "no Pallas kernel; the JAX package's jitted BDPT "
                     "connection rounds, `gpu_pathtracer_tpu/integrators/"
                     "bdpt.py:547` and `:832`"),
    "bdpt_finish": ("gpu_pathtracer_tpu_torch/csrc/bdpt.cu",
                    "no Pallas kernel; the JAX package's jitted BDPT "
                    "crediting and splatting, `gpu_pathtracer_tpu/"
                    "integrators/bdpt.py:465`"),
}


def libraries() -> list:
    """The csrc/*.cu sources of KERNELS, one library each."""
    return sorted({os.path.basename(src)[:-3] for src, _ in KERNELS.values()})
HBM_BYTES_PER_S = 3.35e12   # H100 SXM: device memory rate
F32_FLOPS = 67e12           # and float32 peak outside the tensor cores
RAY_IO = 40       # bytes per ray of a hit query: ro rd tmin tmax, t prim
TRI_FLOPS = 40    # float operations of one ray-triangle test
SPHERE_FLOPS = 20  # of one ray-sphere test (csrc/intersect.cuh sphere_hit)
LINE_FLOPS = 67   # of one ray-segment test (line_hit)
SLAB_FLOPS = 24   # of one ray-box slab test
N_RAYS = 1 << 20  # rays of the kernel-vs-plain checks and timings
SEED = 2024
# phase D's timing, the bench's windows (run/bench.py): how many, and
# each of at least this many spp and seconds
D_WINDOWS = (3, 2, 0.5)
_FLAT = {}   # scene path -> (DeviceScene, StaticConfig, host seconds)
BASELINE = None   # --baseline: another checkout, timed on phase E's calls
# the calls phase E times K1-K4 on, for --baseline: {label: hit_call(...)}
HIT_INPUTS = {}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def only(counts: dict, *knames) -> bool:
    """Whether each kernel of `knames` launched and no other did, the
    Philox draw kernel apart (rng: any path that draws from Philox
    launches it; name it in `knames` to require it)."""
    return all(counts[k] > 0 for k in knames) and not any(
        n for k, n in counts.items() if k not in (*knames, "rng"))


def kernel_name(mangled: str) -> str:
    """The length-prefixed "..._kernel" identifier in a mangled name (the
    prefix may follow other digits, as in an anonymous namespace's hash)."""
    import re
    names = [mangled[d.end():d.end() + int(d.group()[j:])]
             for d in re.finditer(r"\d+", mangled)
             for j in range(len(d.group()))]
    names = [n for n in names if n.endswith("_kernel")]
    return min(names, key=len) if names else mangled[:24]


# bdpt.cu's template flags, in order
BDPT_FLAGS = {"bdpt_step_kernel": ("tex", "all kinds", "heterogeneous"),
              "bdpt_connect_kernel": ("tex",)}


def ptxas_summary(report: str, only: str = "") -> str:
    """nvcc's -Xptxas -v report, one "registers, stack frame, spills"
    entry per kernel entry point (those named `only`, where given),
    template variants named by their flags (K2: sky, textures, all prim
    kinds; K1, K3, K4: all prim kinds; BDPT_FLAGS for bdpt.cu's)."""
    import re
    out, label, frame = [], "?", ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            label = kernel_name(m.group(1))
            flags = re.findall(r"Lb(\d)E", m.group(1))
            lanes = re.findall(r"Li(\d+)E", m.group(1))
            if label == "bdpt_finish_kernel" and lanes:
                label += f" (lanes {lanes[0]}, verdicts {flags[0]})"
            elif label in BDPT_FLAGS:
                label += " (" + ", ".join(
                    f"{f} {x}" for f, x in zip(BDPT_FLAGS[label], flags)) \
                    + ")" if flags else ""
            elif len(flags) == 4:
                label += (f" (env {flags[0]}, tex {flags[1]}, all kinds "
                          f"{flags[2]}, heterogeneous {flags[3]})")
            elif len(flags) == 3:
                label += (f" (env {flags[0]}, tex {flags[1]}, all kinds "
                          f"{flags[2]})")
            elif flags:
                label += f" (all kinds {flags[0]})"
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            if label.startswith(only):
                out.append(f"{label}: {regs} registers, {frame}")
    return " | ".join(out)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` runs (CUDA events,
    after one warm-up run)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_windows(fns: dict, window_ms: float = 1000.0,
                  min_reps: int = 3) -> dict:
    """Time each fn of `fns` ({name: fn}) in windows of about `window_ms`
    (at least `min_reps` runs) on the card, in turns a, b, ..., ..., b, a
    -> {name: [ms per run, one value per window]}."""
    reps = {k: max(min_reps, int(window_ms / max(cuda_ms(f, 1), 1e-3)))
            for k, f in fns.items()}
    order = list(fns) + list(fns)[::-1]
    out = {k: [] for k in fns}
    for k in order:
        out[k].append(cuda_ms(fns[k], reps[k]))
    return out


def rate(r) -> str:
    """The bench's measurement (run/bench.py's windows) of renderer r's
    progressive render from where it stands: D_WINDOWS windows, the
    median spp/s with the windows' min and max, and the median Mrays/s."""
    from gpu_pathtracer_tpu_torch.run import bench
    s = bench.window_summary(bench.windows(r, *D_WINDOWS))
    return (f"{s['value']:.3f} spp/s (windows {s['min']:.3f}-"
            f"{s['max']:.3f}, {s['spp']} spp in {s['seconds']:.3f} s), "
            f"{s['mrays_s']:.1f} Mrays/s")


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the peak rate."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations"}


def type_flops(ty):
    """Float operations of one ray against a prim of each type code of
    `ty` (dense_prims column 9); pad rows (type -1) can never be hit and
    count none."""
    return ((ty == 0) * TRI_FLOPS + (ty == 1) * LINE_FLOPS
            + (ty == 2) * SPHERE_FLOPS).to(torch.int64)


def row_flops(table) -> int:
    """Float operations of one ray against every prim of a dense_prims
    table, each row by its type."""
    return int(type_flops(table[:, 9]).sum())


def zero_power_sky_scene() -> str:
    """A grey sphere at 256x256 under a sky alone whose texel [0, 0] is
    black (black poles), written to OUT: the sky has zero power, so the
    light CDF is [0, 0, 1] and every NEE pick lands on light_attrs' dummy
    row, which must give no light sample. Returns the scene's path."""
    from gpu_pathtracer_tpu_torch.film.imageio import save_exr
    d = os.path.join(OUT, "zero_power_sky")
    os.makedirs(d, exist_ok=True)
    sky = np.ones((64, 128, 3), np.float32)
    sky[0] = sky[-1] = 0.0
    save_exr(os.path.join(d, "sky.exr"), sky)
    doc = {
        "screen_width": 256, "screen_height": 256, "integrator": "pt",
        "maxDepth": 5, "camera": {"position": [0, 0, 4], "lookat": [0, 0, 0],
                                  "fov": 40, "filmicTonemap": False},
        "material": [{"name": "Grey", "bsdf": "lambertian",
                      "diffuse": [0.5, 0.5, 0.5]}],
        "scene": [{"sphere": True, "center": [0, 0, 0], "radius": 0.8,
                   "material": "Grey"}],
        "light": [{"infinite": "sky.exr", "rotate": [10, 30, 0]}],
    }
    path = os.path.join(d, "zero_power_sky.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def flat(key: str, dev):
    """The knot scene `key`, or the scene at repo path `key`, flattened on
    `dev` (once per run)."""
    from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    path = os.path.join(REPO, KNOT.get(key, key))
    if path not in _FLAT:
        t0 = time.perf_counter()
        scene, static = flatten_scene(load_scene(path), dev)
        _FLAT[path] = (scene, static, time.perf_counter() - t0)
    return _FLAT[path][:2]


def hit_check(label, closest_k, closest_p, any_k, any_p, canon=None,
              empty=None, exact_ties=True) -> float:
    """Kernel vs plain hits on one ray set: prim equal and any-hit equal
    on >= 99.99% of lanes, t within 1e-4 relative where the prim agrees.
    With `canon` (a prim id per table row, equal for exact twins): on
    every lane where both hit twins of one prim (a tie), the same row
    (unless not `exact_ties`: then the tie lanes that take the other
    twin are counted, and held to the prim limit with the rest).
    With `empty` (lanes whose interval is empty): a miss on every one.
    Returns the largest |t_kernel - t_plain| where the prim agrees."""
    (t_k, p_k), (t_p, p_p) = closest_k, closest_p
    same = p_k == p_p
    both = same & (p_k >= 0)
    err = (t_k - t_p).abs()[both]
    rel = err / t_p.abs()[both].clamp_min(1e-30)
    same_frac = same.float().mean().item()
    any_frac = (any_k == any_p).float().mean().item()
    rel_max = rel.max().item() if rel.numel() else 0.0
    extra = ""
    if canon is not None:
        hit2 = (p_k >= 0) & (p_p >= 0)
        twin = hit2 & (canon[p_k.clamp_min(0).long()]
                       == canon[p_p.clamp_min(0).long()])
        n_tie, n_bad = int(twin.sum()), int((twin & ~same).sum())
        extra += f", tie lanes {n_tie} (other row on {n_bad})"
        check(n_tie > 0 and (n_bad == 0 or not exact_ties),
              f"{label}: {n_bad} of {n_tie} tie lanes take another row")
    if empty is not None:
        bad = int((empty & ((p_k >= 0) | any_k | (t_k != t_p))).sum())
        extra += f", empty lanes {int(empty.sum())} (not a miss on {bad})"
        check(bad == 0, f"{label}: {bad} empty lanes are not a miss")
    print(f"[B] {label}: {p_k.numel()} rays, hit "
          f"{(p_k >= 0).float().mean():.4f}, prim equal {same_frac:.6f}, "
          f"t max rel err {rel_max:.3e}, any-hit equal {any_frac:.6f} "
          f"(any-hit hit {any_k.float().mean():.4f}){extra}")
    check(same_frac >= 0.9999, f"{label}: prim equal on {same_frac}")
    check(rel_max <= 1e-4, f"{label}: t rel err {rel_max}")
    check(any_frac >= 0.9999, f"{label}: any-hit equal on {any_frac}")
    return err.max().item() if err.numel() else 0.0


def with_empty(rng, tmax, share=0.3):
    """tmax with `share` of the lanes given an empty interval (tmax 0 or
    -1, below every tmin here) -> (tmax, empty mask)."""
    n = tmax.shape[0]
    empty = torch.as_tensor(rng.random(n) < share, device=tmax.device)
    dead = torch.as_tensor(rng.choice(np.float32([0.0, -1.0]), n),
                           device=tmax.device)
    return torch.where(empty, dead, tmax).contiguous(), empty


def blocked_table(rows):
    """A K3 table from dense_prims rows of any kinds: the rows padded to
    whole 64-row blocks (type -1 pad rows) and each block's box, widened
    by 1e-5 -> (table [nb * 64, 16], block_bbox [nb, 8])."""
    from gpu_pathtracer_tpu_torch.geom.blocked import BLOCK
    n = rows.shape[0]
    pad = (-n) % BLOCK
    table = torch.cat([rows, torch.zeros((pad, 16), device=rows.device)])
    table[n:, 9] = -1.0
    ty, v0 = table[:, 9], table[:, 0:3]
    a, b = table[:, 3:6], table[:, 6:9]
    r = table[:, 10:12].amax(1, keepdim=True)
    tri = (ty == 0)[:, None]
    sph = (ty == 2)[:, None]
    lo = torch.where(tri, torch.minimum(v0, torch.minimum(v0 + a, v0 + b)),
                     torch.where(sph, v0 - r, torch.minimum(v0, a) - r))
    hi = torch.where(tri, torch.maximum(v0, torch.maximum(v0 + a, v0 + b)),
                     torch.where(sph, v0 + r, torch.maximum(v0, a) + r))
    pad_row = (ty < 0)[:, None]
    lo = torch.where(pad_row, torch.inf, lo - 1e-5)
    hi = torch.where(pad_row, -torch.inf, hi + 1e-5)
    bbox = torch.zeros((table.shape[0] // BLOCK, 8), device=rows.device)
    bbox[:, 0:3] = lo.view(-1, BLOCK, 3).amin(1)
    bbox[:, 3:6] = hi.view(-1, BLOCK, 3).amax(1)
    return table.contiguous(), bbox


def doubled(table, bbox):
    """A K3 table twice over, the copy's blocks in reverse order after the
    original's: every prim has an exact twin in another block, at a
    larger row, with the same box (tests/test_torch_walk.py::doubled)."""
    from gpu_pathtracer_tpu_torch.geom.blocked import BLOCK
    rows = table.view(bbox.shape[0], BLOCK, 16)
    return (torch.cat([rows, rows.flip(0)]).reshape(-1, 16).contiguous(),
            torch.cat([bbox, bbox.flip(0)]).contiguous())


def ray_sets(scene, static, rng, dev) -> dict:
    """1,048,576 rays each: random rays in the room, the scene's primary
    rays (the camera at 1024^2, Philox seed SEED) and first-bounce rays
    (from the primary hits, cosine-distributed about the normal facing
    the camera ray). {name: (ro, rd, tmin, tmax closest, tmax any)}."""
    from gpu_pathtracer_tpu_torch.core.rng import PSS_CAM_DIMS, lane_stream
    from gpu_pathtracer_tpu_torch.core.vecmath import face_forward, normalize
    from gpu_pathtracer_tpu_torch.geom import traverse
    from gpu_pathtracer_tpu_torch.integrators import pt
    from gpu_pathtracer_tpu_torch.integrators.common import primary_rays
    n = static.width * static.height
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    tmin = torch.full((n,), float(scene.epsilon), device=dev)
    out = {}
    ro, rd, _, tmax = random_rays(rng, n, dev)
    out["random"] = (ro, rd, tmin, tmax, tmax)
    ids = torch.arange(n, device=dev, dtype=torch.int32)
    px, py = ids % static.width, ids // static.width
    lanes = pt.lane_ids_of(static, px, py)
    ro, rd = primary_rays(scene, static,
                          lane_stream(SEED, 1, lanes, None, 0, PSS_CAM_DIMS),
                          px, py)
    ro, rd = ro.contiguous(), rd.contiguous()
    inf = torch.full((n,), torch.inf, device=dev)
    out["primary"] = (ro, rd, tmin, inf, f32(rng.uniform(0.5, 8.0, n)))
    hit = traverse.intersect_closest(scene, static, ro, rd, tmin, inf)
    nf = face_forward(hit.nor, -rd)
    d2 = normalize(nf + normalize(f32(rng.normal(size=(n, 3)))))
    ro2 = torch.where(hit.valid[:, None], hit.pos, ro).contiguous()
    rd2 = torch.where(hit.valid[:, None], d2, rd).contiguous()
    out["bounce"] = (ro2, rd2, tmin, inf, f32(rng.uniform(0.1, 2.0, n)))
    return out


def synthetic_table(rng, n_prims=512):
    """A 512-row dense_prims table of all three prim types inside the
    Cornell room: 256 triangles, 128 spheres, 128 line segments."""
    from gpu_pathtracer_tpu_torch.scene.model import GeometryType
    t = np.zeros((n_prims, 16), np.float32)
    n_tri, n_sph = n_prims // 2, n_prims // 4
    lo, hi = np.array([-0.9, 0.1, -0.9]), np.array([0.9, 1.9, 0.9])
    v0 = rng.uniform(lo, hi, (n_prims, 3)).astype(np.float32)
    t[:, 0:3] = v0
    tri = slice(0, n_tri)
    t[tri, 3:6] = rng.normal(0, 0.15, (n_tri, 3))      # e1
    t[tri, 6:9] = rng.normal(0, 0.15, (n_tri, 3))      # e2
    t[tri, 9] = int(GeometryType.TRIANGLE)
    sph = slice(n_tri, n_tri + n_sph)
    t[sph, 9] = int(GeometryType.SPHERE)
    t[sph, 10] = rng.uniform(0.01, 0.08, n_sph)
    lin = slice(n_tri + n_sph, n_prims)
    t[lin, 3:6] = v0[lin] + rng.normal(0, 0.2, (n_prims - n_tri - n_sph, 3))
    t[lin, 9] = int(GeometryType.LINE)
    t[lin, 10] = rng.uniform(0.005, 0.02, n_prims - n_tri - n_sph)
    t[lin, 11] = rng.uniform(0.002, 0.01, n_prims - n_tri - n_sph)
    t[:, 12] = np.arange(n_prims)
    return t


def random_rays(rng, n, dev):
    """n rays with origins inside the room and uniform directions."""
    ro = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n, 3))
    rd = rng.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.5, np.inf, rng.uniform(0.1, 2.0, n))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return (f(ro).contiguous(), f(rd).contiguous(),
            torch.full((n,), 1e-3, device=dev), f(tmax))


def phase_b(dev, rng, records):
    """K1 vs its plain version at 1,048,576 rays, closest and any hit:
    both variants on cornell_port's table, the all-kinds one on the
    512-row synthetic table, a table of exact twins (the cornell table
    twice), lanes with empty intervals, an N that is not a multiple of
    the kernel's 256 rays a block."""
    from gpu_pathtracer_tpu_torch.geom import dense, dense_cuda
    from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    scene, _ = flatten_scene(load_scene(os.path.join(REPO, SCENES[0])), dev)
    cornell = scene.dense_prims
    synth = torch.as_tensor(synthetic_table(rng), device=dev)
    tri, every = (True, False, False), (True, True, True)
    n = N_RAYS
    ro, rd, tmin, tmax = random_rays(rng, n, dev)
    tmax_e, empty = with_empty(rng, tmax)
    n_odd = n - 37
    twins = torch.cat([cornell, cornell]).contiguous()
    cases = (   # label, table, kinds, rays, tie canon, empty mask
        ("cornell_port, triangles only", cornell, tri, (ro, rd, tmin, tmax),
         None, None),
        ("cornell_port, all kinds", cornell, every, (ro, rd, tmin, tmax),
         None, None),
        ("synthetic512, all kinds", synth, every, (ro, rd, tmin, tmax), None,
         None),
        ("cornell_port twice (exact ties), triangles only", twins, tri,
         (ro, rd, tmin, tmax), twins[:, 12], None),
        ("cornell_port, 30% empty intervals, triangles only", cornell, tri,
         (ro, rd, tmin, tmax_e), None, empty),
        ("synthetic512, 30% empty intervals, all kinds", synth, every,
         (ro, rd, tmin, tmax_e), None, empty),
        (f"cornell_port, N = {n_odd}, triangles only", cornell, tri,
         tuple(x[:n_odd] for x in (ro, rd, tmin, tmax)), None, None),
        (f"synthetic512, N = {n_odd}, all kinds", synth, every,
         tuple(x[:n_odd] for x in (ro, rd, tmin, tmax)), None, None))
    max_err = 0.0
    for label, table, kinds, (o, d, t0, t1), canon, emp in cases:
        ck = dense_cuda.dense_hit_cuda(table, o, d, t0, t1, False, kinds)
        ak = dense_cuda.dense_hit_cuda(table, o, d, t0, t1, True, kinds)
        cp = dense.dense_closest_torch(table, o, d, t0, t1, kinds)
        ap = dense.dense_any_torch(table, o, d, t0, t1, kinds)
        torch.cuda.synchronize()
        max_err = max(max_err, hit_check(f"K1 {label}", ck, cp, ak, ap,
                                         canon, emp))
    records["dense_hit"]["max_abs_err"] = max_err
    phase_b_large(dev, rng, records)
    phase_b_media(dev, rng, records)


def k3_pair(scene, static):
    """(kernel, plain) of K3 on a flattened scene: f(ro, rd, tmin, tmax,
    any_hit)."""
    from gpu_pathtracer_tpu_torch.geom import blocked, blocked_cuda, dense
    kinds = dense.kinds_of(static)
    return (lambda *a: blocked_cuda.blocked_hit_cuda(
                scene.dense_prims, scene.block_bbox, scene.block_sub, *a,
                kinds),
            lambda *a: blocked.blocked_hit_torch(
                scene.dense_prims, scene.block_bbox, *a, kinds))


def k4_pair(scene, static, kinds=None):
    """(kernel, plain) of K4 on a flattened scene (flat or instanced), the
    kernel's variant chosen from `kinds` (default: the scene's own)."""
    from gpu_pathtracer_tpu_torch.geom import dense
    kinds = dense.kinds_of(static) if kinds is None else kinds
    return k4_table_pair(scene.bvh8_table, scene.bvh8_aux,
                         static.bvh8_n_inst, static.bvh8_stack, kinds)


def k4_table_pair(table, aux, n_inst, stack, kinds):
    """(kernel, plain) of K4 on a BVH8 table: f(ro, rd, tmin, tmax,
    any_hit)."""
    from gpu_pathtracer_tpu_torch.geom import packet, packet_cuda
    args = (table, aux, n_inst)
    return (lambda ro, rd, t0, t1, any_hit: packet_cuda.bvh8_walk_cuda(
                *args, ro, rd, t0, t1, any_hit, stack, kinds),
            lambda ro, rd, t0, t1, any_hit: packet.walk_torch(
                *args, ro, rd, t0, t1, any_hit, kinds, stack))


def variant_name(static) -> str:
    """K2's template variant for a scene: sky, textures, all prim kinds."""
    from gpu_pathtracer_tpu_torch.integrators import pt_fused
    return (f"(env {int(static.has_infinite)}, tex "
            f"{int(static.has_textures)}, all kinds "
            f"{int(pt_fused.all_kinds(static))})")


def tree_twice(table):
    """A flat BVH8 table twice over under a new root row: slot 0 holds the
    tree, slot 1 its copy (rows shifted, the copy's prim ids + P), both
    with the tree's box, so every hit is an exact tie across leaves of
    two subtrees and the plain walk, visiting the copy last, takes the
    copy's record (tests/test_torch_bvh8_walk.py::tree_twice). Returns
    (table, prim count P)."""
    rows = table.shape[0]
    nodes = table[:, :64].reshape(rows, 8, 8)
    meta = nodes[..., 6]
    is_leaf = torch.ones(rows, dtype=torch.bool, device=table.device)
    frontier = torch.zeros(1, dtype=torch.long, device=table.device)
    while frontier.numel():   # the node rows, a level at a time from row 0
        is_leaf[frontier] = False
        m = meta[frontier]
        frontier = m[m > 0].long().unique()
    valid = (table.view(rows, 8, 16)[..., 13] > 0) & is_leaf[:, None]
    n_prims = int(table.view(rows, 8, 16)[..., 12][valid].max()) + 1
    root = nodes[0]
    have = root[:, 6] != 0
    box = torch.cat([root[have, 0:3].amin(0), root[have, 3:6].amax(0)])
    out = torch.zeros((1 + 2 * rows, 128), device=table.device)
    out[0, :64].view(8, 8)[:, 0:3] = torch.inf
    out[0, :64].view(8, 8)[:, 3:6] = -torch.inf
    for k, shift in enumerate((1, 1 + rows)):
        part = table.clone()
        meta = part[:, :64].view(rows, 8, 8)[..., 6]
        node_rows = ~is_leaf[:, None]
        meta.copy_(torch.where(node_rows & (meta > 0), meta + shift,
                               torch.where(node_rows & (meta < 0),
                                           meta - shift, meta)))
        rec = part.view(rows, 8, 16)
        ids = rec[..., 12]
        ids.copy_(torch.where(is_leaf[:, None] & (rec[..., 13] > 0),
                              ids + k * n_prims, ids))
        out[shift:shift + rows] = part
        out[0, 8 * k:8 * k + 6] = box
        out[0, 8 * k + 6] = shift
    return out.contiguous(), n_prims


def bvh8_of_rows(rows):
    """A flat BVH8 table of dense_prims rows of any kinds through the
    port's builders (the native SAH BVH, then bvh8.build_bvh8), as
    flatten builds one: each row's box (a triangle's corners, a sphere's
    centre +- r, a segment's ends +- its larger width) -> (table, aux,
    stack bound)."""
    from gpu_pathtracer_tpu_torch.geom import bvh, bvh8
    ty, v0 = rows[:, 9:10], rows[:, 0:3]
    a, b = rows[:, 3:6], rows[:, 6:9]
    r = rows[:, 10:12].amax(1, keepdim=True)
    tri, sph = ty == 0, ty == 2
    lo = torch.where(tri, torch.minimum(v0, torch.minimum(v0 + a, v0 + b)),
                     torch.where(sph, v0 - r, torch.minimum(v0, a) - r))
    hi = torch.where(tri, torch.maximum(v0, torch.maximum(v0 + a, v0 + b)),
                     torch.where(sph, v0 + r, torch.maximum(v0, a) + r))
    tree = bvh.load_or_build_bvh(lo.cpu().numpy(), hi.cpu().numpy(),
                                 cache=False)
    recs = rows.cpu().numpy()[tree.prim_order]
    table, _ = bvh8.build_bvh8(tree, recs)
    aux = np.zeros((1, 20), np.float32)
    dev = rows.device
    return (torch.as_tensor(table, device=dev), torch.as_tensor(aux,
                                                                device=dev),
            bvh8.stack_bound(table, aux, 0))


RAYS = {}   # knot scene key -> its ray sets (phases B and E)


def knot_rays(key, dev, rng) -> dict:
    """The ray sets of knot scene `key`, made once per run."""
    if key not in RAYS:
        RAYS[key] = ray_sets(*flat(key, dev), rng, dev)
    return RAYS[key]


def phase_b_large(dev, rng, records):
    """K3 and K4 vs their plain versions on 1M rays of each set, K3 vs K4
    on blocked.json, and K4's stack-overflow flag."""
    from gpu_pathtracer_tpu_torch.geom import packet_cuda, traverse
    errs = {"blocked": 0.0, "bvh8_walk": 0.0}
    for key, (kname, pair) in (("blocked", ("K3", k3_pair)),
                               ("scene", ("K4 flat", k4_pair)),
                               ("forest", ("K4 instanced", k4_pair))):
        scene, static = flat(key, dev)
        want = {"blocked": "blocked", "scene": "bvh8",
                "forest": "instanced"}[key]
        check(traverse.regime(static) == want,
              f"{key}: regime {traverse.regime(static)}, want {want}")
        print(f"[B] {KNOT[key]}: {static.n_primitives} prims, BVH8 "
              f"{static.bvh8_rows} rows ({static.bvh8_n8} node rows), "
              f"{static.bvh8_n_inst} instances, stack {static.bvh8_stack}, "
              f"host build {_FLAT[os.path.join(REPO, KNOT[key])][2]:.2f} s")
        kern, plain = pair(scene, static)
        rec = "blocked" if kname == "K3" else "bvh8_walk"
        for set_name, (ro, rd, t0, t1, t_any) in knot_rays(key, dev,
                                                          rng).items():
            ck = kern(ro, rd, t0, t1, False)
            ak = kern(ro, rd, t0, t_any, True)
            cp = plain(ro, rd, t0, t1, False)
            ap = plain(ro, rd, t0, t_any, True)
            torch.cuda.synchronize()
            errs[rec] = max(errs[rec], hit_check(
                f"{kname} {key} {set_name}", ck, cp, ak, ap))
    errs["blocked"] = max(errs["blocked"], phase_b_k3(dev, rng, records))
    errs["bvh8_walk"] = max(errs["bvh8_walk"], phase_b_k4(dev, rng))
    for rec, e in errs.items():
        records[rec]["max_abs_err"] = e

    # K3 against K4 on the same 16k-prim scene
    scene, static = flat("blocked", dev)
    k3, _ = k3_pair(scene, static)
    k4, _ = k4_pair(scene, static)
    for set_name, (ro, rd, t0, t1, _) in knot_rays("blocked", dev,
                                                   rng).items():
        (t3, p3), (t4, p4) = k3(ro, rd, t0, t1, False), k4(ro, rd, t0, t1,
                                                           False)
        # K3 is held to the plain version within the hit limits, not bit
        # for bit: t is compared where the two take the same prim
        both = (p3 == p4) & (p4 >= 0)
        rel = ((t3 - t4).abs() / t4.abs().clamp_min(1e-30))[both]
        found = ((p3 >= 0) == (p4 >= 0)).float().mean().item()
        same = (p3 == p4).float().mean().item()
        rel_max = rel.max().item() if rel.numel() else 0.0
        print(f"[B] K3 vs K4 blocked {set_name}: found equal {found:.6f}, "
              f"prim equal {same:.6f}, t max rel err {rel_max:.3e}")
        check(found >= 0.9999, f"K3 vs K4 {set_name}: found equal {found}")
        check(same >= 0.9999, f"K3 vs K4 {set_name}: prim equal {same}")
        check(rel_max <= 1e-4, f"K3 vs K4 {set_name}: t rel err {rel_max}")

    # no walk so far overflowed; a stack too small for the tree must
    # raise at the next check, never drop a ray
    packet_cuda.check_overflow()
    scene, static = flat("scene", dev)
    ro, rd, t0, t1, _ = knot_rays("scene", dev, rng)["primary"]
    packet_cuda.bvh8_walk_cuda(scene.bvh8_table, scene.bvh8_aux, 0, ro, rd,
                               t0, t1, False, 2, (True, False, False))
    try:
        packet_cuda.check_overflow()
    except RuntimeError as e:
        check("2 entries" in str(e), f"K4 overflow: {e}")
        print(f"[B] K4 with a 2-entry stack raises at the check: {e}")
    else:
        fail("K4 with a 2-entry stack did not report an overflow")
    packet_cuda.check_overflow()   # the check cleared the flag


def phase_b_k3(dev, rng, records) -> float:
    """K3's cases beyond the three ray sets, each vs the plain version:
    the all-kinds variant on blocked.json, its table twice over (every
    hit an exact tie across blocks), 30% empty intervals, an N that is
    not a multiple of the kernel's 128 rays a block, cornell_port's table
    twice over and the 512-row synthetic table of all kinds cut into
    blocks; then the blocks a ray enters on the primary and bounce sets.
    Returns the largest |t| error."""
    from gpu_pathtracer_tpu_torch.geom import blocked, blocked_cuda
    scene, _ = flat("blocked", dev)
    sets = knot_rays("blocked", dev, rng)
    tri, every = (True, False, False), (True, True, True)
    table, bbox = scene.dense_prims, scene.block_bbox
    t2, b2 = doubled(table, bbox)
    n_odd = N_RAYS - 37
    prim, bounce = sets["primary"][:4], sets["bounce"][:4]
    ro, rd, t0, t1, _ = sets["random"]
    tmax_e, empty = with_empty(rng, t1)
    room = random_rays(rng, N_RAYS, dev)
    c2, cb2 = doubled(*blocked_table(flat(SCENES[0], dev)[0].dense_prims))
    s8, sb8 = blocked_table(torch.as_tensor(synthetic_table(rng),
                                            device=dev))
    cases = (   # label, table, bbox, kinds, rays, tie canon, empty mask
        ("primary, all kinds", table, bbox, every, prim, None, None),
        ("twice (exact ties), primary", t2, b2, tri, prim, t2[:, 12], None),
        ("twice (exact ties), bounce", t2, b2, tri, bounce, t2[:, 12], None),
        ("random, 30% empty intervals", table, bbox, tri,
         (ro, rd, t0, tmax_e), None, empty),
        (f"primary, N = {n_odd}", table, bbox, tri,
         tuple(x[:n_odd] for x in prim), None, None),
        ("cornell_port's table twice as 2 x 1 blocks (exact ties)", c2, cb2,
         tri, room, c2[:, 12], None),
        ("synthetic512 as 8 blocks, all kinds", s8, sb8, every, room, None,
         None))
    err = 0.0
    for label, tab, bb, kinds, (o, d, lo, hi), canon, emp in cases:
        sub = blocked_cuda.sub_boxes(tab, bb.shape[0])
        ck = blocked_cuda.blocked_hit_cuda(tab, bb, sub, o, d, lo, hi, False,
                                           kinds)
        ak = blocked_cuda.blocked_hit_cuda(tab, bb, sub, o, d, lo, hi, True,
                                           kinds)
        cp = blocked.blocked_hit_torch(tab, bb, o, d, lo, hi, False, kinds)
        ap = blocked.blocked_hit_torch(tab, bb, o, d, lo, hi, True, kinds)
        torch.cuda.synchronize()
        err = max(err, hit_check(f"K3 blocked.json {label}"
                                 if tab is table or tab is t2 else
                                 f"K3 {label}", ck, cp, ak, ap, canon, emp))
    for set_name in ("primary", "bounce"):
        o, d, lo, hi = sets[set_name][:4]
        ent = k3_entries(scene, o, d, lo, hi, tri)
        coh = warp_coherence(bbox, o, d, lo, ent["t"])
        print(f"[B] K3 blocks entered per ray, blocked.json 1M {set_name} "
              f"rays: {entry_line(ent)}; {coherence_line(coh)}")
        records["blocked"][f"entered_{set_name}"] = entry_summary(ent)
        records["blocked"][f"warps_{set_name}"] = coh
    return err


def phase_b_k4(dev, rng) -> float:
    """K4's cases beyond the three ray sets, each vs the plain version:
    on scene.json's table its all-kinds variant, 30% empty intervals, an N
    that is not a multiple of the kernel's 128 rays a block, and the tree
    twice over under a new root (tree_twice: every hit an exact tie
    across leaves of two subtrees); the forest (instanced) likewise; the
    512-row synthetic table of all three kinds through the port's BVH and
    BVH8 builders. Returns the largest |t| error."""
    tri, every = (True, False, False), (True, True, True)
    n_odd = N_RAYS - 37
    room = random_rays(rng, N_RAYS, dev)
    s_table, s_aux, s_stack = bvh8_of_rows(
        torch.as_tensor(synthetic_table(rng), device=dev))
    err = 0.0
    for key in ("scene", "forest"):
        scene, static = flat(key, dev)
        sets = knot_rays(key, dev, rng)
        prim, bounce = sets["primary"][:4], sets["bounce"][:4]
        ro, rd, t0, t1, _ = sets["random"]
        tmax_e, empty = with_empty(rng, t1)
        args = (scene.bvh8_table, scene.bvh8_aux, static.bvh8_n_inst,
                static.bvh8_stack)
        cases = [   # label, table args, kinds, rays, tie canon, empty mask
            ("primary, all-kinds variant", args, every, prim, None, None),
            ("random, 30% empty intervals", args, tri,
             (ro, rd, t0, tmax_e), None, empty),
            ("random, 30% empty intervals, all-kinds variant", args, every,
             (ro, rd, t0, tmax_e), None, empty),
            (f"primary, N = {n_odd}", args, tri,
             tuple(x[:n_odd] for x in prim), None, None)]
        if key == "scene":
            t2, n_prims = tree_twice(scene.bvh8_table)
            from gpu_pathtracer_tpu_torch.geom import bvh8
            stack2 = bvh8.stack_bound(t2.cpu().numpy(),
                                      scene.bvh8_aux.cpu().numpy(), 0)
            canon = torch.arange(2 * n_prims, device=dev) % n_prims
            for set_name, rays in (("primary", prim), ("bounce", bounce)):
                cases.append((f"tree twice (exact ties across leaves), "
                              f"{set_name}", (t2, scene.bvh8_aux, 0, stack2),
                              tri, rays, canon, None))
        for label, (tab, aux, n_inst, stack), kinds, (o, d, lo, hi), \
                canon, emp in cases:
            kern, plain = k4_table_pair(tab, aux, n_inst, stack, kinds)
            ck, ak = kern(o, d, lo, hi, False), kern(o, d, lo, hi, True)
            cp, ap = plain(o, d, lo, hi, False), plain(o, d, lo, hi, True)
            torch.cuda.synchronize()
            # K4 takes a record by its division-free fraction, the plain
            # walk by t: where the two disagree on which record is nearer
            # (within an ulp), they cull other rows and may resolve a tie
            # otherwise, so ties are held to the hit limits
            err = max(err, hit_check(f"K4 {key} {label}", ck, cp, ak, ap,
                                     canon, emp, exact_ties=False))
    kern, plain = k4_table_pair(s_table, s_aux, 0, s_stack, every)
    ro, rd, t0, t1 = room
    tmax_e, empty = with_empty(rng, t1)
    for label, hi, emp in (("", t1, None),
                           (", 30% empty intervals", tmax_e, empty)):
        ck, ak = kern(ro, rd, t0, hi, False), kern(ro, rd, t0, hi, True)
        cp, ap = plain(ro, rd, t0, hi, False), plain(ro, rd, t0, hi, True)
        torch.cuda.synchronize()
        err = max(err, hit_check(
            f"K4 synthetic512 as a BVH8 table ({s_table.shape[0]} rows), "
            f"all kinds{label}", ck, cp, ak, ap, None, emp))
    return err


def coherence_line(coh) -> str:
    return (f"a warp's visit step, nearest first: "
            f"{coh['distinct_blocks']:.3f} distinct blocks, all lanes in one "
            f"block {coh['one_block_share']:.4f} ({coh['warp_steps']} "
            f"warp steps)")


def k3_entries(scene, ro, rd, t_lo, t_hi, kinds) -> dict:
    """Blocks of scene.block_bbox a ray enters: "row order", in the
    plain version's loop (the parent kernel's order), with its running
    best t; "before the hit", the boxes that overlap [t_lo, the closest
    hit's t] (what a nearest-first visit needs); "whole ray", those that
    overlap [t_lo, t_hi]. {name: [N] counts}, plus the closest hit's
    t under "t"."""
    from gpu_pathtracer_tpu_torch.geom import blocked
    from gpu_pathtracer_tpu_torch.geom.dense import chunk_hits
    prims, bb = scene.dense_prims, scene.block_bbox
    n = ro.shape[0]
    best_t = t_hi.clone()
    count = torch.zeros(n, dtype=torch.int32, device=ro.device)
    inv = blocked.safe_inv(rd)
    for b in range(bb.shape[0]):   # blocked_hit_torch's loop, counted
        hit, _ = blocked.slab(bb[b, 0:3], bb[b, 3:6], ro, inv, best_t)
        count += hit.to(torch.int32)
        lanes = hit.nonzero().squeeze(1)
        if lanes.numel() == 0:
            continue
        rows = prims[b * blocked.BLOCK:(b + 1) * blocked.BLOCK]
        o, d = ro[lanes], rd[lanes]
        ok, t = chunk_hits(rows, tuple(o[:, k:k + 1] for k in range(3)),
                           tuple(d[:, k:k + 1] for k in range(3)),
                           t_lo[lanes, None], best_t[lanes, None], kinds)
        got, t_new, _ = blocked.last_min(ok, t)
        best_t[lanes] = torch.where(got, t_new, best_t[lanes])
    return {"row order": count,
            "before the hit": block_entries(bb, ro, rd, t_lo, best_t),
            "whole ray": block_entries(bb, ro, rd, t_lo, t_hi),
            "t": best_t}


CHUNK = 8192   # rays per step of the box counts below


def box_overlap(box, o, inv, t_lo, t_hi):
    """[rays, boxes]: whether the slab interval of each box of `box`
    ([m, >= 6]: min(3) max(3)) overlaps the ray's [t_lo, t_hi]; an empty
    box (min > max: a whole pad block's, or NaN) never does."""
    lo = (box[None, :, 0:3] - o[:, None]) * inv[:, None]
    hi = (box[None, :, 3:6] - o[:, None]) * inv[:, None]
    tn = torch.minimum(lo, hi).amax(-1).clamp_min(t_lo[:, None])
    tf = torch.minimum(torch.maximum(lo, hi).amin(-1), t_hi[:, None])
    real = (box[:, 0:3] <= box[:, 3:6]).all(-1)
    return (tn <= tf) & real


def block_entries(bb, ro, rd, t_lo, t_best):
    """Per ray, the boxes of bb (not the empty boxes of whole pad blocks)
    whose slab interval overlaps [t_lo, t_best]."""
    from gpu_pathtracer_tpu_torch.geom.blocked import safe_inv
    inv = safe_inv(rd)
    return torch.cat([
        box_overlap(bb, ro[c:c + CHUNK], inv[c:c + CHUNK],
                    t_lo[c:c + CHUNK], t_best[c:c + CHUNK])
        .sum(1, dtype=torch.int32) for c in range(0, ro.shape[0], CHUNK)])


def k3_work(scene, ro, rd, t_lo, t_best) -> dict:
    """The least work of K3's design (csrc/blocked.cu) on these rays,
    given each one's closest hit t_best (t_hi on a miss): the slab tests
    of every coarse box (one per blocked_cuda.GROUP blocks), of the
    blocks of each coarse box whose box overlaps [t_lo, t_best], of the
    sub-boxes (scene.block_sub) of each such block, and one test of each
    prim row of each such sub-box that overlaps it, by the row's type.
    Totals over the rays: {"coarse", "fine", "sub", "rows", "row_flops"}."""
    from gpu_pathtracer_tpu_torch.geom.blocked import safe_inv
    from gpu_pathtracer_tpu_torch.geom.blocked_cuda import BLOCK, GROUP, SUB
    bb, sub, prims = scene.block_bbox, scene.block_sub, scene.dense_prims
    nb, per, dev = bb.shape[0], BLOCK // SUB, bb.device
    pad = torch.full(((-nb) % GROUP, 3), torch.inf, device=dev)
    coarse = torch.cat([torch.cat([bb[:, 0:3], pad]).view(-1, GROUP, 3)
                        .amin(1),
                        torch.cat([bb[:, 3:6], -pad]).view(-1, GROUP, 3)
                        .amax(1)], 1)
    group_of = torch.arange(nb, device=dev) // GROUP
    children = torch.bincount(group_of)          # blocks per coarse box
    ty = torch.cat([prims[:, 9], torch.full(
        (nb * BLOCK - prims.shape[0],), -1.0, device=dev)])
    sub_rows = (ty >= 0).view(-1, SUB).sum(1)     # prim rows per sub-box
    sub_flops = type_flops(ty).view(-1, SUB).sum(1)
    inv = safe_inv(rd)
    out = dict.fromkeys(("coarse", "fine", "sub", "rows", "row_flops"), 0)
    for c in range(0, ro.shape[0], CHUNK):
        o, iv = ro[c:c + CHUNK], inv[c:c + CHUNK]
        a, z = t_lo[c:c + CHUNK], t_best[c:c + CHUNK]
        ent_c = box_overlap(coarse, o, iv, a, z)
        ent_b = box_overlap(bb, o, iv, a, z) & ent_c[:, group_of]
        ent_s = box_overlap(sub, o, iv, a, z) \
            & ent_b.repeat_interleave(per, 1)
        out["coarse"] += o.shape[0] * coarse.shape[0]
        out["fine"] += int((ent_c * children).sum())
        out["sub"] += per * int(ent_b.sum())
        out["rows"] += int((ent_s * sub_rows).sum())
        out["row_flops"] += int((ent_s * sub_flops).sum())
    return out


XFORM_FLOPS = 39   # mapping a ray into an instance's frame: 3x4 by the
                   # origin and 3x3 by the direction, 3 inverses


def k4_work(table, aux, n_inst, ro, rd, t_lo, t_best) -> dict:
    """The least work of any correct walk of this BVH8 table on these
    rays, given each one's closest hit t_best (or the hit an any-hit walk
    stops at; t_hi on a miss): open every node row whose box the ray
    enters at tn <= t_best (the root always) and slab-test that row's
    valid children; test the valid records of every leaf row it enters
    at tn <= t_best, each by its type. Instanced (n_inst > 0): the
    instances' world boxes are slab-tested, and each instance entered at
    tn <= t_best is mapped into its frame and walked the same way from
    its root row. Totals over the rays: {"inst", "inst_entered", "nodes",
    "slabs", "leaves", "records", "record_flops"}."""
    from gpu_pathtracer_tpu_torch.geom.blocked import safe_inv, slab
    from gpu_pathtracer_tpu_torch.geom.packet import _xform
    out = dict.fromkeys(("inst", "inst_entered", "nodes", "slabs", "leaves",
                         "records", "record_flops"), 0)
    for c in range(0, ro.shape[0], CHUNK):
        o, d = ro[c:c + CHUNK], rd[c:c + CHUNK]
        best = t_best[c:c + CHUNK]
        if n_inst == 0:
            tree_work(table, o, d, best,
                      torch.zeros(o.shape[0], dtype=torch.long,
                                  device=o.device), out)
            continue
        box = aux[:n_inst]
        ent, _ = slab(box[:, 14:17], box[:, 17:20], o[:, None],
                      safe_inv(d)[:, None], best[:, None])
        out["inst"] += o.shape[0] * n_inst
        lanes, k = ent.nonzero(as_tuple=True)
        out["inst_entered"] += lanes.numel()
        m = box[k]
        tree_work(table, _xform(m, o[lanes], True),
                  _xform(m, d[lanes], False), best[lanes],
                  m[:, 12].long(), out)
    return out


def tree_work(table, o, d, best, roots, out) -> None:
    """k4_work's count below node rows `roots`, one root per ray (its ray
    in the tree's frame), added into `out`: a level at a time, every
    (ray, node row) pair opened."""
    from gpu_pathtracer_tpu_torch.geom.blocked import safe_inv, slab
    inv = safe_inv(d)
    ray = torch.arange(o.shape[0], device=o.device)
    row = roots
    while ray.numel():
        out["nodes"] += ray.numel()
        slots = table[row, :64].view(-1, 8, 8)
        meta = slots[..., 6]
        valid = meta != 0
        out["slabs"] += int(valid.sum())
        ent, _ = slab(slots[..., 0:3], slots[..., 3:6], o[ray, None],
                      inv[ray, None], best[ray, None])
        ent = ent & valid
        leaf = ent & (meta < 0)
        recs = table[(-meta[leaf]).long()].view(-1, 8, 16)
        live = recs[..., 13] > 0
        out["leaves"] += recs.shape[0]
        out["records"] += int(live.sum())
        out["record_flops"] += int((type_flops(recs[..., 9]) * live).sum())
        node = ent & (meta > 0)
        ray = ray[:, None].expand(-1, 8)[node]
        row = meta[node].long()


def walk_visits(table, ro, rd, t_lo, t_hi, kinds, stack) -> dict:
    """The rows the plain walk (geom/packet.py::walk_torch, flat) visits
    per ray, in its order (the kernel's, which culls alike): node rows
    opened and leaf rows tested, counted lane by lane in lock step, and
    per 32-lane warp the most any lane visits (a warp runs as long as
    its longest walk). {"nodes", "leaves", "warp_max"}: [mean, p99]."""
    from gpu_pathtracer_tpu_torch.geom.blocked import last_min, safe_inv, slab
    from gpu_pathtracer_tpu_torch.geom.dense import rec_hits
    n, dev = ro.shape[0], ro.device
    inv = safe_inv(rd)
    live = t_hi >= t_lo
    nodes = torch.zeros(n, dtype=torch.int64, device=dev)
    leaves = torch.zeros_like(nodes)
    stack = torch.zeros((n, stack + 1), dtype=torch.int64, device=dev)
    sp = live.long()
    bt = t_hi.clone()
    while True:
        act = (sp > 0).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        e = stack[act, sp[act]]
        node = e >= 0
        a = act[node]
        if a.numel():
            nodes[a] += 1
            rows = table[e[node], :64].view(-1, 8, 8)
            hit, tn = slab(rows[..., 0:3], rows[..., 3:6], ro[a, None],
                           inv[a, None], bt[a, None])
            hit = hit & (rows[..., 6] != 0)
            order = torch.sort(torch.where(hit, tn, torch.inf), dim=1,
                               stable=True).indices
            nh = hit.sum(1)
            meta = rows[..., 6].gather(1, order).long()
            for r in range(8):   # the nearest lands on top
                sel = nh > r
                stack[a[sel], sp[a[sel]] + nh[sel] - 1 - r] = meta[sel, r]
            sp[a] += nh
        a = act[~node]
        if a.numel():
            leaves[a] += 1
            rec = table[-e[~node]].view(-1, 8, 16)
            ok, t = rec_hits([rec[..., c] for c in range(12)],
                             tuple(ro[a, k:k + 1] for k in range(3)),
                             tuple(rd[a, k:k + 1] for k in range(3)),
                             t_lo[a, None], bt[a, None], kinds)
            got, t_new, _ = last_min(ok & (rec[..., 13] > 0), t)
            bt[a] = torch.where(got, t_new, bt[a])
    steps = nodes + leaves
    warp = torch.cat([steps, steps.new_zeros((-n) % 32)]).view(-1, 32) \
        .amax(1)
    q = lambda x: [x.float().mean().item(),  # noqa: E731
                   x.float().quantile(0.99).item()]
    return {"nodes": q(nodes[live]), "leaves": q(leaves[live]),
            "warp_max": q(warp)}


def visits_line(v) -> str:
    return (f"the plain walk visits {v['nodes'][0]:.3f} node rows (p99 "
            f"{v['nodes'][1]:.0f}) and {v['leaves'][0]:.3f} leaf rows (p99 "
            f"{v['leaves'][1]:.0f}) a live ray; a warp's longest lane "
            f"{v['warp_max'][0]:.3f} rows (p99 {v['warp_max'][1]:.0f})")


def k4_bound(table, aux, n_inst, ro, rd, t_lo, t_hi, t_best,
             any_hit=False) -> dict:
    """K4's bound on these rays: a live ray (t_lo <= t_hi) reads its 32 B
    and writes its hit (8 B, 1 B for any hit), a ray with an empty
    interval reads its 8 B of interval and writes the same, the table
    and the instance rows are read once; the operations are k4_work's
    given t_best (the plain walk's), under "work" per live ray."""
    live = t_hi >= t_lo
    nl, n = int(live.sum()), ro.shape[0]
    w = k4_work(table, aux, n_inst, ro[live], rd[live], t_lo[live],
                t_best[live])
    out_b = 1 if any_hit else 8
    b = bound(nl * (32 + out_b) + (n - nl) * (8 + out_b)
              + table.numel() * 4 + n_inst * 80,
              SLAB_FLOPS * (w["inst"] + w["slabs"])
              + XFORM_FLOPS * w["inst_entered"] + w["record_flops"])
    per = {k: v / max(nl, 1) for k, v in w.items()}
    b["work"] = ((f"a live ray: {per['inst']:.3f} instance box tests, "
                  f"{per['inst_entered']:.3f} instances entered, "
                  if n_inst else "a live ray: ")
                 + f"{per['nodes']:.3f} node rows ({per['slabs']:.3f} slab "
                 f"tests), {per['leaves']:.3f} leaf rows ({per['records']:.3f}"
                 f" records, {per['record_flops']:.1f} flops)")
    b["per_ray"] = per
    return b


def warp_coherence(bb, ro, rd, t_lo, t_best, k_max=16) -> dict:
    """How far the lanes of a 32-lane warp share blocks when each visits
    the blocks it enters before its hit nearest first (its first k_max):
    over the (warp, visit step) pairs with a lane visiting, the mean count
    of distinct blocks and the share where all visiting lanes are in one
    block."""
    from gpu_pathtracer_tpu_torch.geom.blocked import safe_inv
    n = ro.shape[0] // 32 * 32
    real = (bb[:, 0:3] <= bb[:, 3:6]).all(-1)
    distinct, steps = 0.0, 0
    one = 0
    for c0 in range(0, n, 1 << 16):
        o, d = ro[c0:c0 + (1 << 16)], rd[c0:c0 + (1 << 16)]
        lo_t, hi_t = t_lo[c0:c0 + (1 << 16)], t_best[c0:c0 + (1 << 16)]
        inv = safe_inv(d)
        lo = (bb[None, :, 0:3] - o[:, None]) * inv[:, None]
        hi = (bb[None, :, 3:6] - o[:, None]) * inv[:, None]
        tn = torch.minimum(lo, hi).amax(-1).clamp_min(lo_t[:, None])
        tf = torch.minimum(torch.maximum(lo, hi).amin(-1), hi_t[:, None])
        key = torch.where((tn <= tf) & real, tn, torch.inf)
        tn_s, order = torch.sort(key, dim=1)
        k = min(k_max, bb.shape[0])
        blk = torch.where(torch.isfinite(tn_s[:, :k]), order[:, :k], -1)
        s_, _ = blk.view(-1, 32, k).sort(dim=1)
        new = (s_ >= 0) & torch.cat(
            [torch.ones_like(s_[:, :1], dtype=torch.bool),
             s_[:, 1:] != s_[:, :-1]], 1)
        cnt = new.sum(1)   # [warps, k] distinct blocks per visit step
        act = cnt > 0
        distinct += float(cnt[act].sum())
        steps += int(act.sum())
        one += int((cnt == 1).sum())
    return {"distinct_blocks": distinct / max(steps, 1),
            "one_block_share": one / max(steps, 1), "warp_steps": steps}


def entry_summary(ent) -> dict:
    """{name: [mean, p99, max]} of k3_entries' counts."""
    out = {}
    for k, v in ent.items():
        if k != "t":
            f = v.float()
            out[k] = [f.mean().item(), f.quantile(0.99).item(),
                      int(v.max())]
    return out


def entry_line(ent) -> str:
    return "; ".join(f"{k} mean {m:.3f}, p99 {q:.0f}, max {x}"
                     for k, (m, q, x) in entry_summary(ent).items())


def phase_c(dev, rng, records):
    """K2 vs its plain version on the same uniforms, 65,536 lanes; the
    wavefront over K1 vs the same plain version. On many_lights.json the
    wavefront is reached through pt.render_lanes' routing, and K1's
    launches in that call are recorded apart from the main path's."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        close_frac, kernel_stats, reset_counts)
    from gpu_pathtracer_tpu_torch.core.rng import (
        PSS_BOUNCE_DIMS, PSS_CAM_DIMS,
    )
    from gpu_pathtracer_tpu_torch.geom import dense_cuda
    from gpu_pathtracer_tpu_torch.integrators import pt, pt_fused, pt_shade
    from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene

    max_err = 0.0
    dark = zero_power_sky_scene()
    for path in (*SCENES, *K2_VARIANTS.values(), dark, MANY_LIGHTS):
        scene, static = flatten_scene(load_scene(os.path.join(REPO, path)),
                                      dev)
        fused = path != MANY_LIGHTS
        check(pt_fused.supports(static) == fused, f"{path}: routing")
        check(static.max_depth == 5, f"{path}: depth {static.max_depth}")
        if path == dark:
            check(static.n_lights == 0 and scene.light_cdf.tolist()
                  == [0.0, 0.0, 1.0], f"{path}: light CDF "
                  f"{scene.light_cdf.tolist()}, {static.n_lights} lights")
        n_pix = static.width * static.height
        ids = torch.arange(0, n_pix, n_pix // 65536, device=dev,
                           dtype=torch.int32)[:65536]
        px, py = ids % static.width, ids // static.width
        d = PSS_CAM_DIMS + static.max_depth * PSS_BOUNCE_DIMS
        for mode in ("psample", "philox") if fused else ():
            ps = None
            if mode == "psample":
                ps = torch.as_tensor(rng.random((d, ids.numel()),
                                                dtype=np.float32), device=dev)
            li_k, r_k = pt_fused.render_lanes(scene, static, SEED, 1, px, py,
                                              True, ps)
            li_p, r_p = pt_fused.render_lanes_torch(scene, static, SEED, 1,
                                                    px, py, True, ps)
            torch.cuda.synchronize()
            frac = close_frac(li_k, li_p)
            exact = (li_k == li_p).all(1).float().mean().item()
            m_k, m_p = li_k.double().mean().item(), li_p.double().mean().item()
            ratio = m_k / m_p
            max_err = max(max_err, (li_k - li_p).abs().max().item())
            print(f"[C] K2 {os.path.basename(path)} {mode}: "
                  f"{ids.numel()} lanes, agree {frac:.6f} (differ "
                  f"{1 - frac:.6f}, bit-equal {exact:.6f}), mean ratio "
                  f"{ratio:.7f}, rays {int(r_k)} vs {int(r_p)}")
            check(frac >= 0.99, f"K2 {path} {mode}: agree on {frac}")
            check(abs(ratio - 1.0) <= 1e-3, f"K2 {path} {mode}: mean ratio "
                  f"{ratio}")
            check(bool(torch.isfinite(li_k).all()), "K2: non-finite li")
        # the other route of pt.render_lanes: the wavefront over K1
        reset_counts(dense_cuda.STATS, pt_fused.STATS, pt_shade.STATS)
        if fused:
            li_w = pt.wavefront(scene, static, SEED, 1, px, py)
        else:
            li_w = pt.render_lanes(scene, static, SEED, 1, px, py)
        torch.cuda.synchronize()
        k1_n, k2_n = dense_cuda.STATS.launches, pt_fused.STATS.launches
        shade_n = pt_shade.STATS.launches
        li_p = pt_fused.render_lanes_torch(scene, static, SEED, 1, px, py)
        frac = close_frac(li_w, li_p)
        ratio = li_w.double().mean().item() / li_p.double().mean().item()
        print(f"[C] wavefront over K1 {os.path.basename(path)} philox: "
              f"agree {frac:.6f}, bit-equal "
              f"{(li_w == li_p).all(1).float().mean().item():.6f}, mean "
              f"ratio {ratio:.7f}, K1 launches {k1_n}, pt_shade {shade_n}")
        # K1 is held to its plain version within the hit limits, so the
        # wavefront over it within the radiance limits, not bit for bit
        check(frac >= 0.99, f"wavefront {path}: agree on {frac}")
        check(abs(ratio - 1.0) <= 1e-3, f"wavefront {path}: ratio {ratio}")
        check(k1_n > 0 and shade_n > 0 and k2_n == 0, f"wavefront {path}: "
              f"launches K1 {k1_n}, pt_shade {shade_n}, K2 {k2_n}")
        if fused:
            # K2's inline bounce against pt_shade.cu's copies of its steps
            # (shade.cuh names them): the two kernels on the same sites
            hold_radiance(f"C K2 vs the wavefront over K1 and pt_shade "
                          f"{os.path.basename(path)} philox", "radiance",
                          li_k, li_w)
        if not fused:
            records["dense_hit"]["launches_wavefront_route"] = k1_n
    records["pt_fused"]["max_abs_err"] = max_err

    # the wavefront over K3 / K4 against the plain wavefront, from Philox
    # (lanes sorted for coherence) and from a primary-sample matrix
    # (unsorted); knot_port/sky.json adds textures and the sky
    stats = kernel_stats()
    for key, kname in (("blocked", "blocked"), ("scene", "bvh8_walk"),
                       ("forest", "bvh8_walk"), ("sky", "bvh8_walk")):
        scene, static = flat(key, dev)
        n_pix = static.width * static.height
        ids = torch.arange(0, n_pix, n_pix // 65536, device=dev,
                           dtype=torch.int32)[:65536]
        px, py = ids % static.width, ids // static.width
        d = PSS_CAM_DIMS + static.max_depth * PSS_BOUNCE_DIMS
        for mode in ("philox", "psample"):
            ps = None if mode == "philox" else torch.as_tensor(
                rng.random((d, ids.numel()), dtype=np.float32), device=dev)
            reset_counts(*stats.values())
            li_k, r_k = pt.render_lanes(scene, static, SEED, 1, px, py, True,
                                        ps)
            torch.cuda.synchronize()
            counts = {k: st.launches for k, st in stats.items()}
            li_p, r_p = pt.wavefront(scene, static, SEED, 1, px, py, True,
                                     ps, plain=True)
            frac = close_frac(li_k, li_p)
            ratio = li_k.double().mean().item() / li_p.double().mean().item()
            print(f"[C] wavefront over {kname} {os.path.basename(KNOT[key])}"
                  f" {mode}: {ids.numel()} lanes, agree {frac:.6f}, "
                  f"bit-equal "
                  f"{(li_k == li_p).all(1).float().mean().item():.6f}, mean "
                  f"ratio {ratio:.7f}, rays {int(r_k)} vs {int(r_p)}, "
                  f"launches {counts}")
            check(frac >= 0.99, f"wavefront {key} {mode}: agree on {frac}")
            check(abs(ratio - 1.0) <= 1e-3,
                  f"wavefront {key} {mode}: ratio {ratio}")
            check(bool(torch.isfinite(li_k).all()), f"{key}: non-finite li")
            check(only(counts, kname, "pt_shade",
                       *(("rng",) if mode == "philox" else ())),
                  f"wavefront {key} {mode}: launches {counts}")
    phase_c_media(dev, records, SMOKE)
    phase_c_media(dev, records, SMOKE_SKY)
    for integ, path in PROGRAMS_C:
        phase_c_program(dev, records, integ, path)
    for path, depth, kname in BDPT_C:
        phase_c_program(dev, records, "bdpt", path, depth=depth, kname=kname)
    phase_c_bdpt_tile(dev, records)
    phase_c_ir(dev, records)
    for integ, path in COUPLED_C:
        phase_c_coupled(dev, records, integ, path)
    from gpu_pathtracer_tpu_torch.geom import packet_cuda
    packet_cuda.check_overflow()   # no K4 walk of this phase overflowed

INT_OPS = 33.45e12   # instructions a second at the SMs' issue peak: 132 SMs
# x 128 lanes x 1.98 GHz (F32_FLOPS counts an FMA as 2 operations)
CAMERA_BLOCKS = 1    # counter blocks a lane of the camera draws
MLT_BLOCKS = 34      # of an MLT step at depth 5: 4 + 3 x 44 = 136 rows


def sass_instructions(so_path: str, kernel: str):
    """Instructions (NOPs aside) of `kernel` in library `so_path`, as
    cuobjdump -sass lists them; None without cuobjdump."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", so_path], capture_output=True,
                         text=True)
    if out.returncode:
        return None
    n, inside = 0, False
    for ln in out.stdout.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+[A-Z@]", ln) \
                and " NOP" not in ln:
            n += 1
    return n


def rng_bound(n: int, n_blocks: int, sass) -> dict:
    """csrc/rng.cu's least time on n lanes x n_blocks counter blocks: the
    lanes read (8 B each) and rows written (16 B a lane a block), or one
    thread's SASS instructions per (lane, block) at the issue peak."""
    tb = (8 * n + 16 * n * n_blocks) / HBM_BYTES_PER_S * 1e3
    to = (sass or 0) * n * n_blocks / INT_OPS * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def device_ops(fn) -> int:
    """The device operations (kernels, copies, sets) one call of fn()
    runs, counted in a torch.profiler trace (run/bench.py's categories)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from gpu_pathtracer_tpu_torch.run.bench import DEVICE_CATS
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("ph") == "X"
               and str(e.get("cat", "")).lower() in DEVICE_CATS)


@contextlib.contextmanager
def plain_draws():
    """Inside the block every Philox draw takes csrc/rng.cu's plain
    version; the path's other kernels launch as they do."""
    from gpu_pathtracer_tpu_torch.core import rng
    gate = rng.philox_uniform

    def plain(lanes, block0, n_blocks, tag, seed, iteration, plain=False):
        return gate(lanes, block0, n_blocks, tag, seed, iteration, True)

    rng.philox_uniform = plain
    try:
        yield
    finally:
        rng.philox_uniform = gate


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (index_add_'s sums in a fixed
    order) inside the block, so two runs can be held bit for bit."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def phase_r(dev, card, records):
    """csrc/rng.cu against its plain version bit for bit (MLT's shape,
    lanes up to 2**32 - 1, N not a multiple of the block, block0 > 0,
    tags 0-6, extreme keys, uniform_rows' row counts, a stream crossing
    blocks); one cornell spp through K2, one MLT step and one knot
    wavefront spp with the draws from the kernel and from the plain
    version, bit-equal; the kernel, the plain version and the bound in
    turns at the camera's and MLT's shapes."""
    import dataclasses
    from gpu_pathtracer_tpu_torch import kernels
    from gpu_pathtracer_tpu_torch.core import rng as trng
    from gpu_pathtracer_tpu_torch.core import rng_cuda
    from gpu_pathtracer_tpu_torch.integrators import mlt, pt, pt_fused
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    m32 = trng.MASK32
    n = N_RAYS
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ids = torch.arange(n, device=dev, dtype=torch.int64)
    high = torch.randint(0, 1 << 32, (n - 37,), device=dev, generator=gen)
    high[:4] = torch.tensor([0, 1 << 31, m32 - 1, m32], device=dev)
    cases = [("MLT's shape, 1,048,576 chains x 136 rows", ids, 0,
              MLT_BLOCKS, trng.MLT_TAG, (SEED, 1)),
             ("lanes up to 2**32 - 1, N = 1M - 37", high, 0, 2, 0, (SEED, 3)),
             ("block0 = 7", ids, 7, 3, trng.BSSRDF_TAG, (SEED, 1)),
             *((f"tag {t}", ids[:65536], 0, 2, t, (SEED, 2))
               for t in range(7)),
             ("key (0, 0)", high, 0, 1, 0, (0, 0)),
             ("key (2**32 - 1, 2**32 - 1)", high, 0, 1, 0, (m32, m32)),
             ("key (0, 2**32 - 1)", high, 1, 1, trng.MLT_TAG, (0, m32))]
    for label, lanes, b0, nb, tag, key in cases:
        a = rng_cuda.philox_uniform_cuda(lanes, b0, nb, tag, *key)
        b = trng.philox_uniform_torch(lanes, b0, nb, tag, *key)
        torch.cuda.synchronize()
        print(f"[R] rng {label}: [{a.shape[0]}, {a.shape[1]}] bit-equal "
              f"{torch.equal(a, b)}")
        check(torch.equal(a, b), f"rng {label}: differs from plain")
    for n_rows in (1, 7, 135, 136):
        a = trng.uniform_rows(SEED, 4, high, n_rows, trng.MLT_TAG)
        b = trng.uniform_rows(SEED, 4, high, n_rows, trng.MLT_TAG, plain=True)
        check(a.shape == (n_rows, high.shape[0]) and torch.equal(a, b),
              f"uniform_rows {n_rows} rows: {tuple(a.shape)}, differs")
    sk = trng.PhiloxStream(SEED, 5, high, base=2, tag=trng.BDPT_CONNECT_TAG)
    sp = trng.PhiloxStream(SEED, 5, high, base=2, tag=trng.BDPT_CONNECT_TAG,
                           plain=True)
    check(all(torch.equal(sk.uniform(), sp.uniform()) for _ in range(9)),
          "PhiloxStream across blocks differs from plain")
    print("[R] uniform_rows (1, 7, 135, 136 rows) and a PhiloxStream of 9 "
          "sites across 3 blocks bit-equal to plain")

    stats = rng_cuda.STATS
    films = []
    sc, st = flat_sized(SCENES[0], 1024, dev)
    px, py = ids % st.width, ids // st.width
    stats.launches = 0
    li_k = pt_fused.render_lanes(sc, st, SEED, 1, px, py)
    n_k = stats.launches
    with plain_draws():
        li_p = pt_fused.render_lanes(sc, st, SEED, 1, px, py)
    films.append(("cornell spp through K2, camera drawn by rng vs plain",
                  n_k, [(li_k, li_p)]))
    st_m = dataclasses.replace(st, integrator=IntegratorType.MLT,
                               max_depth=5)
    state = mlt.resample(st_m, mlt.candidates(sc, st_m, SEED, n))
    with deterministic():
        stats.launches = 0
        s_k, img_k = mlt.render_iteration(sc, st_m, SEED, 1, state)
        n_k = stats.launches
        with plain_draws():
            s_p, img_p = mlt.render_iteration(sc, st_m, SEED, 1, state)
    films.append(("MLT step of 1M chains, state and image", n_k,
                  [(s_k[k], s_p[k]) for k in s_k] + [(img_k, img_p)]))
    del state, s_k, s_p
    sc, st = flat("scene", dev)
    px, py = ids % st.width, ids // st.width
    with deterministic():
        stats.launches = 0
        li_k = pt.render_lanes(sc, st, SEED, 1, px, py)
        n_k = stats.launches
        with plain_draws():
            li_p = pt.render_lanes(sc, st, SEED, 1, px, py)
    films.append(("knot scene.json wavefront spp over K4", n_k,
                  [(li_k, li_p)]))
    torch.cuda.synchronize()
    for label, n_k, pairs in films:
        same = all(torch.equal(a, b) for a, b in pairs)
        print(f"[R] {label}: bit-equal {same}, rng launches {n_k}")
        check(same and n_k > 0, f"{label}: differs, or rng launched {n_k}")
    del films, li_k, li_p

    sass = sass_instructions(kernels.BUILDS["rng"].path,
                             "philox_uniform_kernel")
    print(f"[R] philox_uniform_kernel: {sass} SASS instructions a thread "
          "(one (lane, block) each), NOPs aside")
    out = {}
    for shape, nb, tag in (("camera", CAMERA_BLOCKS, 0),
                           ("mlt", MLT_BLOCKS, trng.MLT_TAG)):
        t = timed_windows({
            "kernel": lambda: rng_cuda.philox_uniform_cuda(ids, 0, nb, tag,
                                                           SEED, 1),
            "plain": lambda: trng.philox_uniform_torch(ids, 0, nb, tag,
                                                       SEED, 1)})
        ms = {k: sum(v) / len(v) for k, v in t.items()}
        ms["plain_ops"] = device_ops(
            lambda: trng.philox_uniform_torch(ids, 0, nb, tag, SEED, 1))
        b = rng_bound(n, nb, sass)
        print(f"[R] rng at {shape}'s shape, {n} lanes x {4 * nb} rows: "
              f"kernel {ms['kernel']:.4f} ms (windows "
              f"{min(t['kernel']):.4f}-{max(t['kernel']):.4f}), plain "
              f"{ms['plain']:.4f} ms in {ms['plain_ops']} device ops, bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({card})")
        out[shape] = (ms, b)
    (ms, b), (ms_m, b_m) = out["camera"], out["mlt"]
    records["rng"].update(
        max_abs_err=0.0, ms=ms["kernel"], plain_ms=ms["plain"], **b,
        library_ms=None, ms_mlt=ms_m["kernel"], plain_ms_mlt=ms_m["plain"],
        bound_ms_mlt=b_m["bound_ms"], bound_by_mlt=b_m["bound_by"],
        sass_instructions=sass, plain_ops=ms["plain_ops"],
        plain_ops_mlt=ms_m["plain_ops"])


# phase S's one-bounce cases, each at 1024^2: (label, scene, bounce,
# from an explicit psample: True, or "steps": one whose light-pick sites
# are the light CDF's entries); bounce 5 of a depth-5 scene is the
# epilogue.
# textured.json, env_port and materials.json render through K2 on the
# card, so their wavefront is reached through pt.wavefront directly
SHADE_CASES = (
    ("knot scene.json", KNOT["scene"], 0, False),
    ("knot scene.json", KNOT["scene"], 1, False),
    ("knot scene.json", KNOT["scene"], 5, False),
    ("knot scene.json, psample", KNOT["scene"], 1, True),
    ("knot sky.json (sky, textures)", KNOT["sky"], 1, False),
    ("many_lights.json (72 lights)", MANY_LIGHTS, 1, False),
    ("many_lights.json, light picks at the CDF's steps", MANY_LIGHTS, 1,
     "steps"),
    ("textured.json (textures)", K2_VARIANTS["textured"], 1, False),
    ("env_port scene.json (spheres, sky)", K2_VARIANTS["env"], 1, False),
    ("env_port mixed.json (all variant flags)", K2_VARIANTS["mixed"], 2,
     False),
    ("materials.json (lines, spheres, six models)", SCENES[1], 1, False),
    ("bssrdf.json (subsurface lanes)", BSSRDF, 0, False))
# and its films: one spp at 1024^2 depth 5 over the kernels vs all-plain
SHADE_FILMS = (KNOT["scene"], KNOT["forest"], MANY_LIGHTS, BSSRDF)
SHADE_FLOPS = 600   # float operations of one shaded lane (an estimate:
#                     hit record ~80, BSDF sample + eval ~300, light
#                     sample ~80, credits and keys ~140)


def scene_1024(path, dev):
    """The scene at repo path `path` flattened on `dev` at 1024^2."""
    sc, st = flat(path, dev)
    if st.width * st.height != N_RAYS:
        sc, st = flat_sized(path, 1024, dev)
    return sc, st


def bits(x):
    """x's bits: float32 viewed as int32 (so -0 differs from 0 and a NaN
    equals only its own bits), integers as they are."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def shade_states(dev, rng, path, bounces, psample=None):
    """The arguments of integrators/pt_shade.py::shade at each of
    `bounces` of one wavefront spp of the scene at `path`, 1024^2, lanes
    in pixel order, from Philox or from a random psample (its light-pick
    rows set to the light CDF's entries, below 1, lane by lane, when
    `psample` is "steps"): {bounce: dict by parameter name, the Wave a
    copy of the state before the call, without `plain`}. The spp runs
    over the kernels."""
    import inspect
    from gpu_pathtracer_tpu_torch.core.rng import (
        PSS_BOUNCE_DIMS, PSS_CAM_DIMS,
    )
    from gpu_pathtracer_tpu_torch.integrators import pt, pt_shade
    sc, st = scene_1024(path, dev)
    check(st.max_depth == 5, f"{path}: depth {st.max_depth}")
    ids = torch.arange(N_RAYS, device=dev)
    ps = None
    if psample:
        ps = torch.as_tensor(rng.random(
            (PSS_CAM_DIMS + st.max_depth * PSS_BOUNCE_DIMS, N_RAYS),
            dtype=np.float32), device=dev)
        if psample == "steps":
            steps = sc.light_cdf[sc.light_cdf < 1.0]
            ps[PSS_CAM_DIMS::PSS_BOUNCE_DIMS] = steps[ids % steps.numel()]
    got = {}
    shade = pt_shade.shade
    sig = inspect.signature(shade)

    def capture(*args, **kwargs):
        kw = sig.bind(*args, **kwargs)
        kw.apply_defaults()
        b = kw.arguments["b"]
        if b in bounces:
            got[b] = {k: wave_copy(v) if k == "w" else
                      v.clone() if torch.is_tensor(v) else v
                      for k, v in kw.arguments.items() if k != "plain"}
        return shade(*args, **kwargs)

    pt_shade.shade = capture
    try:
        pt.wavefront(sc, st, SEED, 1, ids % st.width, ids // st.width,
                     psample=ps)
    finally:
        pt_shade.shade = shade
    check(sorted(got) == sorted(bounces),
          f"{path}: shading steps {sorted(got)} of {bounces}")
    return got


def wave_copy(w):
    """A Wave with its tensors cloned."""
    import dataclasses
    return dataclasses.replace(w, **{
        f.name: getattr(w, f.name).clone() for f in dataclasses.fields(w)
        if torch.is_tensor(getattr(w, f.name))})


def wave_put(dst, src) -> None:
    """src's tensors copied into dst's, in place (the same pointers)."""
    import dataclasses
    for f in dataclasses.fields(src):
        x = getattr(src, f.name)
        if torch.is_tensor(x):
            getattr(dst, f.name).copy_(x)


def wave_differ(k, p, b) -> dict:
    """{field: words not bit-equal} of two Waves after bounce b; the list
    bounce b appended (its order is the kernel's) compared as a set."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(p):
        a, c = getattr(k, f.name), getattr(p, f.name)
        if not torch.is_tensor(c):
            continue
        check(a.shape == c.shape and a.dtype == c.dtype,
              f"{f.name}: {a.shape} {a.dtype} vs {c.shape} {c.dtype}")
        if f.name == "lists":
            r = (b + 1) % 2
            n = int(p.counts[b + 1, 1])
            out["list"] = int((torch.sort(a[r, :n]).values
                               != torch.sort(c[r, :n]).values).sum())
            a, c = a.clone(), c.clone()
            a[r, :n] = c[r, :n] = 0
        out[f.name] = int((bits(a) != bits(c)).sum())
    return out


def shade_alone(pt_shade_mod, kw):
    """(run, restore) of csrc/pt_shade.cu's entry point alone on the state
    of `kw` (shade_states' bounce): run() the launch the wrapper recorded,
    restore() the Wave copied back."""
    w = wave_copy(kw["w"])
    _, run = bare_entry(pt_shade_mod, "pt_shade", lambda: pt_shade_mod
                        .shade_cuda(**{**kw, "w": w}))
    return run, lambda: wave_put(w, kw["w"])


def parent_shade_alone(ppt, kw):
    """(run, restore) of BASELINE's pt_shade.cu alone on the state of
    `kw` in its own layout: every lane's [N] fields at the positions
    (finished lanes dead, their state zero), int64 keys asked where this
    checkout sorts; its wrapper writes fresh outputs, so restore() is
    empty."""
    from gpu_pathtracer_tpu_torch.integrators import pt_shade
    w, b = kw["w"], kw["b"]
    last = b == kw["static"].max_depth
    src, front, visit = pt_shade.visits(w, b)
    f = pt_shade.fields(w.rec[src])
    occ = kw["occ"][src] if kw["occ"] is not None else \
        torch.zeros_like(visit)
    alive = front & ((f["flags"] & pt_shade.ALIVE) != 0)
    flags = torch.where(visit, (f["flags"] & pt_shade.SPECULAR)
                        | (alive.to(torch.int32) << 1)
                        | (occ.to(torch.int32) << 2), 0)
    pend = visit & ((f["flags"] & pt_shade.PENDING) != 0)

    def z(x):
        return torch.where(visit.view(-1, *([1] * (x.dim() - 1))), x,
                           0).contiguous()
    args = dict(
        scene=kw["scene"], static=kw["static"], b=b, seed=kw["seed"],
        iteration=kw["iteration"], lanes=z(f["lanes"]), t=kw["t"],
        prim=kw["prim"], ro=w.ro.clone(), rd=w.rd.clone(), li=z(f["li"]),
        beta=z(f["beta"]), prev_pdf=z(f["prev_pdf"]), flags=flags.contiguous(),
        pending=torch.where(pend[:, None], f["pending"], 0.0).contiguous()
        if b else None, psample=kw["psample"], key=w.sorted and not last,
        shadow_key=w.shadow_key is not None and not last)
    out, run = bare_entry(ppt, "pt_shade", lambda: ppt.shade_cuda(**args))
    run.keep = (args, out)
    return run, lambda: None


def shade_work(kw, after, done) -> dict:
    """pt_shade.cu's least time on one call (`kw`: shade_states' bounce,
    `after`: the Wave the plain version left, `done`: the positions whose
    lane finished): bytes over 3.35 TB/s, a
    field where a lane reads it and a word where its value changes, or
    SHADE_FLOPS a live lane over 67 TFLOP/s. Reads: a visited lane's flags
    and li (and its slot if it finishes), a live lane's hit (t, prim),
    ray, beta, prev_pdf and lane id, a pending credit and its verdict,
    the sort's order (8 B) or the list's entry; writes: the lane's record
    words that change, its radiance at its slot when it finishes, the
    next ray's, tmax's, the shadow ray's and the keys' words that change,
    the list's entries; the tables: the prim rows hit, the material,
    light and CDF tables, the sky and the texels."""
    from gpu_pathtracer_tpu_torch.integrators import pt_shade as ps
    scene, static, w0, b = kw["scene"], kw["static"], kw["w"], kw["b"]
    last = b == static.max_depth
    src, front, visit = ps.visits(w0, b)
    f = ps.fields(w0.rec[src])
    alive = front & ((f["flags"] & ps.ALIVE) != 0)
    pend = visit & ((f["flags"] & ps.PENDING) != 0)
    n_vis, n_alive, n_pend = (int(x.sum()) for x in (visit, alive, pend))
    read = n_vis * 16 + n_alive * (8 + 24 + 12 + 4 + 4) + n_pend * 13
    if w0.sorted and b > 0:
        n_front = int(front.sum())
        read += n_front * 8 + (n_vis - n_front) * 4
    # the lanes' record words, by lane: before at src, after where kept
    kept = visit & ~done
    new = after.spare if w0.sorted else after.rec
    changed = (bits(w0.rec[src][:, :ps.SLOT]) != bits(new[:, :ps.SLOT])) \
        & kept[:, None]
    read += int(done.sum()) * 4
    write = int(changed.sum()) * 4 + int(done.sum()) * 12
    for name in ("ray", "tmax", "shadow_o", "shadow_d", "shadow_t",
                 "shadow_key", "key"):
        a, c = getattr(w0, name), getattr(after, name)
        if a is not None and not last:
            write += int((bits(a) != bits(c)).sum()) * 4
    if w0.sorted and not last:
        write += int(after.counts[b + 1, 1]) * 4
    prim = kw["prim"]
    rows = int(torch.unique(prim[alive & (prim >= 0)]).numel()) * 40 * 4
    tables = sum(t.numel() * t.element_size() for t in (
        scene.mat_attrs, scene.light_attrs, scene.light_cdf))
    if static.has_infinite:
        tables += scene.env_data.numel() * 4
    if static.has_textures:
        tables += scene.tex_data.numel()
    n_bytes = read + write + rows + tables
    out = bound(n_bytes, n_alive * SHADE_FLOPS)
    out.update(bytes=n_bytes, read=read, write=write, visited=n_vis,
               alive=n_alive)
    return out


def occupancy(regs: int, threads: int = 128) -> int:
    """Blocks of `threads` an H100 SM holds at `regs` registers a thread
    (registers allocated 256 a warp; 65,536 an SM, 64 warps, 32 blocks)."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = threads // 32
    return min(65536 // (per_warp * warps), 64 // warps, 32)


def ptxas_regs(report: str, kernel: str) -> list:
    """The register counts of `kernel`'s variants in a ptxas report."""
    import re
    return [int(r) for r in re.findall(
        r"Used (\d+) registers", "\n".join(
            seg for seg in report.split("Compiling entry function")
            if f"{kernel}" in seg.split("\n")[0]))]


def phase_s(dev, rng, card, records):
    """csrc/pt_shade.cu against shade_wave_torch on copies of the same
    Wave, one bounce at 1M lanes for each SHADE_CASES case, every word of
    the state bit for bit (the list as a set); one spp of each
    SHADE_FILMS scene over the kernels against all-plain, and knot's,
    many_lights' and bssrdf.json's with the shading kernel over the plain
    hit queries bit for bit; the kernel alone at each bounce of knot's
    spp (its entry point on the wrapper's structure, the state put back)
    against its recounted bound, and with --baseline the parent's kernel
    alone on the same states in its own layout, in turns; the plain
    version at bounce 1."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        kernel_stats, reset_counts)
    from gpu_pathtracer_tpu_torch.geom import traverse
    from gpu_pathtracer_tpu_torch.integrators import pt, pt_shade
    from gpu_pathtracer_tpu_torch import kernels
    report = kernels.BUILDS["pt_shade"].ptxas
    regs = ptxas_regs(report, "pt_shade_kernel")
    print(f"[S] pt_shade: {ptxas_summary(report)}; blocks of 128 an SM: "
          f"{sorted({occupancy(r) for r in regs})}")
    max_err = 0.0
    for label, path, bounce, psample in SHADE_CASES:
        kw = shade_states(dev, rng, path, (bounce,), psample)[bounce]
        wk, wp = wave_copy(kw["w"]), wave_copy(kw["w"])
        reset_counts(pt_shade.STATS)
        pt_shade.shade_cuda(**{**kw, "w": wk})
        pt_shade.shade_wave_torch(**{**kw, "w": wp}, plain=True)
        torch.cuda.synchronize()
        check(pt_shade.STATS.launches == 1 and pt_shade.STATS.plain_cuda == 1,
              f"{label}: launches {pt_shade.STATS}")
        tag = f"{label} bounce {bounce}"
        src, front, visit = pt_shade.visits(kw["w"], bounce)
        print(f"[S] {tag}: {int(visit.sum())} of {N_RAYS} lanes visited, "
              f"{int(front.sum())} alive, "
              f"{'sorted' if wk.sorted else 'in place'}"
              f", rays {wk.rays.tolist()} vs {wp.rays.tolist()}, shadow rays "
              f"{int((wk.shadow_t > 0.0).sum())}")
        max_err = max(max_err, (wk.out - wp.out).nan_to_num().abs().max()
                      .item())
        differ = wave_differ(wk, wp, bounce)
        print(f"[S] {tag}: words not bit-equal by field " + ", ".join(
            f"{f} {v}" for f, v in differ.items()))
        check(not any(differ.values()), f"{tag}: kernel and plain version "
              f"differ: {differ}")
        del wk, wp, kw

    stats = kernel_stats()
    for path in SHADE_FILMS:
        sc, st = scene_1024(path, dev)
        ids = torch.arange(N_RAYS, device=dev)
        px, py = ids % st.width, ids // st.width
        reset_counts(*stats.values())
        li_k, r_k = pt.render_lanes(sc, st, SEED, 1, px, py, True)
        torch.cuda.synchronize()
        counts = {k: s.launches for k, s in stats.items()}
        plain = sum(s.plain_cuda for s in stats.values())
        li_p, r_p = pt.wavefront(sc, st, SEED, 1, px, py, True, plain=True)
        print(f"[S] film {path}: launches {counts}, plain-version calls on "
              f"CUDA {plain}, rays {int(r_k)} vs {int(r_p)}")
        hold_radiance(f"S film {path}", "radiance", li_k, li_p)
        check(counts["pt_shade"] == st.max_depth + 1 and counts["pt_fused"]
              == 0 and plain == 0, f"film {path}: launches {counts}, "
              f"plain calls {plain}")
        records["pt_shade"][f"launches_film_{os.path.basename(path)}"] = \
            counts["pt_shade"]
        if path != KNOT["forest"]:   # the kernel over the plain hits
            with plain_hits(traverse):
                li_h, r_h = pt.render_lanes(sc, st, SEED, 1, px, py, True)
            ne = int((bits(li_h) != bits(li_p)).any(1).sum())
            print(f"[S] film {path}, pt_shade.cu over the plain hit queries "
                  f"vs all-plain: lanes not bit-equal {ne}, rays {int(r_h)} "
                  f"vs {int(r_p)}")
            check(ne == 0 and int(r_h) == int(r_p), f"film {path}: the "
                  "shading kernel's wavefront differs from the plain one")
            del li_h
        del li_k, li_p

    # alone at every bounce of knot's spp (the sorted rows) and of
    # many_lights' (the records in place), against the recounted bounds
    ppt = baseline_module("pt_shade", "S") if BASELINE else None
    unsorted = shade_alone_spp(dev, rng, MANY_LIGHTS, ppt, card)
    states = shade_states(dev, rng, KNOT["scene"], range(6))
    per = {}
    for b, kw in states.items():
        after = wave_copy(kw["w"])
        done = pt_shade.shade_wave_torch(**{**kw, "w": after}, plain=True)
        bd = shade_work(kw, after, done)
        del after
        fns = {"this": shade_alone(pt_shade, kw)}
        if ppt is not None:
            fns = {"parent": parent_shade_alone(ppt, kw), **fns}
        t = timed_alone(fns)
        ms = {k: sum(x) / len(x) for k, x in t.items()}
        per[b] = {"ms": ms["this"], "bound_ms": bd["bound_ms"],
                  "bytes": bd["bytes"], "visited": bd["visited"],
                  "alive": bd["alive"], **({"baseline_ms": ms["parent"]}
                                           if ppt is not None else {})}
        print(f"[S] pt_shade alone at knot scene.json's bounce {b} "
              f"({bd['visited']} lanes visited, {bd['alive']} alive): "
              f"{ms['this']:.4f} ms (turns "
              f"{', '.join(f'{x:.4f}' for x in t['this'])})"
              + (f", {BASELINE} {ms['parent']:.4f} ms (turns "
                 f"{', '.join(f'{x:.4f}' for x in t['parent'])})"
                 if ppt is not None else "")
              + f"; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
              f"({bd['bytes']} bytes: read {bd['read']}, written "
              f"{bd['write']}) ({card})")
        del fns
    spp = {k: sum(x[k] for x in per.values()) for k in ("ms", "bound_ms")}
    line = (f"[S] pt_shade alone over knot's spp (6 launches): "
            f"{spp['ms']:.4f} ms, bound {spp['bound_ms']:.4f} ms "
            f"({spp['ms'] / spp['bound_ms']:.2f}x)")
    if ppt is not None:
        spp["baseline_ms"] = sum(x["baseline_ms"] for x in per.values())
        line += f", {BASELINE} {spp['baseline_ms']:.4f} ms"
    print(f"{line} ({card})")

    kw = states[1]
    wt = wave_copy(kw["w"])
    t = timed_windows({"plain": lambda: pt_shade.shade_wave_torch(
        **{**kw, "w": wt}, plain=True)})
    plain_ms = sum(t["plain"]) / len(t["plain"])
    print(f"[S] pt_shade's plain version at knot's bounce 1: "
          f"{plain_ms:.4f} ms (windows {min(t['plain']):.4f}-"
          f"{max(t['plain']):.4f}) ({card})")
    records["pt_shade"].update(
        max_abs_err=max_err, ms=per[1]["ms"], plain_ms=plain_ms,
        bound_ms=per[1]["bound_ms"], bound_by="bytes", library_ms=None,
        bound_bytes=per[1]["bytes"], by_bounce=per, spp=spp, registers=regs,
        spp_many_lights=unsorted)


def shade_alone_spp(dev, rng, path, ppt, card) -> dict:
    """pt_shade.cu alone at every bounce of one spp of the scene at
    `path`, and with --baseline (`ppt`) the parent's in turns on the same
    states: the sums over the spp, ms."""
    from gpu_pathtracer_tpu_torch.integrators import pt_shade
    out = {"ms": 0.0, "baseline_ms": 0.0}
    for b, kw in shade_states(dev, rng, path, range(6)).items():
        fns = {"this": shade_alone(pt_shade, kw)}
        if ppt is not None:
            fns = {"parent": parent_shade_alone(ppt, kw), **fns}
        t = timed_alone(fns)
        for k, side in (("ms", "this"), ("baseline_ms", "parent")):
            if side in t:
                out[k] += sum(t[side]) / len(t[side])
        del fns, kw
    print(f"[S] pt_shade alone over {os.path.basename(path)}'s spp (records "
          f"in place): {out['ms']:.4f} ms"
          + (f", {BASELINE} {out['baseline_ms']:.4f} ms" if ppt else "")
          + f" ({card})")
    return out


@contextlib.contextmanager
def plain_hits(traverse):
    """traverse's closest-hit and any-hit queries forced to their plain
    versions (the shading kernels stay)."""
    orig = traverse.closest_prim, traverse.intersect_any
    traverse.closest_prim = lambda *a, **k: orig[0](*a[:6], plain=True)
    traverse.intersect_any = lambda *a, **k: orig[1](*a[:6], plain=True)
    try:
        yield
    finally:
        traverse.closest_prim, traverse.intersect_any = orig


def baseline_module(name: str, tag: str):
    """--baseline's integrators/<name>.py, loaded beside this checkout's
    (as baseline_<name>) over its csrc/<name>.cu built here."""
    import importlib.util
    lib, ptxas = baseline_library(name)
    print(f"[{tag}] {name}.cu of {BASELINE}: {ptxas_summary(ptxas)}")
    path = os.path.join(BASELINE, "gpu_pathtracer_tpu_torch", "integrators",
                        "bdpt_shade.py" if name == "bdpt" else f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"baseline_{name}", path)
    m = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = m
    spec.loader.exec_module(m)
    m.load_library = lambda _: lib
    return m


# ---------------------------------------------------------------- phase V

# the VPT step's kernels against their plain versions: (label, scene,
# step), each captured from a VPT spp over the kernels at 1024^2; step 13
# is the last (max_depth 5 + INTERFACE_BUDGET 8), where the lanes left
# only collect arrival credit; "fog_camera" and "smoke_camera" are edits
# of smoke_port (vpt_edit_scene)
VPT_CASES = (
    ("smoke_port", SMOKE, 0),
    ("smoke_port", SMOKE, 1),
    ("smoke_port", SMOKE, 6),
    ("smoke_port, the last step", SMOKE, 13),
    ("the camera in the fog (homogeneous)", "fog_camera", 1),
    ("the camera in the smoke (emitter walks)", "smoke_camera", 0),
    ("smoke_port/sky.json (sky)", SMOKE_SKY, 1),
    ("cornell_port (no media)", SCENES[0], 1),
    ("materials.json (lines, spheres, six models)", SCENES[1], 1),
    ("textured.json (textures)", K2_VARIANTS["textured"], 1),
    ("bssrdf.json", BSSRDF, 1))


def vpt_edit_scene(kind: str) -> str:
    """smoke_port edited, written to OUT with absolute mesh and density
    paths: "fog_camera" without the smoke, the camera in the fog sphere;
    "smoke_camera" without the smoke box's interface, the camera in the
    smoke's density box looking up at the light (its camera rays reach
    the light through the heterogeneous medium). Returns its path."""
    src = os.path.join(REPO, SMOKE)
    with open(src) as f:
        doc = json.load(f)
    base = os.path.dirname(src)
    for unit in doc["scene"] + doc["light"]:
        if "mesh" in unit:
            unit["mesh"] = os.path.join(base, unit["mesh"])
    for med in doc["medium"]:
        if "density" in med:
            med["density"] = os.path.join(base, med["density"])
    doc["scene"] = [u for u in doc["scene"] if u.get("inside") != "smoke"]
    if kind == "fog_camera":
        doc["medium"] = [m for m in doc["medium"] if m["name"] == "fog"]
        doc["camera"].update(position=[0.5, 0.45, 0.7],
                             lookat=[0.0, 1.0, -1.0], fov=60, medium="fog")
    else:
        doc["camera"].update(position=[-0.35, 1.2, -0.45],
                             lookat=[0.0, 2.0, 0.0], fov=60, medium="smoke")
    path = os.path.join(OUT, f"{kind}.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


VPT_RECORDS = ("Lanes", "Walk", "Lists")   # vpt_shade.py's state records


def _cloned(v):
    """v with its tensors cloned: a tensor, or a Lanes / Walk / Lists
    record of integrators/vpt_shade.py (of this checkout or of
    --baseline's); anything else (the scene, an int) as it is."""
    import dataclasses
    if torch.is_tensor(v):
        return v.clone()
    if type(v).__name__ in VPT_RECORDS and dataclasses.is_dataclass(v):
        return dataclasses.replace(v, **{
            f.name: _cloned(getattr(v, f.name))
            for f in dataclasses.fields(v)})
    return v


def _restore(dst, src) -> None:
    """Copy record src's tensors (and a Lists record's cursors) into
    record dst's, field by field, in place: the state an in-place kernel
    changed put back."""
    import dataclasses
    for f in dataclasses.fields(dst):
        a, b = getattr(dst, f.name), getattr(src, f.name)
        if torch.is_tensor(a):
            a.copy_(b)
        elif dataclasses.is_dataclass(a):
            _restore(a, b)
        elif isinstance(a, int):
            setattr(dst, f.name, b)


def restorer_of(kw):
    """A function that puts the state records and the ray count of the
    arguments `kw` back as they are now."""
    saved = {k: _cloned(v) for k, v in kw.items()
             if k in ("lane", "walk", "rays") and v is not None}

    def restore():
        for k, v in saved.items():
            if torch.is_tensor(v):
                kw[k].copy_(v)
            else:
                _restore(kw[k], v)
    return restore


def vpt_inputs(dev, path, step, vs=None, vpt=None, rounds=(0, 1)) -> dict:
    """The arguments, by parameter name, of vpt_shade.shade at `step`, of
    vpt_shade.tr_round at that step's `rounds`, and of vpt_shade.finish,
    copied as each call found them in one VPT spp over the kernels of the
    scene at `path` at 1024^2, lanes in pixel order: {"shade": ...,
    "tr": [...], "finish": ...} (without `plain`). `vs` and `vpt`: the
    modules to drive (--baseline's; default this checkout's)."""
    import inspect
    if vs is None:
        from gpu_pathtracer_tpu_torch.integrators import vpt, vpt_shade as vs
    sc, st = scene_1024(path, dev)
    ids = torch.arange(N_RAYS, device=dev)
    got = {"shade": None, "tr": [], "finish": None}
    at = {"step": -1, "round": 0}
    orig = {k: getattr(vs, k) for k in ("shade", "tr_round", "finish")}

    def wrap(name):
        sig = inspect.signature(orig[name])

        def fn(*args, **kwargs):
            kw = sig.bind(*args, **kwargs)
            kw.apply_defaults()
            a = kw.arguments

            def keep():
                return {k: _cloned(v) for k, v in a.items() if k != "plain"}
            if name == "shade":
                at.update(step=a["step"], round=0)
                if a["step"] == step:
                    got["shade"] = keep()
            elif name == "tr_round":
                if at["step"] == step and at["round"] in rounds:
                    got["tr"].append(keep())
                at["round"] += 1
            else:
                got["finish"] = keep()
            return orig[name](*args, **kwargs)
        return fn

    for k in orig:
        setattr(vs, k, wrap(k))
    try:
        vpt.render_lanes(sc, st, SEED, 1, ids % st.width, ids // st.width)
    finally:
        for k, f in orig.items():
            setattr(vs, k, f)
    check(got["shade"] is not None and len(got["tr"]) == len(rounds)
          and got["finish"] is not None, f"{path}: no step {step} captured")
    return got


WALK_CORE = ("o", "d", "rem", "med", "tr", "flags", "sites", "pending",
             "tmax")


def vpt_differ(tag, k, p, fields=None) -> dict:
    """{field: lanes not bit-equal} of two Lanes / Walk records, over
    `fields` (default every tensor field of `k`)."""
    import dataclasses
    out = {}
    for f in fields or [f.name for f in dataclasses.fields(k)]:
        a, b = getattr(k, f), getattr(p, f)
        if not torch.is_tensor(a) and not torch.is_tensor(b):
            continue
        check(a is not None and b is not None, f"{tag}: {f} written by one "
              "side only")
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{tag}: {f} {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        ne = bits(a) != bits(b)
        out[f] = int(ne.reshape(ne.shape[0], -1).any(1).sum())
    return out


def list_differ(rows, count, expect) -> tuple:
    """(rows listed that `expect` [N] bool does not hold, or holds that
    are not listed, or listed twice; the list's length): a kernel's list
    `rows[:count]` against its plain helper's set."""
    c = int(count)
    ids = rows[:c].long()
    got = torch.zeros_like(expect)
    got[ids] = True
    return int((got != expect).sum()) + c - int(got.sum()), c


def vpt_shade_case(tag, kw) -> dict:
    """vpt_shade on a copy of `kw` (in place) against shade_torch on kw:
    the lane state on every lane and the walk as later launches read it
    (`live_walk`) bit for bit, the rays, and the lists the kernel read
    and appended against `shade_list` and `round_list` as sets. Returns
    {what: lanes that differ} and the kernel's and plain lane states."""
    from gpu_pathtracer_tpu_torch.integrators import vpt_shade as vs
    s = kw["step"]
    kk = {k: _cloned(v) for k, v in kw.items()}
    rp = kw["rays"].clone()
    lane_k, walk_k = vs.shade_cuda(**kk)
    lane_p, walk_p = vs.shade_torch(**{**kw, "rays": rp}, plain=True)
    torch.cuda.synchronize()
    differ = vpt_differ(tag, lane_k, lane_p)
    differ.update({f"walk {f}": v for f, v in vpt_differ(
        tag, vs.live_walk(walk_k), vs.live_walk(walk_p), WALK_CORE).items()})
    differ["rays"] = int(kk["rays"] != rp)
    lists = walk_k.lists
    sizes = {}
    if kw["walk"] is not None:
        differ["list read"], sizes["read"] = list_differ(
            lists.shade[s % 2], lists.counts[s, 0],
            vs.shade_list(kw["lane"], kw["walk"]))
    differ["next list"], sizes["next"] = list_differ(
        lists.shade[(s + 1) % 2], lists.counts[s + 1, 0],
        vs.shade_list(lane_p, walk_p))
    differ["walk list"], sizes["walk"] = list_differ(
        lists.walk[0], lists.counts[s, 1], vs.round_list(walk_p))
    return differ, sizes, lane_k, lane_p


def vpt_round_case(tag, tkw) -> tuple:
    """vpt_tr_round on a copy of `tkw` (in place) against tr_round_torch
    on tkw: every walk field on every lane bit for bit (the track call's
    origin where it walks), the rays, the lists read and appended against
    `round_list`. Returns ({what: lanes that differ}, list lengths, the
    kernel's walk)."""
    from gpu_pathtracer_tpu_torch.integrators import vpt_shade as vs
    kk = {k: _cloned(v) for k, v in tkw.items()}
    rp = tkw["rays"].clone()
    lists = kk["walk"].lists
    s, r = lists.step, lists.round
    k = vs.tr_round_cuda(**kk)
    p = vs.tr_round_torch(**{**tkw, "rays": rp})
    torch.cuda.synchronize()
    differ = vpt_differ(tag, k, p, WALK_CORE + ("track_med", "track_t"))
    walks = p.track_med >= 0
    differ["track_o"] = int((bits(k.track_o[walks]) != bits(
        p.track_o[walks])).any(1).sum())
    differ["rays"] = int(kk["rays"] != rp)
    sizes = {}
    differ["list read"], sizes["read"] = list_differ(
        lists.walk[r % 2], lists.counts[s, 1 + r], vs.round_list(tkw["walk"]))
    differ["next list"], sizes["next"] = list_differ(
        lists.walk[(r + 1) % 2], lists.counts[s, 2 + r], vs.round_list(p))
    return differ, sizes, k, p


def bare_entry(module, entry, call):
    """Run call() with `module`'s library (its `_lib()`) answering through
    a recorder; return (call's result, run), run() calling the library's
    `entry` again on the argument structure and stream that call() gave
    it: the kernel's launch alone, without the wrapper's checks,
    allocations and structure (run(args): on another structure;
    run.args: the recorded one)."""
    import ctypes
    lib = module._lib()
    seen = {}

    class Recorder:
        def __getattr__(self, name):
            return getattr(lib, name)

    rec = Recorder()

    def record(*args):   # (structure, stream), or positional arguments
        seen["args"] = args
        return getattr(lib, entry)(*args)
    setattr(rec, entry, record)
    orig = module._lib
    module._lib = lambda: rec
    try:
        out = call()
    finally:
        module._lib = orig
    fn = getattr(lib, entry)

    def run(args=None):
        rc = fn(*seen["args"]) if args is None else fn(
            ctypes.byref(args), seen["args"][-1])
        check(rc == 0, f"{entry}: launch failed with CUDA error {rc}")
    run.args = getattr(seen["args"][0], "_obj", None)
    return out, run


def host_us(fn, restore, reps: int = 20) -> float:
    """The median host microseconds of one fn() call (a wrapper: its
    checks, allocations and launch, not waiting for the card), restore()
    and a synchronize before each."""
    ts = []
    for _ in range(reps):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    restore()
    return sorted(ts)[len(ts) // 2] * 1e6


def timed_alone(fns: dict, reps: int = 20) -> dict:
    """Each (run, restore) of `fns` timed with CUDA events around run()
    alone, restore() before every run, in turns a, b, ..., b, a -> {name:
    [ms per run, one value per turn]}. A spin of about half a millisecond
    on the card (torch.cuda._sleep) comes between restore() and the first
    event, so the card is still busy while the host enqueues the launch:
    the interval holds the kernel, not the host's call."""
    out = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        run, restore = fns[k]
        restore()
        run()   # warm-up
        ts = []
        for _ in range(reps):
            restore()
            torch.cuda._sleep(1_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            run()
            e.record()
            ts.append((s, e))
        torch.cuda.synchronize()
        out[k].append(sum(s.elapsed_time(e) for s, e in ts) / reps)
    return out


def _tensor_bytes(*xs) -> int:
    """The bytes of the tensors among xs (Lanes / Walk records by field)."""
    import dataclasses
    n = 0
    for x in xs:
        if torch.is_tensor(x):
            n += x.numel() * x.element_size()
        elif dataclasses.is_dataclass(x):
            n += _tensor_bytes(*(getattr(x, f.name)
                                 for f in dataclasses.fields(x)))
    return n


def _pend_floats(flags):
    """The pending factors settle() reads a lane by its credit."""
    from gpu_pathtracer_tpu_torch.integrators import vpt_shade as vs
    return (((flags & vs.SCATTER) != 0) * 7 + ((flags & vs.EMITTER) != 0) * 6
            + ((flags & vs.SURFACE) != 0) * 12)


LANE_WRITES = ("ro", "rd", "li", "beta", "prev_pdf", "depth", "med", "flags",
               "tmax", "med_sample")   # the lane fields vpt_shade writes
WALK_WRITES = ("o", "d", "rem", "med", "tr", "flags", "sites", "pending",
               "tmax", "track_med", "track_t")   # the walk's
ROUND_WRITES = ("o", "rem", "med", "tr", "flags", "tmax", "track_med",
                "track_t", "track_o")   # vpt_tr_round's


def _changed_bytes(before, after, fields) -> int:
    """The bytes of record `after`'s `fields` whose 4-byte words differ
    from `before`'s: what a launch must write, a word where its value
    changes and nowhere else."""
    n = 0
    for f in fields:
        a, b = getattr(before, f), getattr(after, f)
        if a is not None and b is not None:
            n += int((bits(a) != bits(b)).sum()) * 4
    return n


def _heterogeneous(scene, med):
    """[N] bool: med names a heterogeneous medium."""
    from gpu_pathtracer_tpu_torch.shade.media import HETEROGENEOUS
    out = torch.zeros_like(med, dtype=torch.bool)
    inside = med >= 0
    out[inside] = (scene.med_table[med[inside].long(), 0]
                   .to(torch.int32) == HETEROGENEOUS)
    return out


def vpt_shade_before(kw) -> dict:
    """What vpt_shade_work needs of a step's inputs, copied before the
    kernel changes them in place: the list, the lane state and the walk
    (at step 0 the walk the kernel starts from)."""
    from gpu_pathtracer_tpu_torch.integrators import vpt_shade as vs
    lane, walk = kw["lane"], kw["walk"]
    n = lane.ro.shape[0]
    return {"on": vs.shade_list(lane, walk), "lane": _cloned(lane),
            "walk": _cloned(walk) if walk is not None else vs._new_walk(
                n, lane.ro.device, vs.n_steps(kw["static"])),
            "listed": walk is not None}


def vpt_shade_work(kw, before, lane_after, walk_after, n_next,
                   n_walk) -> dict:
    """vpt_shade's least time on one step: the bytes the function must
    move for the lanes of its list, over 3.35 TB/s (bytes-bound: its float
    work, a few hundred operations a live lane, is some ten times below).
    A field is read where the step needs it and written where its value
    changes (`_changed_bytes`).
    - The list (after step 0) and the two lists it appends, 4 B a row.
    - A listed lane reads its flags, the walk's flags and beta (a dead
      lane's li takes beta * 0); li is read where it changes.
    - A lane alive at the step's start reads ro, rd, depth, med, t and
      prim, prev_pdf where an MIS weight changed li; with a hit its lane
      id, found_t in a heterogeneous medium, and each prim row hit once.
    - A credit owed reads tr, the pending factors it uses and, folding,
      the last track result.
    - The material, light, CDF and media tables once."""
    from gpu_pathtracer_tpu_torch.integrators import vpt_shade as vs
    scene = kw["scene"]
    on, lane, walk = before["on"], before["lane"], before["walk"]
    flags, wflags = lane.flags, walk.flags
    alive = on & ((flags & vs.ALIVE) != 0)
    prim = kw["prim"]
    hit = alive & (prim >= 0)
    li_changed = (bits(lane.li) != bits(lane_after.li)).any(1)
    mis = alive & li_changed & ((flags & vs.FROM_SURF) != 0) \
        & ((flags & vs.SPECULAR) == 0) & (lane.depth > 0)
    n_on = int(on.sum())
    b = (4 * n_on + 4 if before["listed"] else 0) \
        + 4 * (n_next + n_walk) + 8
    b += n_on * (4 + (4 if before["listed"] else 0) + 12)
    b += int(li_changed.sum()) * 12
    b += int(alive.sum()) * (12 + 12 + 4 + 4 + 4 + 4) + int(mis.sum()) * 4
    b += int(hit.sum()) * 8 + int(torch.unique(prim[hit]).numel()) * 40 * 4
    if kw["found_t"] is not None:
        b += int((hit & _heterogeneous(scene, lane.med)).sum()) * 4
    credit = (wflags & vs.CREDIT) != 0
    b += int(credit.sum()) * 12 + int(_pend_floats(wflags).sum()) * 4
    if kw["walk_out"] is not None:
        b += int((credit & ((wflags & vs.FOLD) != 0)).sum()) * 4
    b += _changed_bytes(lane, lane_after, LANE_WRITES)
    b += _changed_bytes(walk, walk_after, WALK_WRITES)
    b += _tensor_bytes(scene.mat_attrs, scene.light_attrs, scene.light_cdf,
                       scene.med_table)
    out = bound(b, 0)
    out["bytes"] = b
    return out


def vpt_round_before(tkw) -> dict:
    """What vpt_tr_work needs of a round's inputs, copied before the
    kernel changes them in place."""
    from gpu_pathtracer_tpu_torch.integrators import vpt_shade as vs
    walk = tkw["walk"]
    return {"on": vs.round_list(walk), "walk": _cloned(walk)}


def vpt_tr_work(tkw, before, walk_after, n_next) -> dict:
    """vpt_tr_round's least time on one round: the bytes the function must
    move for the lanes of its list, over 3.35 TB/s (bytes-bound: a walking
    lane's hit record is some tens of operations). A field is read where
    the round needs it and written where its value changes
    (`_changed_bytes`).
    - The list and the list it appends, 4 B a row.
    - A listed lane reads its flags; a folding one its tr and the last
      track result.
    - A walking lane reads its (t, prim) and each prim row hit once; one
      that a real material does not block reads rem and med, as does an
      emitter lane; a homogeneous segment reads tr (where no fold did).
    - A lane that crosses reads its origin and direction; one whose
      segment the track call walks its origin.
    - The media table once."""
    from gpu_pathtracer_tpu_torch.integrators import vpt_shade as vs
    scene = tkw["scene"]
    on, walk = before["on"], before["walk"]
    flags = walk.flags
    walking = (flags & vs.WALKING) != 0
    fold = (flags & vs.FOLD) != 0
    emit = (flags & vs.EMIT) != 0
    prim = tkw["prim"]
    valid = walking & (prim >= 0)
    blocked = torch.zeros_like(valid)
    blocked[valid] = scene.prim_attrs[prim[valid].long(), 30] != -1
    seg = walking & ~blocked
    homogeneous = seg & (walk.med >= 0) & ~_heterogeneous(scene, walk.med)
    crossed = (walk_after.flags & vs.WALKING) != 0
    folds = (walk_after.flags & vs.FOLD) != 0
    n_on = int(on.sum())
    b = 4 * n_on + 4 + 4 * n_next + 4
    b += n_on * 4
    b += int(fold.sum()) * (12 + (4 if tkw["walk_out"] is not None else 0))
    b += int(walking.sum()) * 8
    b += int(torch.unique(prim[valid]).numel()) * 40 * 4
    b += int((seg | emit).sum()) * 8
    b += int((homogeneous & ~fold).sum()) * 12
    b += int((crossed | folds).sum()) * 12 + int(crossed.sum()) * 12
    b += _changed_bytes(walk, walk_after, ROUND_WRITES)
    b += _tensor_bytes(scene.med_table)
    out = bound(b, 0)
    out["bytes"] = b
    return out


def vpt_finish_bound(kw, out) -> dict:
    """vpt_finish's least time on one call: li read and li_out written on
    every lane, the walk's flags on every lane and, where a credit is
    owed, its tr, the pending factors it uses and, folding, the last
    track result, over 3.35 TB/s."""
    from gpu_pathtracer_tpu_torch.integrators import vpt_shade as vs
    walk = kw["walk"]
    f = walk.flags
    credit = (f & vs.CREDIT) != 0
    n_bytes = _tensor_bytes(kw["li"], out, f) + int(credit.sum()) * 12 \
        + int(_pend_floats(f).sum()) * 4
    if kw["walk_out"] is not None:
        n_bytes += int((credit & ((f & vs.FOLD) != 0)).sum()) * 4
    b = bound(n_bytes, 0)
    b["bytes"] = n_bytes
    return b


def kernel_spans(fn, names) -> dict:
    """fn() (ending in a synchronize) under torch.profiler: {name: [the
    device ms of each launch of the kernel `name`, in launch order]}
    (CUPTI's kernel records)."""
    import re
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = {k: [] for k in names}
    for e in sorted((e for e in events if e.get("ph") == "X"
                     and str(e.get("cat", "")).lower() == "kernel"),
                    key=lambda e: e["ts"]):
        for k in names:
            if re.search(rf"\b{k}\b", e["name"]):
                out[k].append(e["dur"] / 1e3)
    return out


def vpt_spp(dev, vs=None, vpt=None, bounds=False) -> dict:
    """One VPT spp of smoke_port at 1024^2 over the kernels (`vs`, `vpt`:
    --baseline's modules; default this checkout's), under torch.profiler:
    each launch's device ms of vpt_shade (a step) and vpt_tr_round (a
    round), in order, and, on this checkout, each list's length (the
    spp's counts) and, with `bounds`, each launch's recounted bound (a
    second spp, the same lists, each launch's inputs read before it)."""
    if vs is None:
        from gpu_pathtracer_tpu_torch.integrators import vpt, vpt_shade as vs
    sc, st = scene_1024(SMOKE, dev)
    ids = torch.arange(N_RAYS, device=dev)
    seen = {}
    shade = vs.shade

    def keep_lists(*args, **kwargs):
        out = shade(*args, **kwargs)
        seen.setdefault("lists", getattr(out[1], "lists", None))
        return out

    def render():
        return vpt.render_lanes(sc, st, SEED, 1, ids % st.width,
                                ids // st.width)
    vs.shade = keep_lists
    try:
        spans = kernel_spans(render, ("vpt_shade_kernel",
                                      "vpt_tr_round_kernel"))
    finally:
        vs.shade = shade
    out = {"shade_ms": spans["vpt_shade_kernel"],
           "round_ms": spans["vpt_tr_round_kernel"]}
    lists = seen.get("lists")
    if lists is not None:
        c = lists.counts.cpu()
        n_steps = len(out["shade_ms"])
        out["shade_rows"] = [N_RAYS] + [int(c[s, 0])
                                        for s in range(1, n_steps)]
        out["round_rows"] = [int(c[s, 1 + r]) for s in range(n_steps)
                             for r in range(len(out["round_ms"])
                                            // n_steps)]
    if bounds:
        out.update(vpt_spp_bounds(sc, st, ids, render))
    return out


def vpt_spp_bounds(sc, st, ids, render) -> dict:
    """Each vpt_shade's and vpt_tr_round's recounted bound (vpt_shade_work,
    vpt_tr_work) over one spp of render(), in launch order."""
    import inspect
    from gpu_pathtracer_tpu_torch.integrators import vpt_shade as vs
    out = {"shade_bound": [], "round_bound": []}
    orig = {"shade": vs.shade, "tr_round": vs.tr_round}
    sigs = {k: inspect.signature(f) for k, f in orig.items()}

    def shade(*args, **kwargs):
        kw = sigs["shade"].bind(*args, **kwargs)
        kw.apply_defaults()
        kw = kw.arguments
        before = vpt_shade_before(kw)
        lane, walk = orig["shade"](*args, **kwargs)
        s = kw["step"]
        c = walk.lists.counts
        out["shade_bound"].append(vpt_shade_work(
            kw, before, lane, walk, int(c[s + 1, 0]), int(c[s, 1])))
        return lane, walk

    def tr_round(*args, **kwargs):
        kw = sigs["tr_round"].bind(*args, **kwargs)
        kw.apply_defaults()
        kw = kw.arguments
        lists = kw["walk"].lists
        s, r = lists.step, lists.round
        before = vpt_round_before(kw)
        walk = orig["tr_round"](*args, **kwargs)
        out["round_bound"].append(vpt_tr_work(
            kw, before, walk, int(lists.counts[s, 2 + r])))
        return walk

    vs.shade, vs.tr_round = shade, tr_round
    try:
        render()
    finally:
        vs.shade, vs.tr_round = orig["shade"], orig["tr_round"]
    return out


def spp_line(label, spp, card) -> str:
    """One spp's kernel times (and bounds) a launch and in all."""
    s, r = spp["shade_ms"], spp["round_ms"]
    line = (f"{label}: vpt_shade {sum(s):.4f} ms a spp in {len(s)} "
            f"launches, vpt_tr_round {sum(r):.4f} ms in {len(r)}")
    if "shade_bound" in spp:
        bs, br = (sum(b["bound_ms"] for b in spp[k])
                  for k in ("shade_bound", "round_bound"))
        line += f"; bounds a spp {bs:.4f} and {br:.4f} ms"
    return line + f" ({card})"


def vpt_spp_report(spp, card, records) -> None:
    """Print one spp's per-step and per-round kernel ms, list lengths and
    bounds (vpt_spp of this checkout) and keep the sums."""
    per = len(spp["round_ms"]) // len(spp["shade_ms"])
    for s, ms in enumerate(spp["shade_ms"]):
        rounds = spp["round_ms"][s * per:(s + 1) * per]
        rows = spp["round_rows"][s * per:(s + 1) * per]
        rb = spp["round_bound"][s * per:(s + 1) * per]
        print(f"[V]   step {s}: vpt_shade {ms:.4f} ms over "
              f"{spp['shade_rows'][s]} rows (bound "
              f"{spp['shade_bound'][s]['bound_ms']:.4f} ms); rounds "
              + ", ".join(f"{x:.4f} ({n}, {b['bound_ms']:.4f})"
                          for x, n, b in zip(rounds, rows, rb)))
    print(f"[V] {spp_line('smoke_port, one spp of this checkout', spp, card)}")
    for name, ms, bd in (("vpt_shade", "shade_ms", "shade_bound"),
                         ("vpt_tr_round", "round_ms", "round_bound")):
        records[name].update(
            ms_spp=sum(spp[ms]), launches_spp=len(spp[ms]),
            bound_ms_spp=sum(b["bound_ms"] for b in spp[bd]))


def phase_v(dev, card, records):
    """csrc/vpt_shade.cu against its plain versions on the same inputs, for
    each VPT_CASES case at 1M lanes: vpt_shade at the step, vpt_tr_round
    at its rounds 0 and 1 (each on a copy of its inputs, in place),
    vpt_finish after the last step, every output bit for bit and the
    lists as sets; on smoke_port's inputs (step 1, its round 1, the
    finish) the kernels alone (their entry points on the wrappers'
    argument structures), the plain versions and the recounted bounds in
    turns, and the wrappers' host time; one spp's launches by step and
    round (CUPTI); with --baseline DIR, DIR's kernels beside these."""
    from gpu_pathtracer_tpu_torch import kernels
    from gpu_pathtracer_tpu_torch.integrators import vpt_shade as vs
    from gpu_pathtracer_tpu_torch.run.reference import reset_counts
    print(f"[V] vpt_shade.cu: {ptxas_summary(kernels.BUILDS['vpt_shade'].ptxas)}")
    occ = vs.occupancy()
    for name, o in occ.items():
        if name.startswith("vpt_tr_round") or "heterogeneous 1" in name \
                and "env 0, tex 0, all kinds 0" in name:
            print(f"[V] {name}: {o}")
    t0 = time.time()
    err = {"vpt_shade": 0.0, "vpt_tr_round": 0.0, "vpt_finish": 0.0}
    timed = None
    for label, path, step in VPT_CASES:
        spath = vpt_edit_scene(path) if path in ("fog_camera",
                                                 "smoke_camera") else path
        got = vpt_inputs(dev, spath, step)
        tag = f"{label} step {step}"
        kw = got["shade"]
        reset_counts(vs.STATS, vs.TR_STATS, vs.FINISH_STATS)
        differ, sizes, lane_k, lane_p = vpt_shade_case(tag, kw)
        check(vs.STATS.launches == 1 and vs.STATS.plain_cuda == 1,
              f"{tag}: launches {vs.STATS}")
        alive = int(((kw["lane"].flags & vs.ALIVE) != 0).sum())
        print(f"[V] {tag}: {alive} of {N_RAYS} lanes alive, lists {sizes}, "
              "lanes not bit-equal (lists: rows off): "
              + ", ".join(f"{f} {v}" for f, v in differ.items()))
        check(not any(differ.values()), f"{tag}: vpt_shade and its plain "
              f"version differ: {differ}")
        err["vpt_shade"] = max(err["vpt_shade"],
                               (lane_k.li - lane_p.li).abs().max().item())
        del lane_k, lane_p
        for r, tkw in enumerate(got["tr"]):
            differ, sizes, k, p = vpt_round_case(f"{tag} round {r}", tkw)
            walking = int(((tkw["walk"].flags & vs.WALKING) != 0).sum())
            print(f"[V] {tag} round {r}: {walking} lanes walking, folds "
                  f"{int(((k.flags & vs.FOLD) != 0).sum())}, lists {sizes}; "
                  "lanes not bit-equal: " + ", ".join(
                      f"{f} {v}" for f, v in differ.items()))
            check(not any(differ.values()), f"{tag} round {r}: vpt_tr_round "
                  f"and its plain version differ: {differ}")
            err["vpt_tr_round"] = max(err["vpt_tr_round"],
                                      (k.tr - p.tr).abs().max().item())
            del k, p
        fkw = got["finish"]
        k = vs.finish_cuda(**fkw)
        p = vs.finish_torch(**fkw)
        ne = int((bits(k) != bits(p)).any(1).sum())
        print(f"[V] {label}: vpt_finish lanes not bit-equal {ne}")
        check(ne == 0, f"{label}: vpt_finish and its plain version differ")
        err["vpt_finish"] = max(err["vpt_finish"],
                                (k - p).abs().max().item())
        check(all(st.launches == n and st.plain_cuda == n for st, n in (
            (vs.STATS, 1), (vs.TR_STATS, 2), (vs.FINISH_STATS, 1))),
              f"{tag}: launches {vs.STATS} {vs.TR_STATS} {vs.FINISH_STATS}")
        if path == SMOKE and step == 1:
            timed = got
        del got, k, p, kw, fkw

    # smoke_port's step 1, its round 1 and the finish: each kernel alone
    # on the wrapper's argument structure (its state put back before each
    # launch), its plain version, its bound; the wrappers' host time
    kw, tkw, fkw = timed["shade"], timed["tr"][1], timed["finish"]
    kb, tb = vpt_shade_before(kw), vpt_round_before(tkw)
    restore_s, restore_r = restorer_of(kw), restorer_of(tkw)
    s = kw["step"]
    (lane_s, walk_s), run_s = bare_entry(vs, "vpt_shade",
                                         lambda: vs.shade_cuda(**kw))
    c = walk_s.lists.counts
    b_shade = vpt_shade_work(kw, kb, lane_s, walk_s, int(c[s + 1, 0]),
                             int(c[s, 1]))
    restore_s()
    r = tkw["walk"].lists.round
    walk_r, run_r = bare_entry(vs, "vpt_tr_round",
                               lambda: vs.tr_round_cuda(**tkw))
    b_round = vpt_tr_work(tkw, tb, walk_r, int(c[s, 2 + r]))
    restore_r()
    f_out, run_f = bare_entry(vs, "vpt_finish", lambda: vs.finish_cuda(**fkw))
    b_finish = vpt_finish_bound(fkw, f_out)
    hold = {k: _cloned(v) for k, v in kw.items()}
    hold_t = {k: _cloned(v) for k, v in tkw.items()}
    host = {"shade": host_us(lambda: vs.shade_cuda(**kw), restore_s),
            "round": host_us(lambda: vs.tr_round_cuda(**tkw), restore_r),
            "finish": host_us(lambda: vs.finish_cuda(**fkw), lambda: None)}
    kern = timed_alone({"shade": (run_s, restore_s),
                        "round": (run_r, restore_r),
                        "finish": (run_f, lambda: None)})
    restore_s()
    restore_r()
    t = timed_windows({
        "shade plain": lambda: vs.shade_torch(**hold, plain=True),
        "round plain": lambda: vs.tr_round_torch(**hold_t),
        "finish plain": lambda: vs.finish_torch(**fkw)})
    where = {"shade": "step 1", "round": "step 1, round 1",
             "finish": "after the last step"}
    print(f"[V] the wrappers' host time a call (median of 20, not waiting "
          f"for the card): shade_cuda {host['shade']:.1f} us, tr_round_cuda "
          f"{host['round']:.1f} us, finish_cuda {host['finish']:.1f} us")
    for name, k, b in (("vpt_shade", "shade", b_shade),
                       ("vpt_tr_round", "round", b_round),
                       ("vpt_finish", "finish", b_finish)):
        kt, pt_ = kern[k], t[f"{k} plain"]
        ms, plain_ms = sum(kt) / len(kt), sum(pt_) / len(pt_)
        print(f"[V] {name} on smoke_port ({N_RAYS} lanes, {where[k]}): "
              f"kernel alone {ms:.4f} ms (turns {min(kt):.4f}-{max(kt):.4f}),"
              f" plain {plain_ms:.4f} ms (windows {min(pt_):.4f}-"
              f"{max(pt_):.4f}); bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']} ({b['bytes']} bytes) ({card})")
        records[name].update(
            max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=b["bound_ms"], bound_by=b["bound_by"], library_ms=None,
            bound_bytes=b["bytes"], host_us=host[k])
    records["vpt_shade"]["occupancy"] = occ
    del hold, hold_t

    spp = vpt_spp(dev, bounds=True)
    vpt_spp_report(spp, card, records)
    if BASELINE:
        baseline_vpt(dev, card, records)
    print(f"[V] done in {time.time() - t0:.1f} s")


def baseline_modules(name_lib: str = "vpt_shade"):
    """--baseline's integrators/vpt_shade.py and vpt.py, loaded beside
    this checkout's (as baseline_vpt_shade, baseline_vpt) over its
    csrc/vpt_shade.cu built here: ({name: module}, its ptxas report)."""
    import importlib.util
    lib, ptxas = baseline_library(name_lib)
    mods = {}
    for name in ("vpt_shade", "vpt"):
        path = os.path.join(BASELINE, "gpu_pathtracer_tpu_torch",
                            "integrators", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"baseline_{name}",
                                                      path)
        m = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = m
        spec.loader.exec_module(m)
        mods[name] = m
    mods["vpt_shade"].load_library = lambda _: lib
    mods["vpt"].vpt_shade = mods["vpt_shade"]
    return mods, ptxas


VPT_ALONE_STEPS = (1, 6)   # --baseline's steps: dense, and past half alive


def vpt_alone(dev, step, vs=None, vpt=None) -> dict:
    """vpt_shade at smoke_port's `step` and vpt_tr_round at that step's
    round 1 on the inputs one spp gave them (`vs`, `vpt`: --baseline's
    modules; default this checkout's, with this design's recounted
    bounds): {"shade": (run, restore), "round": (run, restore),
    "outputs", and "shade_bound", "round_bound" on this checkout}, run()
    the kernel's entry point alone, restore() its state put back (the
    parent's kernels write fresh outputs, so theirs copies as many bytes
    of their own inputs back onto themselves)."""
    got = vpt_inputs(dev, SMOKE, step, vs, vpt, rounds=(1,))
    ours = vs is None
    if ours:
        from gpu_pathtracer_tpu_torch.integrators import vpt_shade as vs
    kw, tkw = got["shade"], got["tr"][0]
    out = {}
    if ours:
        kb, tb = vpt_shade_before(kw), vpt_round_before(tkw)
        r = tkw["walk"].lists.round
    restore_s, restore_r = restorer_of(kw), restorer_of(tkw)
    (lane, walk), run_s = bare_entry(vs, "vpt_shade",
                                     lambda: vs.shade_cuda(**kw))
    w, run_r = bare_entry(vs, "vpt_tr_round", lambda: vs.tr_round_cuda(**tkw))
    if ours:
        c = walk.lists.counts
        out["shade_bound"] = vpt_shade_work(kw, kb, lane, walk,
                                            int(c[step + 1, 0]),
                                            int(c[step, 1]))
        out["round_bound"] = vpt_tr_work(tkw, tb, w, int(c[step, 2 + r]))
    restore_s()
    restore_r()
    # the parent's kernels write into the outputs its wrappers allocated:
    # kept alive, so that no later allocation takes their memory
    out.update(shade=(run_s, restore_s), round=(run_r, restore_r),
               outputs=(lane, walk, w))
    return out


def baseline_vpt(dev, card, records):
    """vpt_shade and vpt_tr_round of the checkout at BASELINE (its
    vpt_shade.cu built here, driven by its own vpt_shade.py and vpt.py)
    against this checkout's: a whole VPT spp of smoke_port bit for bit
    (radiance and rays); each kernel alone on smoke_port's VPT_ALONE_STEPS
    and their round 1 (each checkout on its own captured inputs, the same
    values), in turns (parent, this, this, parent), against this
    checkout's recounted bounds; one spp's launches of both."""
    from gpu_pathtracer_tpu_torch.integrators import vpt
    mods, ptxas = baseline_modules()
    pvs, pvpt = mods["vpt_shade"], mods["vpt"]
    print(f"[V] vpt_shade.cu of {BASELINE}: {ptxas_summary(ptxas)}")
    sc, st = scene_1024(SMOKE, dev)
    ids = torch.arange(N_RAYS, device=dev)
    px, py = ids % st.width, ids // st.width
    li_k, rays_k = vpt.render_lanes(sc, st, SEED, 1, px, py, True)
    li_p, rays_p = pvpt.render_lanes(sc, st, SEED, 1, px, py, True)
    ne = int((bits(li_k) != bits(li_p)).any(1).sum())
    print(f"[V] a VPT spp of smoke_port ({N_RAYS} lanes) through this "
          f"checkout's kernels vs {BASELINE}'s: lanes not bit-equal {ne}, "
          f"rays {int(rays_k)} vs {int(rays_p)}")
    check(ne == 0 and int(rays_k) == int(rays_p),
          f"the VPT spp differs from {BASELINE}'s")
    del li_k, li_p
    for step in VPT_ALONE_STEPS:
        ours = vpt_alone(dev, step)
        theirs = vpt_alone(dev, step, pvs, pvpt)
        for name, k, bd in (("vpt_shade", "shade", "shade_bound"),
                            ("vpt_tr_round", "round", "round_bound")):
            t = timed_alone({"parent": theirs[k], "this": ours[k]})
            ms = {side: sum(x) / len(x) for side, x in t.items()}
            b = ours[bd]["bound_ms"]
            print(f"[V] {name} alone on smoke_port's step {step}"
                  f"{', round 1' if k == 'round' else ''}, in turns: "
                  f"{BASELINE} {ms['parent']:.4f} ms ({ms['parent'] / b:.2f}"
                  f"x the recounted bound {b:.4f} ms), this checkout "
                  f"{ms['this']:.4f} ms ({ms['this'] / b:.2f}x) ({card})")
            records[name].setdefault("in_turns", {})[f"step {step}"] = {
                "baseline_ms": ms["parent"], "ms": ms["this"],
                "bound_ms": b}
        del ours, theirs
    pspp = vpt_spp(dev, pvs, pvpt)
    per = len(pspp["round_ms"]) // len(pspp["shade_ms"])
    print(f"[V] {BASELINE} by step (vpt_shade ms; its rounds' sum): " + ", ".join(
        f"{s}: {x:.4f}; {sum(pspp['round_ms'][s * per:(s + 1) * per]):.4f}"
        for s, x in enumerate(pspp["shade_ms"])))
    print(f"[V] {spp_line(f'smoke_port, one spp of {BASELINE}', pspp, card)}")
    for name, key in (("vpt_shade", "shade_ms"), ("vpt_tr_round", "round_ms")):
        records[name]["baseline_ms_spp"] = sum(pspp[key])


BDPT_CASES = (   # label, scene, depth, lanes
    ("cornell_port (the bench row's shape)", SCENES[0], 5, N_RAYS),
    ("smoke_port (smoke, fog, interfaces, sample and Tr walks)", SMOKE, 5,
     N_RAYS),
    ("materials.json (six BSDFs, lines, spheres)", SCENES[1], 5, N_RAYS),
    ("textured.json (textures)", K2_VARIANTS["textured"], 5, N_RAYS),
    ("cornell_port at depth 17 (K = 18: 17 columns, one lane a warp)",
     SCENES[0], DEEP, 65536))
WALKER_FIELDS = ("ro", "rd", "beta", "forward", "med", "alive", "tmax",
                 "med_sample")


def bdpt_scene(path, dev, depth=5):
    """The scene at repo path `path` at 1024^2, set to BDPT at `depth`."""
    import dataclasses
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    sc, st = scene_1024(path, dev)
    return sc, dataclasses.replace(st, integrator=IntegratorType.BDPT,
                                   max_depth=depth)


def record_differ(k, p, fields, mask=None) -> dict:
    """{field: rows not bit-equal} of records k and p (Vertices, Walker or
    Queue), over the rows of `mask` where given (a bool tensor leading
    the field's shape)."""
    out = {}
    for f in fields:
        a, b = getattr(k, f), getattr(p, f)
        if a is None or b is None:
            check(a is None and b is None, f"{f} written by one side only")
            continue
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{f}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        ne = bits(a) != bits(b)
        if mask is not None:
            ne = ne[mask]
        out[f] = int(ne.reshape(ne.shape[0], -1).any(1).sum()) \
            if ne.numel() else 0
    return out


def tables_differ(k, p) -> dict:
    """{field: rows not bit-equal} of two Vertices: the counts, and every
    field on the slots below the count (bdpt.cu leaves the slots at and
    above it unwritten, and no result reads them)."""
    out = record_differ(k, p, ("count",))
    below = torch.arange(p.pos.shape[1], device=p.count.device)[None, :] \
        < p.count[:, None]
    fields = [f for f in type(p).__annotations__ if f != "count"]
    out.update(record_differ(k, p, fields, below))
    return out


def emptied(v):
    """A copy of Vertices v whose slots at and above each row's count hold
    empty_vertices' values, as the plain versions make their tables
    (bdpt.cu leaves them unwritten: any bits)."""
    import dataclasses
    above = torch.arange(v.pos.shape[1], device=v.count.device)[None, :] \
        >= v.count[:, None]
    empty = {"mat_idx": -1, "light_idx": -1, "medium": -1}
    out = {}
    for f in type(v).__annotations__:
        x = getattr(v, f).clone()
        if f != "count":
            x[above] = empty.get(f, 0)
        out[f] = x
    return dataclasses.replace(v, **out)


def queue_differ(k, p) -> dict:
    """{field: slots not bit-equal} of two queues: the flags and tmax on
    every slot, the shadow ray, credit, medium and pixel on the live
    slots (an empty slot's are not written by the kernel)."""
    out = record_differ(k, p, ("live", "tmax"))
    check(bool((k.live == p.live).all()), "the live slots differ")
    out.update(record_differ(k, p, ("o", "d", "L", "med"), p.live))
    out.update(record_differ(k, p, ("pix",), p.live[:p.pix.shape[0]]))
    return out


def copy_record(x):
    """x (Vertices, Walker or Queue) with its tensors cloned."""
    import dataclasses
    return dataclasses.replace(x, **{
        f.name: (getattr(x, f.name).clone()
                 if torch.is_tensor(getattr(x, f.name))
                 else getattr(x, f.name)) for f in dataclasses.fields(x)})


def restorer(v, w):
    """What a step changes besides the vertex it writes at `count`: the
    rows' state and the counts. Putting copies of them back before a run
    repeats the same step (its vertex slots are written again with the
    same values); in place, so a launch recorded by bare_entry sees
    them."""
    saved = {f: getattr(w, f).clone() for f in WALKER_FIELDS
             if getattr(w, f) is not None}
    count = v.count.clone()

    def restore():
        for f, x in saved.items():
            getattr(w, f).copy_(x)
        v.count.copy_(count)
    return restore


def timed_restored(fns: dict, reps: int = 20) -> dict:
    """Each (fn, restore) of `fns` timed with CUDA events around fn alone,
    restore() before every run, in turns a, b, ..., b, a -> {name: [ms
    per run, one value per turn]}."""
    out = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        fn, restore = fns[k]
        restore()
        fn()   # warm-up
        ts = []
        for _ in range(reps):
            restore()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            ts.append((s, e))
        torch.cuda.synchronize()
        out[k].append(sum(s.elapsed_time(e) for s, e in ts) / reps)
    return out


def bdpt_start_bound(v, w, lanes, scene) -> dict:
    """bdpt_start's least time on one call, bytes over 3.35 TB/s: each of
    the 2N rows writes its vertex 0 (every field, 77 B), its count and
    its state once and reads its lane id, the N camera rows their pixel
    (x, y), the light and CDF tables once. The slots above vertex 0 are
    not written (the steps write them)."""
    n2 = v.count.numel()
    vertex0 = sum(getattr(v, f)[:, 0].element_size()
                  * getattr(v, f)[0, 0].numel()
                  for f in type(v).__annotations__ if f != "count")
    n_bytes = n2 * (vertex0 + v.count.element_size() + lanes.element_size())
    n_bytes += _tensor_bytes(w) + lanes.numel() * 2 * 4
    n_bytes += _tensor_bytes(scene.light_attrs, scene.light_cdf)
    b = bound(n_bytes, 0)
    b["bytes"] = n_bytes
    return b


def bdpt_step_bound(static, before, after, prim) -> dict:
    """bdpt_step's least time on one call, bytes over 3.35 TB/s (a row's
    float work is a BSDF sample, some hundreds of operations, well below),
    a field where a row reads it and a word where its value changes: the
    step reads every row's alive flag; its rows are those alive at its
    start (`before`: (counts, Walker)), each reading its hit (t, prim;
    found_t in a heterogeneous medium), its state (ro, rd, beta, forward, med,
    count) and lane id, and, where it hit, its previous vertex's position
    and normal and its prim row (each row hit once); a row writes the
    words of its state that change (`after`: the plain step's (counts,
    Walker)), its new vertex (73 B) and its previous vertex's reverse
    pdf."""
    (c0, w0), (c1, w1) = before, after
    alive = w0.alive
    a = int(alive.sum())
    hit = alive & (prim >= 0)
    n_bytes = alive.numel() + a * (8 + 36 + 12 + 8)
    if static.has_hetero:
        n_bytes += a * 4
    n_bytes += int(hit.sum()) * 24
    n_bytes += int(torch.unique(prim[hit]).numel()) * 160
    for f in WALKER_FIELDS:
        x0, x1 = getattr(w0, f), getattr(w1, f)
        if x0 is not None:
            ne = bits(x0) != bits(x1)
            n_bytes += int(ne.sum()) * x0.element_size()
    made = int((c1 > c0).sum())
    n_bytes += int((c1 != c0).sum()) * 4 + made * (73 + 4)
    b = bound(n_bytes, 0)
    b.update(bytes=n_bytes, rows=a)
    return b


# bdpt_connect's instructions at least, counted from csrc/bdpt.cu on a
# Lambertian vertex pair without media (cornell_port's): a float add,
# multiply, compare or select, an integer operation, a load, a store or a
# shuffle is one (-fmad=false: no fused multiply-add; a negation or |x|
# is an operand modifier, powf one); an IEEE division or square root is
# DIV_INSTR, its fast path without fast math (a division: MUFU.RCP, FCHK,
# five FFMAs and the branch around the slow path; a square root:
# MUFU.RSQ, the range check, two FMULs, two FFMAs and the branch), the
# slow path not counted. CONNECT_OPS: (instructions, divisions, square
# roots) of each part: a staged vertex (23 loads of its record and
# segment, 17 of its material, 22 operations, 43 stores of its shared
# record, 9 addressing), a column of its MIS walk, an item of each round
# (plus CONNECT_COL_OPS a column: its share of the round's column sums by
# shuffles, three sums in t0), an item valid before its roulette (the
# mean, q and the draw's test), a kept slot (L / q, its ray, credit and
# medium stored); a valid item of s1 or the general rounds draws
# PHILOX_INSTR more before its test (t1's draw, the light sample's, is in
# t1's count).
CONNECT_OPS = {"stage": (114, 3, 1), "walk": (15, 1, 0),
               "s1": (277, 18, 3), "t0": (139, 4, 1), "t1": (453, 21, 8),
               "gen": (267, 12, 1), "ok": (22, 2, 0), "kept": (13, 3, 0)}
CONNECT_COL_OPS = {"s1": 3, "t0": 9, "t1": 3, "gen": 3}
DIV_INSTR = 10
PHILOX_INSTR = 100   # ten rounds of 2 mul.lo, 2 mul.hi, 4 xor, 2 key adds


def bdpt_connect_bound(scene, static, v, q, ok, n) -> dict:
    """bdpt_connect's least time on one call, the larger of: bytes over
    3.35 TB/s, each read once (per lane its id and both counts; per
    subpath of c >= 2 vertices its MIS columns below the count, 9 B each
    (fwd, rev, delta), vertex 0's position and normal (the first
    segment's far end), vertices 1 .. c - 1 at 52 B (position, normal,
    dpdu, beta, material; their uv with textures, their medium with
    media; a camera vertex's light index); the light side's delta at
    vertex 0 where it has no other vertex; the t0 radiance; per slot its
    flag and tmax; per live slot its shadow ray and credit (and medium,
    and s1's pixel); the scene's material and light tables), and the
    instructions (CONNECT_OPS by part: the staged vertices, their walks'
    columns, the items by round, the items valid before the roulette
    (`ok`: connect_valid's flags), the kept slots; a Philox draw a valid
    s1 or general item) over the 33.45 T/s issue peak."""
    k = v.pos.shape[1]
    g = k - 1
    live = q.live
    med = 4 if q.med is not None else 0
    cc, lc = v.count[:n].long(), v.count[n:].long()
    rec = 52 + (8 if static.has_textures else 0) + med
    n_bytes = n * (8 + 8 + 12)
    for c, extra in ((cc, 4), (lc, 0)):
        two = c >= 2
        n_bytes += int((c * two).sum()) * 9 + int(two.sum()) * 24
        n_bytes += int(torch.clamp_min(c - 1, 0).sum()) * (rec + extra)
    n_bytes += int(((lc == 1) & (cc >= 2)).sum())
    n_bytes += live.numel() * 5 + int(live.sum()) * (36 + med)
    n_bytes += int(live[:g].sum()) * 4
    n_bytes += _tensor_bytes(scene.mat_attrs, scene.light_attrs,
                             scene.light_cdf)
    below_c = torch.clamp_min(cc - 1, 0)   # s1, t0 and t1's columns
    below_l = torch.clamp_min(lc - 1, 0)
    items = {"s1": int(below_l.sum()), "t0": int(below_c.sum()),
             "t1": int((below_c * (lc >= 1)).sum()),
             "gen": sum(int(((cc >= s) * below_l).sum())
                        for s in range(2, k + 1))}
    # vertex m's walk reads columns 0 .. m
    walk = sum(int((torch.clamp_min(c - 1, 0) * (c + 2) // 2).sum())
               for c in (cc, lc))
    n_ok = int(ok.sum())
    parts = {"stage": int((below_c + below_l).sum()), "walk": walk,
             **items, "ok": n_ok, "kept": int(live.sum())}
    instr = sum(x * (CONNECT_OPS[r][0] + CONNECT_COL_OPS.get(r, 0) * g
                     + DIV_INSTR * (CONNECT_OPS[r][1] + CONNECT_OPS[r][2]))
                for r, x in parts.items())
    instr += PHILOX_INSTR * (n_ok - int(ok[g:2 * g].sum()))
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = instr / INT_OPS * 1e3
    return {"bound_ms": max(tb, to), "bound_by":
            "bytes" if tb >= to else "operations", "bytes": n_bytes,
            "items": sum(items.values()), "items_by_round": items,
            "valid": n_ok, "instructions": instr, "bytes_ms": tb,
            "operations_ms": to}


def connect_valid(kw) -> torch.Tensor:
    """The queue's flags of connect_torch on the arguments kw with the
    shadow roulette off: the items valid before it, which take its mean
    and draw."""
    from gpu_pathtracer_tpu_torch.integrators import bdpt_shade as bs
    rr = bs.CONNECT_RR
    bs.CONNECT_RR = 0.0
    try:
        return bs.connect_torch(**{**kw, "rays": None, "plain": True})[1].live
    finally:
        bs.CONNECT_RR = rr


def bdpt_finish_bound(q, shadow, n_pix) -> dict:
    """bdpt_finish's least time on one call, bytes over 3.35 TB/s: every
    slot's flag, each live slot's credit and verdict (and s1's pixel),
    the lane's radiance in and out, the film written once (the kernel
    reads a slot's credit and verdict only where it is live, as whole
    float4s and words of four lanes: the sectors it moves are more)."""
    live = q.live
    n = live.shape[1]
    nl = int(live.sum())
    n_bytes = live.numel() + nl * (12 + shadow.element_size()
                                   * (1 if shadow.dim() == 1 else 3))
    n_bytes += int(live[:q.pix.shape[0]].sum()) * 4 + n * 24 + n_pix * 12
    b = bound(n_bytes, 0)
    b["bytes"] = n_bytes
    return b


def per_round_walks(scene, static, lanes, q, tr) -> int:
    """The queue's Tr in one walk (tr) against a walk per round, as the
    rounds walked before: the slots of round p drawing at track_tag(p,
    site). Returns the slots whose Tr is not bit-equal."""
    from gpu_pathtracer_tpu_torch.core.rng import (
        TRACK_CAMERA, TRACK_CONNECT, track_tag)
    from gpu_pathtracer_tpu_torch.integrators import bdpt_shade as bs
    from gpu_pathtracer_tpu_torch.integrators.common import (
        shadow_transmittance)
    from gpu_pathtracer_tpu_torch.shade.media import TrackKey
    n, g = lanes.shape[0], q.pix.shape[0]
    bad = 0
    for p, site, j0 in [(1, TRACK_CAMERA, 0), (3, TRACK_CONNECT, g)] + [
            (4 + s - 2, TRACK_CONNECT, bs.slot0("gen", g, s))
            for s in range(2, g + 2)]:
        sel = q.live[j0:j0 + g].reshape(-1).nonzero()[:, 0]
        flat = j0 * n + sel
        items = lanes.long()[sel % n] * bs.ITEM_LANES + sel // n
        tr_p, _ = shadow_transmittance(
            scene, static, q.med.reshape(-1)[flat], q.o.reshape(-1, 3)[flat],
            q.d.reshape(-1, 3)[flat], q.tmax.reshape(-1)[flat],
            TrackKey(SEED, 1, items, track_tag(p, site)),
            torch.ones(sel.shape[0], dtype=torch.bool, device=tr.device))
        bad += int((bits(tr[flat]) != bits(tr_p)).any(1).sum())
    return bad


def bound_args(fn, args, kwargs) -> dict:
    """The arguments of the call fn(*args, **kwargs) by name, defaults
    filled in."""
    import inspect
    a = inspect.signature(fn).bind(*args, **kwargs)
    a.apply_defaults()
    return dict(a.arguments)


def bdpt_step_check(step, a, seen, err) -> tuple:
    """One bdpt_step call (`step` on the bound arguments `a`) against
    step_torch on copies of its input (`emptied`): the tables below the
    count, the rows' state and the rays bit for bit. Differences go to
    seen["differ"], the largest error to err. Returns (counts and Walker
    before; counts and Walker after the plain step)."""
    from gpu_pathtracer_tpu_torch.integrators import bdpt_shade as bs
    v, w, s_ = a["v"], a["w"], a["step_"]
    vp, wp = emptied(v), copy_record(w)
    rays_p = a["rays"].clone()
    c0, w0 = v.count.clone(), copy_record(w)
    step(**a)
    bs.step_torch(**{**a, "v": vp, "w": wp, "rays": rays_p, "plain": True})
    d = {**tables_differ(v, vp),
         **{f"w.{f}": x for f, x in record_differ(
             w, wp, WALKER_FIELDS).items()},
         "rays": int(a["rays"] != rays_p)}
    below = torch.arange(vp.pos.shape[1], device=v.count.device)[None, :] \
        < vp.count[:, None]
    err["bdpt_step"] = max(err["bdpt_step"], max(
        (getattr(v, f)[below].float() - getattr(vp, f)[below].float())
        .abs().max().item() for f in ("pos", "beta", "fwd", "rev")))
    seen["steps"] += 1
    for f, x in d.items():
        if x:
            seen["differ"][f"step {s_} {f}"] = x
    return c0, w0, vp.count.clone(), copy_record(wp)


def bdpt_finish_check(finish, a, seen, err, label) -> tuple:
    """One bdpt_finish call (`finish` on the bound arguments `a`) against
    finish_torch: the radiance bit for bit (differences to
    seen["differ"]), the film within the radiance limits. Returns the
    kernel's (li, film)."""
    from gpu_pathtracer_tpu_torch.integrators import bdpt_shade as bs
    li_k, film_k = finish(**a)
    li_p, film_p = bs.finish_torch(a["li"], a["q"], a["shadow"], a["n_pix"])
    ne = int((bits(li_k) != bits(li_p)).any(1).sum())
    if ne:
        seen["differ"]["finish li"] = ne
    err["bdpt_finish"] = max(err["bdpt_finish"],
                             (li_k - li_p).abs().max().item())
    hold_radiance(label, "film", film_k, film_p)
    return li_k, film_k


def bdpt_checked(label, run) -> None:
    """run() (a BDPT sample over the kernels) with each bdpt_step call held
    to step_torch (bdpt_step_check) and bdpt_finish to finish_torch
    (bdpt_finish_check); fails on any difference."""
    from gpu_pathtracer_tpu_torch.integrators import bdpt_shade as bs
    err = {k: 0.0 for k in BDPT_KERNELS}
    seen = {"steps": 0, "differ": {}}
    orig = {k: getattr(bs, k) for k in ("step", "finish")}

    def step_spy(*args, **kwargs):
        bdpt_step_check(orig["step"], bound_args(orig["step"], args, kwargs),
                        seen, err)

    def finish_spy(*args, **kwargs):
        seen["finishes"] = seen.get("finishes", 0) + 1
        return bdpt_finish_check(orig["finish"],
                                 bound_args(orig["finish"], args, kwargs),
                                 seen, err, f"C bdpt_finish {label}")

    bs.step, bs.finish = step_spy, finish_spy
    try:
        run()
    finally:
        for k_, f in orig.items():
            setattr(bs, k_, f)
    torch.cuda.synchronize()
    print(f"[C] {label}: {seen['steps']} bdpt_step and "
          f"{seen.get('finishes', 0)} bdpt_finish calls held to step_torch "
          f"and finish_torch; not bit-equal: {seen['differ'] or 'none'}")
    check(seen["steps"] > 0 and seen.get("finishes", 0) > 0
          and not seen["differ"],
          f"{label}: bdpt.cu and its plain versions differ: "
          f"{seen['differ']}")


def step_alone(steps, card, records) -> dict:
    """bdpt_step's kernel alone (its entry point on the wrapper's
    structure, the rows' state and counts put back before each launch)
    at each step of cornell_port's sample (`steps`: phase T's {step:
    (arguments, counts, Walker before; counts, Walker after the plain
    step)}), against its recounted bound (bdpt_step_bound); with
    --baseline DIR, DIR's bdpt_step alone on the same states through its
    own wrapper, in turns. Every step runs on the sample's final tables
    with its own counts: a step reads only slots below them."""
    from gpu_pathtracer_tpu_torch.integrators import bdpt_shade as bs
    pbs = baseline_module("bdpt", "T") if BASELINE else None
    out = {}
    for s_, (a, c0, w0, c1, w1) in sorted(steps.items()):
        v = a["v"]
        kw = {k: x for k, x in a.items() if k not in ("v", "w", "plain")}
        fns = {}
        for side, mod in (("parent", pbs), ("this", bs)):
            if mod is None:
                continue
            w = copy_record(w0)
            v.count.copy_(c0)
            restore = restorer(v, w)
            _, run = bare_entry(mod, "bdpt_step",
                                lambda: mod.step_cuda(**kw, v=v, w=w))
            fns[side] = (run, restore)
        t = timed_alone(fns)
        ms = {k: sum(x) / len(x) for k, x in t.items()}
        bd = bdpt_step_bound(a["static"], (c0, w0), (c1, w1), a["prim"])
        out[s_] = {"ms": ms["this"], "turns": t["this"], "bound": bd,
                   **({"baseline_ms": ms["parent"]} if pbs else {})}
        print(f"[T] bdpt_step alone at cornell_port's step {s_} "
              f"({bd['rows']} rows of {2 * N_RAYS}): {ms['this']:.4f} ms "
              f"(turns {', '.join(f'{x:.4f}' for x in t['this'])})"
              + (f", {BASELINE} {ms['parent']:.4f} ms (turns "
                 f"{', '.join(f'{x:.4f}' for x in t['parent'])})"
                 if pbs else "")
              + f"; bound {bd['bound_ms']:.4f} ms ({bd['bytes']} bytes) "
              f"({card})")
    spp = {"ms": sum(x["ms"] for x in out.values()),
           "bound_ms": sum(x["bound"]["bound_ms"] for x in out.values())}
    line = (f"[T] bdpt_step alone over cornell_port's sample "
            f"({len(out)} steps): {spp['ms']:.4f} ms, bound "
            f"{spp['bound_ms']:.4f} ms ({spp['ms'] / spp['bound_ms']:.2f}x)")
    if pbs:
        spp["baseline_ms"] = sum(x["baseline_ms"] for x in out.values())
        line += f", {BASELINE} {spp['baseline_ms']:.4f} ms"
    print(f"{line} ({card})")
    from gpu_pathtracer_tpu_torch import kernels
    regs = ptxas_regs(kernels.BUILDS["bdpt"].ptxas, "bdpt_step_kernel")
    print(f"[T] bdpt_step: registers {regs}, blocks of 128 an SM "
          f"{sorted({occupancy(r) for r in regs})}")
    records["bdpt_step"].update(
        spp=spp, registers=regs,
        by_step={s_: {k: x[k] for k in ("ms", "baseline_ms") if k in x}
                 | {"bound_ms": x["bound"]["bound_ms"],
                    "rows": x["bound"]["rows"]} for s_, x in out.items()})
    return out


def phase_t(dev, card, records):
    """csrc/bdpt.cu against its plain versions on the same inputs, for each
    BDPT_CASES case at 1M lanes: one BDPT sample over the kernels, each
    bdpt_step call against step_torch on a copy of its input (`emptied`;
    the tables below the count and the rows' state after it, bit for
    bit), bdpt_connect against
    connect_torch (the t0 radiance and the queue bit for bit, the queued
    rays equal), bdpt_finish against finish_torch (the radiance bit for
    bit, the film within the radiance limits); on smoke_port the queue's
    one Tr walk against a walk per round (bit for bit); then each kernel,
    its plain version and its bound in turns on cornell_port's inputs
    (step 1, the connections, the finish)."""
    from gpu_pathtracer_tpu_torch import kernels
    from gpu_pathtracer_tpu_torch.integrators import bdpt, bdpt_shade as bs
    from gpu_pathtracer_tpu_torch.run.reference import reset_counts
    print(f"[T] bdpt.cu: {ptxas_summary(kernels.BUILDS['bdpt'].ptxas)}")
    t0 = time.time()
    err = {k: 0.0 for k in BDPT_KERNELS}
    timed = {}
    orig = {k: getattr(bs, k) for k in ("start", "step", "connect",
                                        "finish")}
    for label, path, depth, n_lanes in BDPT_CASES:
        sc, st = bdpt_scene(path, dev, depth)
        ids = torch.arange(n_lanes, device=dev)
        px, py = ids % st.width, ids // st.width
        lanes = (py.long() * st.width + px.long())
        n_pix = st.width * st.height
        seen = {"steps": 0, "differ": {}}
        keep = path == SCENES[0] and depth == 5

        def start_spy(*args, **kwargs):
            a = bound_args(orig["start"], args, kwargs)
            v, w = orig["start"](*args, **kwargs)
            vp, wp = bs.start_torch(**{**a, "plain": True})
            d = {**tables_differ(v, vp),
                 **{f"w.{f}": x for f, x in record_differ(
                     w, wp, WALKER_FIELDS).items()}}
            for f, x in d.items():
                if x:
                    seen["differ"][f"start {f}"] = x
            err["bdpt_start"] = max(err["bdpt_start"], max(
                (getattr(w, f).float() - getattr(wp, f).float()).abs()
                .max().item() for f in ("ro", "rd", "beta", "forward")))
            if keep:
                timed["start"] = a
            return v, w

        def step_spy(*args, **kwargs):
            a = bound_args(orig["step"], args, kwargs)
            got = bdpt_step_check(orig["step"], a, seen, err)
            if keep:   # the state at the step's start, for its bound
                timed.setdefault("steps", {})[a["step_"]] = (a, *got)

        def connect_spy(*args, **kwargs):
            a = bound_args(orig["connect"], args, kwargs)
            rays_p = a["rays"].clone()
            li_k, q_k = orig["connect"](*args, **kwargs)
            li_p, q_p = bs.connect_torch(**{**a, "v": emptied(a["v"]),
                                            "rays": rays_p, "plain": True})
            d = {"li": int((bits(li_k) != bits(li_p)).any(1).sum()),
                 **queue_differ(q_k, q_p), "rays": int(a["rays"] != rays_p)}
            for f, x in d.items():
                if x:
                    seen["differ"][f"connect {f}"] = x
            err["bdpt_connect"] = max(err["bdpt_connect"],
                                      (li_k - li_p).abs().max().item())
            seen["live"] = int(q_k.live.sum())
            seen["slots"] = q_k.live.numel()
            if keep:
                timed["connect"] = a
            return li_k, q_k

        def finish_spy(*args, **kwargs):
            a = bound_args(orig["finish"], args, kwargs)
            li_k, film_k = bdpt_finish_check(orig["finish"], a, seen, err,
                                             f"T bdpt_finish {label}")
            if st.has_media:
                bad = per_round_walks(sc, st, lanes, a["q"], a["shadow"])
                print(f"[T] {label}: the queue's one Tr walk vs a walk per "
                      f"round, slots not bit-equal: {bad}")
                check(bad == 0, f"{label}: one walk and the per-round walks "
                      "differ")
            if keep:
                timed["finish"] = a
            return li_k, film_k

        reset_counts(bs.START_STATS, bs.STATS, bs.CONNECT_STATS,
                     bs.FINISH_STATS)
        bs.start, bs.step, bs.connect, bs.finish = (
            start_spy, step_spy, connect_spy, finish_spy)
        try:
            li, film, rays = bdpt.render_lanes(sc, st, SEED, 1, px, py, True)
        finally:
            for k_, f in orig.items():
                setattr(bs, k_, f)
        torch.cuda.synchronize()
        n_steps = st.max_depth + (bdpt.INTERFACE_BUDGET if st.has_media
                                  else 0)
        counts = (bs.START_STATS, bs.STATS, bs.CONNECT_STATS,
                  bs.FINISH_STATS)
        print(f"[T] {label}: {seen['steps']} steps of {2 * n_lanes} rows, "
              f"{seen['live']} live of {seen['slots']} queue slots, rays "
              f"{int(rays)}; launches {[c.launches for c in counts]}, plain "
              f"calls {[c.plain_cuda for c in counts]}; not bit-equal: "
              f"{seen['differ'] or 'none'}")
        check(seen["steps"] == n_steps, f"{label}: {seen['steps']} steps")
        check([c.launches for c in counts] == [1, n_steps, 1, 1]
              and [c.plain_cuda for c in counts] == [1, n_steps, 1, 1],
              f"{label}: launches {counts}")
        check(not seen["differ"], f"{label}: bdpt.cu and its plain versions "
              f"differ: {seen['differ']}")
        check(bool(torch.isfinite(li).all()) and li.mean().item() > 0
              and film.sum().item() > 0, f"{label}: radiance {li.mean()}")
        del li, film

    steps = step_alone(timed["steps"], card, records)
    a, c0, w0 = timed["steps"][1][:3]
    plain = {"v": emptied(a["v"]), "w": copy_record(w0)}
    plain["v"].count.copy_(c0)
    kw = {k: x for k, x in a.items() if k not in ("v", "w", "plain")}
    t = timed_restored({
        "step plain": (lambda: bs.step_torch(**kw, **plain, plain=True),
                       restorer(plain["v"], plain["w"]))})
    t["step kernel"] = steps[1]["turns"]
    ck = {k: x for k, x in timed["connect"].items() if k != "plain"}
    ck_plain = {**ck, "v": emptied(ck["v"])}
    fk = timed["finish"]
    sk = {k: x for k, x in timed["start"].items() if k != "plain"}
    t.update(timed_windows({
        "start kernel": lambda: bs.start_cuda(**sk),
        "start plain": lambda: bs.start_torch(**sk, plain=True),
        "connect kernel": lambda: bs.connect_cuda(**ck),
        "connect plain": lambda: bs.connect_torch(**ck_plain, plain=True),
        "finish kernel": lambda: bs.finish_cuda(
            fk["li"], fk["q"], fk["shadow"], fk["n_pix"]),
        "finish plain": lambda: bs.finish_torch(
            fk["li"], fk["q"], fk["shadow"], fk["n_pix"])}))
    ms = {k: sum(x) / len(x) for k, x in t.items()}
    sc, st = bdpt_scene(SCENES[0], dev)
    q = bs.connect_cuda(**ck)[1]
    bounds = {"start": bdpt_start_bound(*bs.start_cuda(**sk), sk["lanes"],
                                        sc),
              "step": steps[1]["bound"],
              "connect": bdpt_connect_bound(sc, st, ck["v"], q,
                                            connect_valid(ck_plain), N_RAYS),
              "finish": bdpt_finish_bound(fk["q"], fk["shadow"],
                                          fk["n_pix"])}
    where = {"start": "the start", "step": "step 1",
             "connect": "the connection rounds",
             "finish": "the queued credits"}
    for name in ("start", "step", "connect", "finish"):
        b = bounds[name]
        kt, pt_ = t[f"{name} kernel"], t[f"{name} plain"]
        print(f"[T] bdpt_{name} on cornell_port ({N_RAYS} lanes, "
              f"{where[name]}): kernel {ms[name + ' kernel']:.4f} ms (turns "
              f"{min(kt):.4f}-{max(kt):.4f}), plain {ms[name + ' plain']:.4f} "
              f"ms (turns {min(pt_):.4f}-{max(pt_):.4f}); bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes']} bytes"
              + (f", {b['items']} items {b['items_by_round']}, "
                 f"{b['valid']} valid before the roulette: bytes "
                 f"{b['bytes_ms']:.4f} ms, {b['instructions']} "
                 f"instructions {b['operations_ms']:.4f} ms"
                 if "items" in b else "")
              + f") ({card})")
        records[f"bdpt_{name}"].update(
            max_abs_err=err[f"bdpt_{name}"], ms=ms[name + " kernel"],
            plain_ms=ms[name + " plain"], bound_ms=b["bound_ms"],
            bound_by=b["bound_by"], library_ms=None, bound_bytes=b["bytes"])
    b = bounds["connect"]
    occ = {f"k{k}": bs.connect_occupancy(k) for k in (6, DEEP + 1)}
    print(f"[T] bdpt_connect's launch shape (occupancy API) at K = 6 and "
          f"K = {DEEP + 1}: {occ}; ncu does not run on this machine")
    records["bdpt_connect"].update(
        bound_bytes_ms=b["bytes_ms"], bound_operations_ms=b["operations_ms"],
        bound_instructions=b["instructions"], occupancy=occ,
        ptxas=ptxas_summary(kernels.BUILDS["bdpt"].ptxas,
                            "bdpt_connect_kernel"))
    fin = finish_alone(fk, card)
    records["bdpt_finish"].update(wrapper_ms=ms["finish kernel"],
                                  ms=fin["this"], registers=fin["registers"])
    if "parent" in fin:
        records["bdpt_finish"]["baseline_ms"] = fin["parent"]
    if BASELINE:
        baseline_connect(ck, card, records)
    print(f"[T] done in {time.time() - t0:.1f} s")


def finish_alone(fk, card) -> dict:
    """bdpt_finish's kernel alone (its entry point on the wrapper's
    structure, the film zeroed before each launch: `timed_alone`) on
    cornell_port's queue (`fk`: phase T's arguments); with --baseline
    DIR, DIR's bdpt_finish (its bdpt.cu built here, launched through this
    checkout's wrapper: the argument structure is the same) on the same
    queue in turns, its radiance bit for bit and its film within the
    radiance limits of this one's. Returns {side: ms} and the registers
    of the variant that ran."""
    import re
    from gpu_pathtracer_tpu_torch import kernels
    from gpu_pathtracer_tpu_torch.integrators import bdpt_shade as bs
    args = (fk["li"], fk["q"], fk["shadow"], fk["n_pix"])
    libs = {"this": kernels._LIBS["bdpt"]}
    if BASELINE:
        libs["parent"] = baseline_library("bdpt")[0]
    fns, outs = {}, {}
    for side, lib in libs.items():
        kernels._LIBS["bdpt"] = lib
        try:
            outs[side], run = bare_entry(bs, "bdpt_finish",
                                         lambda: bs.finish_cuda(*args))
        finally:
            kernels._LIBS["bdpt"] = libs["this"]
        fns[side] = (run, outs[side][1].zero_)
    if "parent" in outs:
        (li_k, film_k), (li_p, film_p) = outs["this"], outs["parent"]
        ne = int((bits(li_k) != bits(li_p)).any(1).sum())
        print(f"[T] bdpt_finish of {BASELINE} vs this checkout on "
              f"cornell_port's {N_RAYS} lanes: li lanes not bit-equal {ne}")
        check(ne == 0, f"bdpt_finish's li differs from {BASELINE}'s")
        hold_radiance("T bdpt_finish vs the baseline", "film", film_k,
                      film_p)
    t = timed_alone(fns)
    ms = {k: sum(x) / len(x) for k, x in t.items()}
    lanes = 4 if N_RAYS % 4 == 0 else 1
    variant = (f"bdpt_finish_kernel (lanes {lanes}, verdicts "
               f"{int(fk['shadow'].dtype == torch.bool)})")
    rep = ptxas_summary(kernels.BUILDS["bdpt"].ptxas, variant)
    regs = [int(x) for x in re.findall(r"(\d+) registers", rep)]
    print(f"[T] bdpt_finish alone on cornell_port ({N_RAYS} lanes, "
          f"{fk['q'].live.numel()} slots): {ms['this']:.4f} ms (turns "
          f"{', '.join(f'{x:.4f}' for x in t['this'])})"
          + (f", {BASELINE} {ms['parent']:.4f} ms (turns "
             f"{', '.join(f'{x:.4f}' for x in t['parent'])})"
             if "parent" in ms else "")
          + f"; {rep}; a thread {lanes} lanes, blocks of 128 threads, "
          f"{sorted({occupancy(r) for r in regs})} an SM ({card})")
    return {**ms, "registers": regs}


def baseline_library(name: str):
    """csrc/<name>.cu of the checkout at BASELINE, built with this
    checkout's nvcc flags into build/ and loaded: (the library, its
    ptxas report). Its entry points take the same argument structures."""
    import ctypes
    import hashlib
    from gpu_pathtracer_tpu_torch import kernels
    if name in _BASELINE_LIBS:   # built: a fresh handle (its own argtypes)
        so, report = _BASELINE_LIBS[name]
        return ctypes.CDLL(so), report
    src = os.path.join(BASELINE, "gpu_pathtracer_tpu_torch", "csrc",
                       f"{name}.cu")
    check(os.path.exists(src), f"--baseline: no {src}")
    h = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    so = os.path.join(REPO, "build", f"baseline_{name}-{h}.so")
    p = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True)
    check(p.returncode == 0, f"nvcc failed on {src}:\n{p.stderr[-3000:]}")
    _BASELINE_LIBS[name] = (so, p.stderr)
    return ctypes.CDLL(so), p.stderr


_BASELINE_LIBS = {}   # name -> (library path, ptxas report): built once


def baseline_connect(ck, card, records):
    """bdpt_connect of the checkout at BASELINE (its bdpt.cu, built here,
    launched through this checkout's wrapper: the argument structure is
    the same) against this checkout's on phase T's cornell_port inputs:
    the t0 radiance and the queue bit for bit, then both timed in turns
    (parent, this, this, parent, twice)."""
    from gpu_pathtracer_tpu_torch import kernels
    from gpu_pathtracer_tpu_torch.integrators import bdpt_shade as bs
    lib, ptxas = baseline_library("bdpt")
    print(f"[T] bdpt_connect of {BASELINE}: "
          f"{ptxas_summary(ptxas, 'bdpt_connect_kernel')}")
    ours = kernels._LIBS["bdpt"]

    def parent():
        kernels._LIBS["bdpt"] = lib
        try:
            return bs.connect_cuda(**ck)
        finally:
            kernels._LIBS["bdpt"] = ours

    li_p, q_p = parent()
    li_k, q_k = bs.connect_cuda(**ck)
    d = {"li": int((bits(li_k) != bits(li_p)).any(1).sum()),
         **queue_differ(q_k, q_p)}
    print(f"[T] bdpt_connect of {BASELINE} vs this checkout on "
          f"cornell_port's {N_RAYS} lanes, not bit-equal: "
          f"{ {f: x for f, x in d.items() if x} or 'none'}")
    check(not any(d.values()), f"bdpt_connect differs from {BASELINE}'s")
    del li_p, q_p, li_k, q_k
    t = {"parent": [], "this": []}
    for _ in range(2):
        for k_, x in timed_windows({"parent": parent, "this": lambda:
                                    bs.connect_cuda(**ck)}).items():
            t[k_] += x
    for k_, x in t.items():
        print(f"[T] bdpt_connect of {BASELINE if k_ == 'parent' else REPO} "
              f"on cornell_port's {N_RAYS} lanes: {sum(x) / len(x):.4f} ms "
              f"(windows {', '.join(f'{y:.4f}' for y in x)}) ({card})")
    records["bdpt_connect"].update(
        baseline_ms=sum(t["parent"]) / len(t["parent"]),
        ms_in_turns=sum(t["this"]) / len(t["this"]))


def phase_d(dev, card, records):
    """The main path through the CLI: the Cornell box at 1024^2, depth 5,
    which pt.render_lanes routes to K2; launch counts, spp/s, Mrays/s, and
    the radiance against the plain version's lane by lane."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        close_frac, kernel_stats, reset_counts)
    from gpu_pathtracer_tpu_torch.integrators import pt_fused
    from gpu_pathtracer_tpu_torch.run import cli

    def render(spp, name):
        out = os.path.join(OUT, name)
        return cli.main([os.path.join(REPO, SCENES[0]), "--spp", str(spp),
                         "--out", out, "--seed", str(SEED)]), out

    render(1, "warmup.png")                     # the warm-up spp
    stats = kernel_stats()
    reset_counts(*stats.values())
    res, png = render(8, "cornell_port.png")
    counts = {k: st.launches for k, st in stats.items()}
    plain = sum(st.plain_cuda for st in stats.values())
    k2_n, k1_n = counts["pt_fused"], counts["dense_hit"]
    records["pt_fused"]["launches"] = k2_n
    records["dense_hit"]["launches"] = k1_n
    print(f"[D] cornell_port through K2: {res['spp']} spp of 1024x1024 "
          f"depth 5 in {res['seconds']:.6f} s through the CLI")
    print(f"[D] launches in the main-path run: {counts}; plain-version "
          f"calls on CUDA tensors: {plain}")
    check(k2_n > 0, "main path never launched K2")
    check(only(counts, "pt_fused", "rng"), f"main path launched {counts}")
    records["rng"]["launches"] = counts["rng"]
    check(plain == 0, f"{plain} plain-version calls on CUDA in phase D")

    r = res["renderer"]
    rad = r.radiance()
    img = r.image()
    check(rad.shape == (1024, 1024, 3) and img.shape == (1024, 1024, 3),
          f"image shape {rad.shape}")
    check(bool(np.isfinite(rad).all() and np.isfinite(img).all()),
          "non-finite image")
    check(os.path.getsize(png) > 0, "PNG not written")
    # the plain version at the same seed and iterations, lane by lane
    acc = torch.zeros_like(r.acc)
    for it in range(1, r.iteration + 1):
        acc += pt_fused.render_lanes_torch(r.device_scene, r.static, SEED, it,
                                           r._px, r._py)
    li_k, li_p = r.acc / r.iteration, acc / r.iteration
    frac = close_frac(li_k, li_p)
    exact = (li_k == li_p).all(1).float().mean().item()
    err = (li_k - li_p).abs().max().item()
    ratio = li_k.double().mean().item() / li_p.double().mean().item()
    records["pt_fused"]["max_abs_err"] = max(
        records["pt_fused"].get("max_abs_err", 0.0), err)
    print(f"[D] radiance vs plain version, {li_k.shape[0]} lanes x "
          f"{r.iteration} spp: agree {frac:.6f} (differ {1 - frac:.6f}, "
          f"bit-equal {exact:.6f}), max abs err {err:.3e}, mean ratio "
          f"{ratio:.7f}; wrote {png}")
    check(frac >= 0.99, f"main path: agree on {frac}")
    check(abs(ratio - 1.0) <= 1e-3, f"main path: mean ratio {ratio}")

    # the rate, as the bench measures it, from where the render stands
    print(f"[D] cornell_port through K2: {rate(r)} ({card})")

    import shutil
    from gpu_pathtracer_tpu_torch.geom import bvh
    for key, kname, spp in (("env", "pt_fused", 8),
                            ("textured", "pt_fused", 8),
                            ("scene", "bvh8_walk", 8),
                            ("forest", "bvh8_walk", 2),
                            ("blocked", "blocked", 2)):
        if key == "forest":   # its host build on an emptied cache (the
            shutil.rmtree(bvh.cache_dir())   # BLAS are cached, the TLAS not)
        builds = main_path(key, kname, spp, card, records,
                           capture={"blocked": capture_main_k3,
                                    "scene": capture_main_k4}.get(key))
        if key == "forest":
            print(f"[D] {KNOT[key]} host build: cold {builds[0]:.3f} s, "
                  f"BVH cache hit {builds[1]:.3f} s")
            records["bvh8_walk"].update(forest_build_cold_s=builds[0],
                                        forest_build_cached_s=builds[1])
    knot_sky_main_path(card, records)
    vpt_main_path(card, records)
    for integ, path, spp, kname in PROGRAMS_D:
        program_main_path(card, records, integ, path, spp, kname)


def knot_sky_main_path(card, records):
    """knot_port/sky.json through K4: its main path with the host build
    timed cold (the warm-up run, on an emptied BVH cache) and on a cache
    hit (the timed run), and both BVH builders alone on its prims."""
    import shutil
    from gpu_pathtracer_tpu_torch.geom import bvh, bvh_native
    from gpu_pathtracer_tpu_torch.scene import flatten
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    shutil.rmtree(bvh.cache_dir())
    stamps = []   # the cache's files after the cold and the cached run
    builds = main_path("sky", "bvh8_walk", 2, card, records,
                       after_build=lambda: stamps.append(sorted(
                           (f, os.path.getmtime(os.path.join(bvh.cache_dir(),
                                                             f)))
                           for f in os.listdir(bvh.cache_dir()))))
    host = load_scene(os.path.join(REPO, KNOT["sky"]))
    bmin, bmax = flatten._prim_bboxes(host, flatten._prim_fields(host))
    t0 = time.perf_counter()
    nb = bvh_native.build_bvh_native(bmin, bmax)
    t1 = time.perf_counter()
    pb = bvh.build_bvh_numpy(bmin, bmax)
    t2 = time.perf_counter()
    print(f"[D] {KNOT['sky']} host build: cold {builds[0]:.3f} s, BVH cache "
          f"hit {builds[1]:.3f} s; on its {bmin.shape[0]} prims the native "
          f"BVH builder takes {t1 - t0:.3f} s ({nb.n_nodes} nodes), the "
          f"numpy builder {t2 - t1:.3f} s ({pb.n_nodes} nodes)")
    check(len(stamps[0]) == 1 and stamps[1] == stamps[0],
          f"{KNOT['sky']}: the cold run should write one cached BVH and the "
          f"second read it: {stamps}")
    records["bvh8_walk"].update(
        sky_build_cold_s=builds[0], sky_build_cached_s=builds[1],
        sky_bvh_native_s=t1 - t0, sky_bvh_numpy_s=t2 - t1)


def main_path(key, kname, spp, card, records, after_build=None,
              capture=None):
    """A main path through the CLI (a knot scene of KNOT or a K2 variant's
    scene of K2_VARIANTS): one warm-up spp, held against the plain
    wavefront on every lane, then `spp` timed spp whose launches must
    all be kernel `kname`'s. Returns the host build seconds of the two
    runs; `after_build()` is called after each, `capture()` wraps the
    warm-up spp (it returns the function that ends the capture)."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        close_frac, kernel_stats, reset_counts)
    from gpu_pathtracer_tpu_torch.integrators import pt
    from gpu_pathtracer_tpu_torch.run import cli
    label = KNOT.get(key) or K2_VARIANTS[key]
    path = os.path.join(REPO, label)
    stats = kernel_stats()

    def render(n, name):
        return cli.main([path, "--spp", str(n), "--seed", str(SEED),
                         "--out", os.path.join(OUT, name)])

    name = f"knot_{key}" if key in KNOT else key
    release = capture() if capture else (lambda: None)
    try:
        warm = render(1, f"{name}_1spp.png")
    finally:
        release()
    if after_build:
        after_build()
    r = warm["renderer"]
    li_p = pt.wavefront(r.device_scene, r.static, SEED, 1, r._px, r._py,
                        plain=True)
    li_k = r.acc
    frac = close_frac(li_k, li_p)
    ratio = li_k.double().mean().item() / li_p.double().mean().item()
    err = (li_k - li_p).abs().max().item()
    print(f"[D] {label} warm-up spp vs plain wavefront: {li_k.shape[0]} "
          f"lanes, agree {frac:.6f} (bit-equal "
          f"{(li_k == li_p).all(1).float().mean().item():.6f}), max abs err "
          f"{err:.3e}, mean ratio {ratio:.7f}")
    check(frac >= 0.99, f"{key} main path: agree on {frac}")
    check(abs(ratio - 1.0) <= 1e-3, f"{key} main path: mean ratio {ratio}")
    build_warm = warm["build_seconds"]
    del warm, r, li_p, li_k

    reset_counts(*stats.values())
    res = render(spp, f"{name}.png")
    counts = {k: st.launches for k, st in stats.items()}
    if after_build:
        after_build()
    plain = sum(st.plain_cuda for st in stats.values())
    img = res["renderer"].image()
    check(img.shape == (1024, 1024, 3) and bool(np.isfinite(img).all()),
          f"{key}: image {img.shape}, finite {np.isfinite(img).all()}")
    print(f"[D] {label} through {kname}: {spp} spp of 1024x1024 depth "
          f"{res['renderer'].static.max_depth} in {res['seconds']:.6f} s, "
          f"then {rate(res['renderer'])}, host build "
          f"{res['build_seconds']:.2f} s ({card}); launches {counts}, "
          f"plain-version calls on CUDA {plain}")
    knames = (kname, "pt_shade") if key in KNOT else (kname,)
    check(counts[kname] > 0, f"{key}: main path never launched {kname}")
    check(only(counts, *knames, "rng"), f"{key}: main path launched {counts}")
    check(plain == 0, f"{key}: {plain} plain-version calls on CUDA")
    field = ("launches" if key in ("scene", "blocked") else
             "launches_instanced" if key == "forest" else f"launches_{key}")
    records[kname][field] = counts[kname]
    if key in KNOT:
        records["pt_shade"]["launches" if key == "scene"
                            else f"launches_{key}"] = counts["pt_shade"]
    records["rng"][f"launches_{name}"] = counts["rng"]
    return build_warm, res["build_seconds"]


def phase_e(dev, rng, card, records):
    """Kernel vs plain version times at the main path's shapes, each in
    windows of about one second, in turns."""
    from gpu_pathtracer_tpu_torch.core.rng import PSS_CAM_DIMS, lane_stream
    from gpu_pathtracer_tpu_torch.geom import dense, dense_cuda
    from gpu_pathtracer_tpu_torch.integrators import pt, pt_fused
    from gpu_pathtracer_tpu_torch.integrators.common import primary_rays
    from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    scene, static = flatten_scene(load_scene(os.path.join(REPO, SCENES[0])),
                                  dev)
    n = 1 << 20
    ro, rd, tmin, tmax = random_rays(rng, n, dev)
    table = scene.dense_prims
    kinds = dense.kinds_of(static)   # triangles only: the main path's variant
    HIT_INPUTS["K1 cornell_port 1M random"] = hit_call(
        "K1", SCENES[0], table, ro, rd, tmin, tmax)
    t1 = timed_windows({
        "kernel": lambda: dense_cuda.dense_hit_cuda(table, ro, rd, tmin,
                                                    tmax, False, kinds),
        "plain": lambda: dense.dense_closest_torch(table, ro, rd, tmin,
                                                   tmax, kinds)})
    # K2 alone on the main path's primary rays (one spp of 1024^2), its
    # plain version from the same rays, and the camera that makes them
    ids = torch.arange(n, device=dev, dtype=torch.int32)
    px, py = ids % static.width, ids // static.width
    lanes = pt.lane_ids_of(static, px, py)

    def camera():
        rng0 = lane_stream(SEED, 1, lanes, None, 0, PSS_CAM_DIMS)
        return primary_rays(scene, static, rng0, px, py)

    p_ro, p_rd = camera()
    lanes32 = lanes.to(torch.int32)
    t2 = timed_windows({
        "kernel": lambda: pt_fused.fused_call(scene, static, SEED, 1,
                                              lanes32, p_ro, p_rd),
        "plain": lambda: pt.trace_paths(scene, static, SEED, 1, lanes, p_ro,
                                        p_rd, plain=True),
        "camera": camera})
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    span = lambda v: f"{min(v):.4f}-{max(v):.4f}"  # noqa: E731
    print(f"[E] K1 closest hit, 1M rays, cornell_port table: kernel "
          f"{mean(t1['kernel']):.4f} ms (windows {span(t1['kernel'])}), "
          f"plain {mean(t1['plain']):.4f} ms ({span(t1['plain'])}) ({card})")
    print(f"[E] K2 alone, one spp of 1024x1024 depth 5 from given primary "
          f"rays: kernel {mean(t2['kernel']):.4f} ms (windows "
          f"{span(t2['kernel'])}), plain {mean(t2['plain']):.4f} ms "
          f"({span(t2['plain'])}); camera (rng.cu + plain rays, both routes) "
          f"{mean(t2['camera']):.4f} ms ({span(t2['camera'])}) ({card})")
    # bounds (RAY_IO: 32 B of ray in, 8 B of hit out; row_flops per ray:
    # one test of each prim by its type): K1 tests every prim; K2 every
    # prim per ray it traced
    fl = row_flops(table)
    b_k1 = bound(n * RAY_IO + table.numel() * 4, n * fl)
    _, k2_rays = pt_fused.fused_call(scene, static, SEED, 1, lanes32, p_ro,
                                     p_rd)
    k2_rays = int(k2_rays.sum())
    b_k2 = bound(n * 44 + table.numel() * 4 + scene.prim_attrs.numel() * 4,
                 k2_rays * fl)
    print(f"[E] bounds: K1 {b_k1['bound_ms']:.4f} ms by {b_k1['bound_by']};"
          f" K2 {b_k2['bound_ms']:.4f} ms by {b_k2['bound_by']} ({k2_rays} "
          f"rays x {fl} flops over {static.n_primitives} prims)")
    records["dense_hit"].update(ms=mean(t1["kernel"]),
                                plain_ms=mean(t1["plain"]), **b_k1,
                                library_ms=None)
    records["pt_fused"].update(ms=mean(t2["kernel"]),
                               plain_ms=mean(t2["plain"]), **b_k2,
                               library_ms=None)

    HIT_INPUTS["K2 cornell_port one spp"] = hit_call(
        "K2", SCENES[0], table, p_ro, p_rd, lanes=lanes32)
    print(f"[E] K2 variant {variant_name(static)} is cornell_port's")

    # K2's other variants alone, each on its scene's primary rays; their
    # bounds add the sky map's and the texture atlas's bytes, read once
    for key, path in (*K2_VARIANTS.items(), ("materials", SCENES[1])):
        sc, st = flatten_scene(load_scene(os.path.join(REPO, path)), dev)
        v_ro, v_rd = primary_rays(
            sc, st, lane_stream(SEED, 1, lanes, None, 0, PSS_CAM_DIMS), px,
            py)
        v_ro, v_rd = v_ro.contiguous(), v_rd.contiguous()
        tv = timed_windows({
            "kernel": lambda: pt_fused.fused_call(sc, st, SEED, 1, lanes32,
                                                  v_ro, v_rd),
            "plain": lambda: pt.trace_paths(sc, st, SEED, 1, lanes, v_ro,
                                            v_rd, plain=True)})
        _, v_rays = pt_fused.fused_call(sc, st, SEED, 1, lanes32, v_ro, v_rd)
        v_rays = int(v_rays.sum())
        extra = ((sc.env_data.numel() * 4 if st.has_infinite else 0)
                 + (sc.tex_data.numel() if st.has_textures else 0))
        fv = row_flops(sc.dense_prims)
        bv = bound(n * 44 + sc.dense_prims.numel() * 4
                   + sc.prim_attrs.numel() * 4 + extra, v_rays * fv)
        HIT_INPUTS[f"K2 {key} one spp"] = hit_call(
            "K2", path, sc.dense_prims, v_ro, v_rd, lanes=lanes32)
        print(f"[E] K2 variant {variant_name(st)} alone, one spp of {path} "
              f"at 1024x1024 depth 5 from given primary rays: kernel "
              f"{mean(tv['kernel']):.4f} ms (windows {span(tv['kernel'])}), "
              f"plain {mean(tv['plain']):.4f} ms ({span(tv['plain'])}); "
              f"bound {bv['bound_ms']:.4f} ms by {bv['bound_by']} ({v_rays} "
              f"rays x {fv} flops over {st.n_primitives} prims, {extra} "
              f"bytes of sky and texels) ({card})")
        records["pt_fused"].update({
            f"ms_{key}": mean(tv["kernel"]),
            f"plain_ms_{key}": mean(tv["plain"]),
            f"bound_ms_{key}": bv["bound_ms"],
            f"bound_by_{key}": bv["bound_by"]})

    # K3 / K4 closest hit on each scene's 1M primary and bounce rays, each
    # beside its bound: the least work of K3's culling levels (k3_work),
    # of any walk of K4's table (k4_work), given the plain version's hits
    for key, kname, pair, rec in (
            ("blocked", "K3", k3_pair, "blocked"),
            ("scene", "K4 flat", k4_pair, "bvh8_walk"),
            ("forest", "K4 instanced", k4_pair, "bvh8_walk"),
            ("blocked", "K4 flat (K3's scene)", k4_pair, None)):
        scene, static = flat(key, dev)
        kern, plain = pair(scene, static)
        for set_name in ("primary", "bounce"):
            ro, rd, t_lo, t_hi, _ = knot_rays(key, dev, rng)[set_name]
            fns = {"kernel": lambda: kern(ro, rd, t_lo, t_hi, False)}
            if rec is not None:
                fns["plain"] = lambda: plain(ro, rd, t_lo, t_hi, False)
            t = timed_windows(fns, min_reps=1)
            line = (f"[E] {kname} closest hit, {KNOT[key]} 1M {set_name} "
                    f"rays: kernel {mean(t['kernel']):.4f} ms (windows "
                    f"{span(t['kernel'])})")
            if rec is None:
                print(line + f" ({card})")
                continue
            t_best = plain(ro, rd, t_lo, t_hi, False)[0]
            if rec == "blocked":
                b = k3_bound(scene, ro, rd, t_lo, t_hi, t_best)
                HIT_INPUTS[f"K3 blocked.json 1M {set_name}"] = hit_call(
                    "K3", KNOT[key], scene.dense_prims, ro, rd, t_lo, t_hi)
            else:
                b = k4_bound(scene.bvh8_table, scene.bvh8_aux,
                             static.bvh8_n_inst, ro, rd, t_lo, t_hi, t_best)
                HIT_INPUTS[f"{kname} {key} 1M {set_name}"] = hit_call(
                    "K4", KNOT[key], scene.bvh8_table, ro, rd, t_lo, t_hi)
            print(line + f", plain {mean(t['plain']):.4f} ms "
                  f"({span(t['plain'])}); bound {b['bound_ms']:.4f} ms by "
                  f"{b['bound_by']} ({b['work']}) ({card})")
            sfx = ("" if key != "forest" else "_instanced") + \
                ("" if set_name == "primary" else "_bounce")
            if key == "scene":
                v = walk_visits(scene.bvh8_table, ro, rd, t_lo, t_hi,
                                dense.kinds_of(static), static.bvh8_stack)
                print(f"[E] K4 {KNOT[key]} 1M {set_name} rays: "
                      f"{visits_line(v)}")
                records[rec][f"visits{sfx}"] = v
            records[rec].update({
                f"ms{sfx}": mean(t["kernel"]),
                f"plain_ms{sfx}": mean(t["plain"]),
                f"bound_ms{sfx}": b["bound_ms"],
                f"bound_by{sfx}": b["bound_by"]})
            if "per_ray" in b:
                records[rec][f"work{sfx}"] = b["per_ray"]
            records[rec]["library_ms"] = None
    phase_e_k3_main(dev, card, records)
    phase_e_k4_main(card, records)
    phase_e_media(dev, rng, card, records)
    if BASELINE:
        baseline_times(card)


def hit_call(kernel, spath, table, ro, rd, t0=None, t1=None,
             any_hit=False, lanes=None) -> dict:
    """A kernel call phase E times, saved for --baseline: K1, K3 or K4 (a
    hit query: the rays' interval t0..t1, closest or any hit) or K2
    (primary rays and their lane ids) on the scene at repo path `spath`,
    whose table (dense_prims, or bvh8_table for K4) a checkout must
    flatten to."""
    return {"kernel": kernel, "scene": spath, "table": table, "ro": ro,
            "rd": rd, "t0": t0, "t1": t1, "any_hit": any_hit,
            "lanes": lanes}


def baseline_times(card):
    """K1, K2, K3 and K4 of the checkout at BASELINE and of this one on the
    same calls (HIT_INPUTS, saved under build/), through the routes
    (geom/dense.py::dense_closest, geom/blocked.py::blocked_closest,
    geom/packet.py::walk_closest / walk_any, integrators/pt_fused.py::
    fused_call, whose signatures do not change), each checkout in a
    process of its own, in turns: baseline, this, this, baseline. K2's
    output (li and rays) must be bit-equal between the checkouts."""
    path = os.path.join(REPO, "build", "hit_inputs.pt")
    torch.save(HIT_INPUTS, path)
    torch.cuda.empty_cache()
    runs, digests = {}, {}
    for root in (BASELINE, REPO, REPO, BASELINE):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time-hits", path, root], capture_output=True,
                           text=True)
        check(p.returncode == 0, f"timing the kernels of {root} failed:\n"
              f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
        got = json.loads(p.stdout.splitlines()[-1])
        if got["ptxas"]:   # the checkout's first child builds its K2
            print(f"[E] K2 of {root}: {got['ptxas']}")
        for label, ms in got["ms"].items():
            runs.setdefault((root, label), []).extend(ms)
        for label, h in got["digest"].items():
            digests.setdefault(label, set()).add(h)
    os.unlink(path)
    for label, hs in digests.items():
        print(f"[E] {label}: K2's li and rays bit-equal between {BASELINE} "
              f"and this checkout: {len(hs) == 1}")
        check(len(hs) == 1, f"{label}: K2's output differs between the "
              "checkouts")
    for label, c in HIT_INPUTS.items():
        n = c["ro"].shape[0]
        live = n if c["t0"] is None else int((c["t1"] >= c["t0"]).sum())
        old, new = runs[(BASELINE, label)], runs[(REPO, label)]
        print(f"[E] {label} ({n} lanes, {live} live): baseline "
              f"{BASELINE} {sum(old) / len(old):.4f} ms (windows "
              f"{min(old):.4f}-{max(old):.4f}), this checkout "
              f"{sum(new) / len(new):.4f} ms ({min(new):.4f}-{max(new):.4f}) "
              f"({card})")


def time_hits(path, root):
    """The child of --baseline: time the K1, K2, K3 and K4 routes of the
    checkout at `root` on the calls saved at `path` (hit_call), on scenes
    that checkout flattens (their tables must equal the saved ones), in
    windows of about one second; prints {"ms": {label: [ms per window]},
    "digest": {label: sha256 of K2's li and rays}, "ptxas": K2's ptxas
    report where this process built it} as its last line."""
    import hashlib
    sys.path.insert(0, os.path.abspath(root))
    import gpu_pathtracer_tpu_torch
    from gpu_pathtracer_tpu_torch.geom import blocked, dense, packet
    from gpu_pathtracer_tpu_torch.integrators import pt_fused
    from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    pkg = os.path.dirname(os.path.dirname(gpu_pathtracer_tpu_torch.__file__))
    check(pkg == os.path.abspath(root), f"imported the package of {pkg}")
    dev = torch.device("cuda", 0)
    scenes, out, digest = {}, {}, {}
    for label, c in torch.load(path).items():
        spath = c["scene"]
        if spath not in scenes:
            scenes[spath] = flatten_scene(
                load_scene(os.path.join(REPO, spath)), dev)
        sc, st = scenes[spath]
        table = sc.bvh8_table if c["kernel"] == "K4" else sc.dense_prims
        check(torch.equal(table, c["table"]), f"{label}: {root} "
              f"flattens {spath} to another table")
        ro, rd, t0, t1 = c["ro"], c["rd"], c["t0"], c["t1"]
        if c["kernel"] == "K2":
            fn = lambda: pt_fused.fused_call(  # noqa: E731
                sc, st, SEED, 1, c["lanes"], ro, rd)
            li, rays = fn()
            digest[label] = hashlib.sha256(
                li.cpu().numpy().tobytes()
                + rays.cpu().numpy().tobytes()).hexdigest()
        else:
            route = {"K1": dense.dense_closest,
                     "K3": blocked.blocked_closest,
                     "K4": packet.walk_any if c["any_hit"] else
                     packet.walk_closest}[c["kernel"]]
            fn = lambda: route(sc, st, ro, rd, t0, t1)  # noqa: E731
        out[label] = timed_windows({label: fn}, min_reps=3)[label]
    from gpu_pathtracer_tpu_torch import kernels
    built = kernels.BUILDS.get("pt_fused")
    print(json.dumps({"ms": out, "digest": digest, "ptxas": ptxas_summary(
        built.ptxas) if built else ""}))


def phase_e_k3_main(dev, card, records):
    """K3 on the call captured from blocked.json's main path in phase D
    (bounce 1's closest hit, lanes sorted, finished lanes empty): kernel
    vs plain, its bound and the blocks its rays enter."""
    from gpu_pathtracer_tpu_torch.geom import blocked, blocked_cuda
    if "args" not in MAIN_K3:
        return
    tab, bb, sub, ro, rd, t_lo, t_hi, kinds = MAIN_K3["args"]
    HIT_INPUTS["K3 blocked.json main-path call"] = hit_call(
        "K3", KNOT["blocked"], tab, ro, rd, t_lo, t_hi)
    t = timed_windows({
        "kernel": lambda: blocked_cuda.blocked_hit_cuda(
            tab, bb, sub, ro, rd, t_lo, t_hi, False, kinds),
        "plain": lambda: blocked.blocked_hit_torch(
            tab, bb, ro, rd, t_lo, t_hi, False, kinds)}, min_reps=1)
    from types import SimpleNamespace
    scene = SimpleNamespace(dense_prims=tab, block_bbox=bb, block_sub=sub)
    ent = k3_entries(scene, ro, rd, t_lo, t_hi, kinds)
    b = k3_bound(scene, ro, rd, t_lo, t_hi, ent["t"])
    live = int((t_hi >= t_lo).sum())
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    print(f"[E] K3 closest hit on blocked.json's main-path call (bounce 1, "
          f"{ro.shape[0]} sorted lanes, {live} live): kernel "
          f"{mean(t['kernel']):.4f} ms (windows {min(t['kernel']):.4f}-"
          f"{max(t['kernel']):.4f}), plain {mean(t['plain']):.4f} ms; bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']}, {b['work']} ({card})")
    coh = warp_coherence(bb, ro, rd, t_lo, ent["t"])
    print(f"[E] K3 blocks entered per ray on that call: {entry_line(ent)}; "
          f"{coherence_line(coh)}")
    records["blocked"].update(
        ms_main=mean(t["kernel"]), plain_ms_main=mean(t["plain"]),
        bound_ms_main=b["bound_ms"], bound_by_main=b["bound_by"],
        main_lanes=ro.shape[0], main_live=live,
        entered_main=entry_summary(ent), warps_main=coh)


def k3_bound(scene, ro, rd, t_lo, t_hi, t_best) -> dict:
    """The bound of K3 on these rays: a live ray (t_lo <= t_hi) reads its
    32 B and writes 8 B, a ray with an empty interval reads its 8 B of
    interval and writes 8 B, and the three tables are read once; its
    operations are the least work of K3's culling levels (k3_work) given
    each live ray's closest hit `t_best` (the plain version's t, t_hi on
    a miss), under "work" per live ray. K4's is k4_bound."""
    n = ro.shape[0]
    live = t_hi >= t_lo
    nl = int(live.sum())
    w = k3_work(scene, ro[live], rd[live], t_lo[live], t_best[live])
    tables = (scene.dense_prims.numel() + scene.block_bbox.numel()
              + scene.block_sub.numel()) * 4
    b = bound(nl * RAY_IO + (n - nl) * 16 + tables,
              SLAB_FLOPS * (w["coarse"] + w["fine"] + w["sub"])
              + w["row_flops"])
    per = {k: v / max(nl, 1) for k, v in w.items()}
    b["work"] = (f"a live ray: {per['coarse']:.3f} coarse, {per['fine']:.3f}"
                 f" block and {per['sub']:.3f} sub-box slab tests, "
                 f"{per['rows']:.3f} prim tests ({per['row_flops']:.1f} "
                 f"flops)")
    return b


SMOKE_RAYS = {}   # the phase-B media rays, reused in phase E


def smoke_rays(scene, rng, n, dev):
    """n rays from outside the smoke box, aimed at points inside it; a
    quarter end inside the box, the rest reach past it. 90% of the lanes
    are in the smoke, 5% in the fog, 5% in vacuum (-1).
    -> (ro, rd, tmax, med_idx)."""
    if n in SMOKE_RAYS:
        return SMOKE_RAYS[n]
    p0 = scene.med_p0[0].cpu().numpy().astype(np.float64)
    p1 = scene.med_p1[0].cpu().numpy().astype(np.float64)
    target = rng.uniform(p0 + 0.02 * (p1 - p0), p1 - 0.02 * (p1 - p0), (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = 1.5 + np.where(rng.random(n) < 0.25, rng.uniform(0.0, 0.3, n),
                          rng.uniform(0.5, 3.0, n))
    idx = rng.choice(np.array([0, 1, -1], np.int32), n, p=[0.9, 0.05, 0.05])
    f = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=dev).contiguous()
    SMOKE_RAYS[n] = (f(target - 1.5 * d), f(d), f(tmax),
                     torch.as_tensor(idx, device=dev))
    return SMOKE_RAYS[n]


def walk_modes(scene):
    """The tracking walk's four cases: (label, mode, scene with that ett)."""
    from gpu_pathtracer_tpu_torch.scene.flatten import replace_media
    from gpu_pathtracer_tpu_torch.shade import media
    out = []
    for mode, ett in ((media.MODE_SAMPLE, 1), (media.MODE_TR, 0),
                      (media.MODE_TR, 1), (media.MODE_TR, 2)):
        sc = replace_media(scene, med_eval_tr_type=torch.full_like(
            scene.med_eval_tr_type, ett))
        label = "sample" if mode == media.MODE_SAMPLE else f"tr ett {ett}"
        out.append((label, mode, sc))
    return out


def walk_check(label, sc, mode, idx, ro, rd, tmax, key, iter_max) -> float:
    """The walk (track.cu's classify pass and persistent walk) vs the plain
    lock-step walk on one lane set: bit-equal on >= 99.99% of lanes,
    equal candidate counts, none outside the smoke. Returns the largest
    |kernel - plain| over lanes where both are finite."""
    from gpu_pathtracer_tpu_torch.shade import media, media_cuda
    ok, ck = media_cuda.track_cuda(sc, mode, idx, ro, rd, tmax, key,
                                   iter_max)
    op, cp = media._track_torch(sc, mode, idx, ro, rd, tmax, key, iter_max)
    torch.cuda.synchronize()
    same = (ok == op) | (torch.isnan(ok) & torch.isnan(op))
    frac = same.float().mean().item()
    cand_same = (ck == cp).float().mean().item()
    fin = torch.isfinite(ok) & torch.isfinite(op)
    err = (ok - op).abs()[fin].max().item() if fin.any() else 0.0
    stat = (torch.isfinite(ok).float().mean().item()
            if mode == media.MODE_SAMPLE else ok.double().mean().item())
    print(f"[B] track {label}: {idx.numel()} lanes ({int((idx == 0).sum())} "
          f"in the smoke), bit-equal {frac:.6f}, candidates "
          f"{int(ck.sum())} vs {int(cp.sum())} (per lane equal "
          f"{cand_same:.6f}, {ck.float().mean().item():.3f} per lane), "
          f"{'collided' if mode == media.MODE_SAMPLE else 'mean'} {stat:.6f}")
    check(frac >= 0.9999, f"track {label}: bit-equal on {frac}")
    check(int(ck.sum()) == int(cp.sum()) and cand_same >= 0.9999,
          f"track {label}: candidates differ")
    check(bool((ck[idx != 0] == 0).all()), f"track {label}: candidates "
          "on a lane outside the smoke")
    check(int(ck.max()) <= iter_max, f"track {label}: {int(ck.max())} "
          f"candidates on a lane past the cap {iter_max}")
    return err


def phase_b_media(dev, rng, records):
    """The tracking kernel vs its plain versions on 1,048,576 rays through
    scenes/smoke_port's smoke box: segment_majorants (K5's function) bit
    for bit, also at an N that is not a multiple of its block; the walk in
    sample mode and in tr mode for ett 0, 1 and 2 on the phase-B lanes
    (90% in the smoke), on a sparse set (about three quarters of the
    lanes in vacuum or the fog, interleaved at random), on a set where no
    lane walks (an empty queue), on the phase-B lanes under a candidate
    cap (med_iter_max) of 1 and of 3, and at an N that is not a multiple
    of the block size; on the phase-B lanes with a per-lane call site
    (TrackKey.sites), against the plain walk and against each site's own
    walk merged by lane; and rays that miss the box."""
    from gpu_pathtracer_tpu_torch.core.rng import (
        TRACK_EMITTER, TRACK_SCATTER, TRACK_SURFACE, track_tag,
    )
    from gpu_pathtracer_tpu_torch.shade import media, media_cuda
    scene, static = flat(SMOKE, dev)
    n = N_RAYS
    n_odd = n - 37   # neither a multiple of 128, 256 nor 1024
    ro, rd, tmax, idx = smoke_rays(scene, rng, n, dev)
    med = media.gather_medium(scene, idx)
    t0, ln = media._box_clip(med, ro, rd, tmax)
    ro_h = (ro + rd * t0[:, None]).contiguous()
    idx0 = torch.clamp_min(idx, 0)
    for label, (o, t), m in (("clipped to the box", (ro_h, ln), n),
                             ("raw tmax", (ro, tmax), n),
                             (f"clipped, N = {n_odd}", (ro_h, ln), n_odd)):
        mk = media_cuda.segment_majorants_cuda(scene, o[:m], rd[:m], t[:m],
                                               idx0[:m])
        mp = media._segment_majorants(
            scene, {k: v[:m] for k, v in med.items()}, o[:m], rd[:m], t[:m])
        torch.cuda.synchronize()
        glob = (mp == (1.0 / torch.clamp_min(med["inv_max_density"][:m],
                                             1e-30))[:, None]) \
            .all(1).float().mean().item()
        equal = torch.equal(mk, mp)
        print(f"[B] segment_majorants (K5's function) {label}: {m} rays x "
              f"{media.NSEG} segments, bit-equal {equal}, lanes on the "
              f"global-majorant fallback {glob:.4f}")
        check(equal, f"segment_majorants {label}: not bit-equal")

    key = media.TrackKey(SEED, 1, torch.arange(n, device=dev),
                         track_tag(0, TRACK_SURFACE))
    mixed = key._replace(tag=track_tag(0, 0, 2), sites=torch.as_tensor(
        rng.choice(np.array([1, 2, 3], np.int32), n), device=dev))
    # the lane sets: phase-B lanes; sparse (three quarters in vacuum or
    # the fog); none in the smoke (the queue stays empty)
    other = torch.as_tensor(rng.choice(np.array([-1, 1], np.int32), n),
                            device=dev)
    keep = torch.as_tensor(rng.random(n) < 0.25, device=dev)
    sets = {"": idx, "sparse, ": torch.where(keep, idx, other),
            "empty queue, ": other}
    err = 0.0
    for label, mode, sc in walk_modes(scene):
        for set_name, ids in sets.items():
            err = max(err, walk_check(set_name + label, sc, mode, ids, ro, rd,
                                      tmax, key, static.med_iter_max))
        # the candidate cap reached: med_iter_max 1 and 3
        for cap in (1, 3):
            err = max(err, walk_check(f"med_iter_max {cap}, {label}", sc,
                                      mode, idx, ro, rd, tmax, key, cap))
        k_odd = key._replace(lanes=key.lanes[:n_odd])
        err = max(err, walk_check(f"N = {n_odd}, {label}", sc, mode,
                                  idx[:n_odd], ro[:n_odd], rd[:n_odd],
                                  tmax[:n_odd], k_odd, static.med_iter_max))
        # a per-lane call site (the VPT step's one walk): vs the plain
        # walk, and vs the single-site walks merged by lane
        err = max(err, walk_check(f"mixed call sites, {label}", sc, mode,
                                  idx, ro, rd, tmax, mixed,
                                  static.med_iter_max))
        out, cand = media_cuda.track_cuda(sc, mode, idx, ro, rd, tmax, mixed,
                                          static.med_iter_max)
        for site in (TRACK_SCATTER, TRACK_SURFACE, TRACK_EMITTER):
            o1, c1 = media_cuda.track_cuda(
                sc, mode, idx, ro, rd, tmax,
                key._replace(tag=track_tag(0, site, 2)), static.med_iter_max)
            sel = mixed.sites == site
            check(torch.equal(bits(out[sel]), bits(o1[sel]))
                  and torch.equal(cand[sel], c1[sel]),
                  f"track mixed call sites, {label}: site {site}'s lanes "
                  "differ from its own walk")
        out, cand = media_cuda.track_cuda(sc, mode, other, ro, rd, tmax, key,
                                          static.med_iter_max)
        check(int(cand.sum()) == 0 and bool(
            (out == (torch.inf if mode == media.MODE_SAMPLE else 1.0)).all()),
              f"track empty queue, {label}: a lane outside the smoke walked")

    # rays that miss the box: Tr exactly 1, no candidate drawn
    miss_o = torch.tensor([0.5, 1.0, 0.5], device=dev).expand(n, 3)
    up = torch.tensor([0.0, 1.0, 0.0], device=dev).expand(n, 3)
    for label, mode, sc in walk_modes(scene)[1:]:
        out, cand = media_cuda.track_cuda(
            sc, mode, torch.zeros(n, dtype=torch.int32, device=dev), miss_o,
            up, torch.full((n,), 5.0, device=dev), key, static.med_iter_max)
        check(bool((out == 1.0).all()) and int(cand.sum()) == 0,
              f"track {label}: a ray that misses the box drew candidates")
    print(f"[B] track on {n} rays that miss the box: Tr exactly 1, no "
          "candidate, for ett 0, 1 and 2")
    occ = media_cuda.occupancy(scene)
    print(f"[B] track.cu launch shapes on this card, {SMOKE}: {occ}")
    records["track"].update(occupancy=occ)
    records["track"]["max_abs_err"] = err


def phase_c_media(dev, records, path, n_lanes=65536):
    """The VPT wavefront over K1 + track vs the all-plain VPT on the
    smoke scene at `path`, 65,536 lanes."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        close_frac, kernel_stats, reset_counts)
    from gpu_pathtracer_tpu_torch.integrators import vpt
    scene, static = flat(path, dev)
    n_pix = static.width * static.height
    ids = torch.arange(0, n_pix, n_pix // n_lanes, device=dev,
                       dtype=torch.int32)[:n_lanes]
    px, py = ids % static.width, ids // static.width
    stats = kernel_stats()
    reset_counts(*stats.values())
    li_k, r_k = vpt.render_lanes(scene, static, SEED, 1, px, py, True)
    torch.cuda.synchronize()
    counts = {k: st.launches for k, st in stats.items()}
    li_p, r_p = vpt.render_lanes(scene, static, SEED, 1, px, py, True,
                                 plain=True)
    frac = close_frac(li_k, li_p)
    ratio = li_k.double().mean().item() / li_p.double().mean().item()
    print(f"[C] VPT over K1, track and vpt_shade.cu, {path}: "
          f"{ids.numel()} lanes, agree "
          f"{frac:.6f}, bit-equal "
          f"{(li_k == li_p).all(1).float().mean().item():.6f}, mean ratio "
          f"{ratio:.7f}, rays {int(r_k)} vs {int(r_p)}, launches {counts}")
    check(frac >= 0.99, f"VPT wavefront: agree on {frac}")
    check(abs(ratio - 1.0) <= 1e-3, f"VPT wavefront: ratio {ratio}")
    check(int(r_k) == int(r_p), "VPT wavefront: ray counts differ")
    check(bool(torch.isfinite(li_k).all()), "VPT: non-finite li")
    check(only(counts, *VPT_KERNELS), f"VPT wavefront: launches {counts}")
    records["track"]["max_abs_err"] = max(
        records["track"].get("max_abs_err", 0.0),
        (li_k - li_p).abs().max().item())


def hold_radiance(label, what, a, b) -> None:
    """a against b (the plain version) within the radiance limits
    (run/reference.py's `held`): agree on >= 99% of the rows (of a film:
    of the pixels either touched), means within 0.1%, a finite."""
    from gpu_pathtracer_tpu_torch.run.reference import held
    h = held(a, b, what)
    check(h["rows"] > 0, f"{label} {what}: no rows to compare")
    print(f"[{label[0]}] {label[2:]} {what}: {h['rows']} rows, agree "
          f"{h['agree']:.6f}, bit-equal {h['bit_equal']:.6f}, max abs err "
          f"{h['max_abs_err']:.3e}, mean ratio {h['mean_ratio']:.7f}")
    check(bool(torch.isfinite(a).all()), f"{label}: non-finite {what}")
    check(h["ok"], f"{label} {what}: {h['rows']} rows, agree on "
          f"{h['agree']}, mean ratio {h['mean_ratio']}")


def program_static(scene_path, integ, dev, depth=5):
    """The scene at `scene_path` flattened on `dev`, set to integrator
    `integ` at `depth`."""
    import dataclasses
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    scene, static = flat(scene_path, dev)
    return scene, dataclasses.replace(
        static, integrator=IntegratorType[integ.upper()], max_depth=depth)


def phase_c_program(dev, records, integ, path, n_lanes=65536, depth=5,
                    kname="dense_hit"):
    """Program `integ` over the kernels against itself all-plain on the
    scene at `path`, 65,536 lanes, at `depth`; the launches must be the
    scene's hit kernel's, `kname` (and track's in a scene with media)."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        kernel_stats, reset_counts, run_program)
    scene, static = program_static(path, integ, dev, depth)
    n_pix = static.width * static.height
    ids = torch.arange(0, n_pix, n_pix // n_lanes, device=dev,
                       dtype=torch.int32)[:n_lanes]
    if integ == "bdpt":   # its seconds are a second run's, the builds done
        bdpt_checked(f"bdpt on {path} at depth {depth}",
                     lambda: run_program(integ, scene, static, ids, SEED))
    stats = kernel_stats()
    reset_counts(*stats.values())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    li_k, film_k, r_k = run_program(integ, scene, static, ids, SEED)
    torch.cuda.synchronize()
    sec = time.time() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    counts = {k: st.launches for k, st in stats.items()}
    li_p, film_p, r_p = run_program(integ, scene, static, ids, SEED,
                                    plain=True)
    label = f"C {integ} {path}"
    print(f"[C] {integ} on {path} at depth {depth}: {ids.numel()} lanes, "
          f"rays {int(r_k)} vs {int(r_p)}, the run over the kernels "
          f"{sec:.4f} s{' (its second)' if integ == 'bdpt' else ''}, its "
          f"peak device memory {peak:.3f} GiB above what "
          f"was held, launches {counts}")
    for what, a, b in (("radiance", li_k, li_p), ("film", film_k, film_p)):
        if a is not None:
            hold_radiance(label, what, a, b)
    # BDPT draws every site in its kernels: no rng launch
    want = {kname} | ({"track"} if static.has_hetero else set()) \
        | ({"pt_shade"} if integ == "pt" else set()) \
        | (set(BDPT_KERNELS) if integ == "bdpt" else {"rng"})
    check(only(counts, *want), f"{label}: launches {counts}")
    name = f"launches_c_{integ}_{os.path.basename(os.path.dirname(path))}"
    stem = os.path.splitext(os.path.basename(path))[0]
    if stem != "scene":
        name += f"_{stem}"
    if depth != 5:
        name += f"_depth{depth}"
    for k in want:
        records[k][name] = counts[k]
    if integ == "bdpt":
        records["bdpt_connect"][name.replace("launches", "peak_gib")] = peak
        records["bdpt_connect"][name.replace("launches", "s")] = sec


def phase_c_bdpt_tile(dev, records):
    """BDPT over the kernels on cornell_port at depth 17 on the renderer's
    1M-lane tile, where the queue would take 323 slots a lane: the lanes
    run in chunks of bdpt.QUEUE_SLOTS slots (a start and a connect
    launch each); the sample's time and peak device memory, its radiance
    finite."""
    import dataclasses
    from gpu_pathtracer_tpu_torch.integrators import bdpt, bdpt_shade as bs
    from gpu_pathtracer_tpu_torch.run.reference import (
        kernel_stats, reset_counts)
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    sc, st = scene_1024(SCENES[0], dev)
    st = dataclasses.replace(st, integrator=IntegratorType.BDPT,
                             max_depth=DEEP)
    ids = torch.arange(N_RAYS, device=dev)
    px, py = ids % st.width, ids // st.width
    chunk = bdpt.QUEUE_SLOTS // bs.n_slots(st.max_depth)
    n_chunks = -(-N_RAYS // chunk)
    bdpt_checked(f"bdpt on {SCENES[0]} at depth {DEEP}, {N_RAYS} lanes in "
                 f"{n_chunks} chunks",   # the warm-up
                 lambda: bdpt.render_lanes(sc, st, SEED, 1, px, py))
    stats = kernel_stats()
    reset_counts(*stats.values())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    li, film, rays = bdpt.render_lanes(sc, st, SEED, 2, px, py, True)
    torch.cuda.synchronize()
    sec = time.time() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    counts = {k: x.launches for k, x in stats.items() if x.launches}
    print(f"[C] bdpt on {SCENES[0]} at depth {DEEP}: {N_RAYS} lanes in "
          f"{n_chunks} "
          f"chunks of {chunk}, one sample in {sec:.4f} s, rays {int(rays)}, "
          f"peak device memory {peak:.3f} GiB above what was held, "
          f"launches {counts}")
    check(counts.get("bdpt_start") == counts.get("bdpt_connect") == n_chunks,
          f"depth {DEEP} at 1M lanes: launches {counts}")
    check(bool(torch.isfinite(li).all()) and li.mean().item() > 0
          and film.sum().item() > 0, f"depth {DEEP} at 1M lanes: radiance "
          f"{li.mean().item()}")
    records["bdpt_connect"]["peak_gib_bdpt_depth17_1m"] = peak
    records["bdpt_connect"]["s_bdpt_depth17_1m"] = sec


def flat_sized(path, size, dev):
    """The scene at repo path `path` at size x size, flattened on `dev`
    (once per run)."""
    from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    key = f"{path}@{size}"
    if key not in _FLAT:
        host = load_scene(os.path.join(REPO, path))
        host.width = host.height = size
        _FLAT[key] = (*flatten_scene(host, dev), 0.0)
    return _FLAT[key][:2]


def held_counts(label, stats, kname, records, field) -> dict:
    """The launches since the counts were set to 0: all of them kernel
    `kname`'s, recorded under `field`."""
    counts = {k: st.launches for k, st in stats.items()}
    check(only(counts, kname, "rng"), f"{label}: launches {counts}")
    records[kname][field] = counts[kname]
    return counts


def phase_c_ir(dev, records, n_lanes=65536):
    """Instant radiosity over K1 against itself all-plain on cornell_port:
    the VPL store (32 light paths) and the camera pass of 65,536 lanes
    gathering the store's fullest row; then K1's any hit at the JAX
    package's gather shape, 32 slots x 1,048,576 lanes in one call,
    against the same rays in calls of 1,048,576."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        close_frac, kernel_stats, reset_counts)
    from gpu_pathtracer_tpu_torch.integrators import ir
    scene, static = program_static(SCENES[0], "ir", dev)
    n_pix = static.width * static.height
    ids = torch.arange(0, n_pix, n_pix // n_lanes, device=dev,
                       dtype=torch.int32)[:n_lanes]
    px, py = ids % static.width, ids // static.width
    stats = kernel_stats()
    reset_counts(*stats.values())
    v_k, rv_k = ir.generate_vpls(scene, static, SEED, 1, True)
    row = int(v_k.count.argmax())
    li_k, r_k = ir.render_lanes(scene, static, SEED, 1, px, py, v_k, row,
                                True)
    torch.cuda.synchronize()
    counts = held_counts("C ir", stats, "dense_hit", records,
                         "launches_c_ir_cornell_port")
    v_p, rv_p = ir.generate_vpls(scene, static, SEED, 1, True, plain=True)
    li_p, r_p = ir.render_lanes(scene, static, SEED, 1, px, py, v_p, row,
                                True, plain=True)
    check(torch.equal(v_k.count, v_p.count),
          f"C ir: VPL counts {v_k.count.tolist()} vs {v_p.count.tolist()}")
    filled = torch.arange(ir.IR_MAX_VPLS, device=dev)[None, :] \
        < v_k.count[:, None]
    for name in ("beta", "pos", "nor", "dir", "dpdu"):
        a, b = getattr(v_k, name)[filled], getattr(v_p, name)[filled]
        frac = close_frac(a, b)
        print(f"[C] ir VPL store {name}: {a.shape[0]} filled slots, agree "
              f"{frac:.6f}, max abs err {(a - b).abs().max().item():.3e}")
        check(frac >= 0.99, f"C ir VPL store {name}: agree on {frac}")
    print(f"[C] ir on {SCENES[0]}: VPL counts {v_k.count.tolist()}, row "
          f"{row}; {ids.numel()} lanes, rays {int(rv_k) + int(r_k)} vs "
          f"{int(rv_p) + int(r_p)}, launches {counts}")
    hold_radiance(f"C ir {SCENES[0]}", "radiance", li_k, li_p)
    k1_gather_shape(dev, scene, static)


def k1_gather_shape(dev, scene, static):
    """K1's any hit at the JAX package's IR gather shape (IR_MAX_VPLS
    slots x 1,048,576 lanes, one call) against the same rays in calls of
    1,048,576: the port's gather traces only a row's filled slots, so no
    main path launches this shape."""
    from gpu_pathtracer_tpu_torch.geom import dense, dense_cuda
    from gpu_pathtracer_tpu_torch.integrators import ir
    n_big = ir.IR_MAX_VPLS << 20
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ro = torch.rand((n_big, 3), generator=gen, device=dev) \
        * torch.tensor([1.9, 1.9, 1.9], device=dev) - \
        torch.tensor([0.95, -0.05, 0.95], device=dev)
    rd = torch.nn.functional.normalize(
        torch.randn((n_big, 3), generator=gen, device=dev), dim=1)
    tmin = torch.full((n_big,), 1e-3, device=dev)
    tmax = torch.rand(n_big, generator=gen, device=dev) * 2.0
    kinds = dense.kinds_of(static)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    found = dense_cuda.dense_hit_cuda(scene.dense_prims, ro, rd, tmin, tmax,
                                      True, kinds)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    parts = torch.cat([dense_cuda.dense_hit_cuda(
        scene.dense_prims, ro[i:i + (1 << 20)], rd[i:i + (1 << 20)],
        tmin[i:i + (1 << 20)], tmax[i:i + (1 << 20)], True, kinds)
        for i in range(0, n_big, 1 << 20)])
    print(f"[C] K1 any hit at the JAX package's IR gather shape: {n_big} "
          f"rays in one call, {found.float().mean().item():.6f} blocked, "
          f"equal to 32 calls of 1,048,576 on "
          f"{(found == parts).float().mean().item():.6f}; the call's peak "
          f"device memory above its inputs {peak / 2**30:.3f} GiB")
    check(torch.equal(found, parts), "K1 at 33,554,432 rays differs from "
          "the same rays in calls of 1,048,576")
    del ro, rd, tmin, tmax, found, parts


def phase_c_coupled(dev, records, integ, path, size=256, iterations=2):
    """SPPM or MLT, which couple all pixels, over the kernels against
    itself all-plain as whole images of size x size for `iterations`
    iterations: SPPM's radius, photon statistic n and film; MLT's
    bootstrap candidates, then from the kernels' bootstrap its chain
    luminance and film. cornell_port runs at depth 5, mlt_slit.json at
    its own 10."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        kernel_stats, reset_counts)
    import dataclasses
    from gpu_pathtracer_tpu_torch.integrators import mlt, sppm
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    scene, static = flat_sized(path, size, dev)
    if path != MLT_SLIT:
        static = dataclasses.replace(
            static, integrator=IntegratorType[integ.upper()], max_depth=5)
    n = size * size
    ids = torch.arange(n, device=dev, dtype=torch.int32)
    px, py = ids % size, ids // size
    stats = kernel_stats()
    label = f"C {integ} {path} {size}x{size}"
    kname = "dense_hit" if integ == "sppm" else "pt_fused"
    name = f"launches_c_{integ}_{os.path.basename(os.path.dirname(path))}_" \
        f"{os.path.basename(path).split('.')[0]}"
    reset_counts(*stats.values())
    if integ == "sppm":
        def run(plain):
            state = sppm.init_state(n, static.init_radius, dev)
            rays = 0
            for it in range(1, iterations + 1):
                state, film, r = sppm.render_iteration(
                    scene, static, SEED, it, state, px, py, True, plain)
                rays += int(r)
            return state, film, rays
        s_k, f_k, r_k = run(False)
        counts = held_counts(label, stats, kname, records, name)
        s_p, f_p, r_p = run(True)
        print(f"[C] sppm on {path}: {n} pixels x {iterations} iterations at "
              f"{static.photons_per_iteration} photons, rays {r_k} vs {r_p},"
              f" launches {counts}; radius mean {s_k.radius.mean().item():.6f}"
              f" (first {static.init_radius})")
        check(bool(torch.equal(s_k.valid, s_p.valid)), f"{label}: valid")
        hold_radiance(label, "radius", s_k.radius[:, None], s_p.radius[:, None])
        hold_radiance(label, "photon statistic n", s_k.n[:, None],
                      s_p.n[:, None])
        hold_radiance(label, "radiance", f_k, f_p)
        return
    cands = mlt.candidates(scene, static, SEED, n)
    s_k = mlt.resample(static, cands)
    s_p = s_k
    rays = int(cands[5])
    for it in range(1, iterations + 1):
        s_k, img_k, r = mlt.render_iteration(scene, static, SEED, it, s_k,
                                             True)
        rays += int(r)
    torch.cuda.synchronize()
    counts = held_counts(label, stats, kname, records, name)
    cands_p = mlt.candidates(scene, static, SEED, n, plain=True)
    hold_radiance(label, "bootstrap candidates' radiance", cands[1],
                  cands_p[1])
    for it in range(1, iterations + 1):
        s_p, img_p, _ = mlt.render_iteration(scene, static, SEED, it, s_p,
                                             True, plain=True)
    print(f"[C] mlt on {path}: {n} chains, depth {static.max_depth}, psample "
          f"[{mlt.n_dims(static) - 2}, {n}], bootstrap + {iterations} steps, "
          f"rays {rays}, launches {counts}; accepted-state luminance mean "
          f"{s_k['lum'].mean().item():.6f}")
    hold_radiance(label, "chain luminance", s_k["lum"][:, None],
                  s_p["lum"][:, None])
    hold_radiance(label, "film", img_k, img_p)


def program_main_path(card, records, integ, path, spp, kname):
    """Program `integ` through the CLI on the scene at `path`, 1024^2,
    depth 5: one warm-up spp (iteration) held against the program
    all-plain on every lane (run/reference.py's `plain_reference`; a
    film on the pixels either touched), then `spp` spp whose launches
    must all be kernel `kname`'s, with the peak device memory of that
    run (for MLT it holds the bootstrap, made before the CLI's timed
    window), then the bench's windows."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        kernel_stats, reset_counts)
    from gpu_pathtracer_tpu_torch.geom import dense_cuda
    from gpu_pathtracer_tpu_torch.run import cli, reference
    stats = kernel_stats()
    tag = f"{integ}_{os.path.basename(os.path.dirname(path))}_" \
        f"{os.path.basename(path).split('.')[0]}"
    label = f"{integ} {path}"

    def render(n, name):
        return cli.main([os.path.join(REPO, path), "--integrator", integ,
                         "--size", "1024", "--depth", "5", "--spp", str(n),
                         "--seed", str(SEED), "--out",
                         os.path.join(OUT, name)])

    warm = render(1, f"{tag}_1spp.png")
    r = warm["renderer"]
    for what, a, b in reference.plain_reference(integ, r):
        hold_radiance(f"D {label} warm-up spp vs plain", what, a, b)
    del warm, r, a, b

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # by the script's earlier phases
    k1_sizes = []   # the rays of each K1 call of the timed run
    k1 = dense_cuda.dense_hit_cuda

    def k1_sized(prims, ro, *args):
        k1_sizes.append(ro.shape[0])
        return k1(prims, ro, *args)

    dense_cuda.dense_hit_cuda = k1_sized
    reset_counts(*stats.values())
    try:
        res = render(spp, f"{tag}.png")
    finally:
        dense_cuda.dense_hit_cuda = k1
    counts = {k: st.launches for k, st in stats.items()}
    plain = sum(st.plain_cuda for st in stats.values())
    peak = torch.cuda.max_memory_allocated()
    r = res["renderer"]
    img = r.image()
    check(img.shape == (1024, 1024, 3) and bool(np.isfinite(img).all()),
          f"{label}: image {img.shape}, finite {np.isfinite(img).all()}")
    print(f"[D] {label} ({r.kind} kind) through {kname}: {spp} spp of "
          f"1024x1024 depth {r.static.max_depth}, tile {r.tile_size} "
          f"lanes, in {res['seconds']:.6f} s, then {rate(r)}, host set-up "
          f"{res['build_seconds']:.3f} s, peak device memory "
          f"{peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB above "
          f"what was held before the run ({card}); launches {counts}, "
          f"plain-version calls on CUDA {plain}, largest K1 call "
          f"{max(k1_sizes, default=0)} rays")
    knames = {"pt": (kname, "pt_shade"),
              "bdpt": (kname, *BDPT_KERNELS)}.get(integ, (kname,))
    # BDPT draws every site in its kernels: no rng launch
    check(only(counts, *knames, *(() if integ == "bdpt" else ("rng",))),
          f"{label}: main path launched {counts}")
    check(plain == 0, f"{label}: {plain} plain-version calls on CUDA")
    for k in knames:
        records[k][f"launches_{tag}"] = counts[k]
    if integ == "bdpt":
        per_spp = {k: counts[k] / spp for k in (kname, *BDPT_KERNELS)}
        print(f"[D] {label}: launches a spp {per_spp}")
        for k in BDPT_KERNELS:
            records[k]["launches"] = counts[k]
            records[k]["launches_per_spp_bdpt_cornell"] = per_spp[k]
    records["rng"][f"launches_{tag}"] = counts["rng"]
    records[kname][f"peak_gib_{tag}"] = (peak - held) / 2**30
    from gpu_pathtracer_tpu_torch.geom import packet_cuda
    packet_cuda.check_overflow()


MAIN_K3 = {}   # the K3 call captured on blocked.json's main path (phase D)


def capture_main_k3():
    """Wrap blocked_cuda.blocked_hit_cuda so that the wavefront's second
    closest-hit call (bounce 1: the primary rays are bounce 0's) keeps a
    copy of its arguments in MAIN_K3. Returns the function that takes the
    wrapper away."""
    from gpu_pathtracer_tpu_torch.geom import blocked_cuda
    orig = blocked_cuda.blocked_hit_cuda
    closest = []

    def wrapper(prims, bbox, sub, ro, rd, tmin, tmax, any_hit, kinds):
        if not any_hit and "args" not in MAIN_K3:
            closest.append(1)
            if len(closest) == 2:
                MAIN_K3["args"] = (prims, bbox, sub, ro.clone(), rd.clone(),
                                   tmin.clone(), tmax.clone(), kinds)
        return orig(prims, bbox, sub, ro, rd, tmin, tmax, any_hit, kinds)

    blocked_cuda.blocked_hit_cuda = wrapper
    return lambda: setattr(blocked_cuda, "blocked_hit_cuda", orig)


MAIN_K4 = {}   # the K4 calls captured on scene.json's main path (phase D)


def capture_main_k4():
    """Wrap packet_cuda.bvh8_walk_cuda so that the wavefront's second
    closest-hit call (bounce 1) and its second any-hit call (bounce 1's
    shadow rays) keep a copy of their arguments in MAIN_K4. Returns the
    function that takes the wrapper away."""
    from gpu_pathtracer_tpu_torch.geom import packet_cuda
    orig = packet_cuda.bvh8_walk_cuda
    seen = {False: 0, True: 0}

    def wrapper(table, aux, n_inst, ro, rd, tmin, tmax, any_hit, stack,
                kinds=(True, True, True)):
        seen[any_hit] += 1
        if seen[any_hit] == 2:
            MAIN_K4["any" if any_hit else "closest"] = (
                table, aux, n_inst, ro.clone(), rd.clone(), tmin.clone(),
                tmax.clone(), stack, kinds)
        return orig(table, aux, n_inst, ro, rd, tmin, tmax, any_hit, stack,
                    kinds)

    packet_cuda.bvh8_walk_cuda = wrapper
    return lambda: setattr(packet_cuda, "bvh8_walk_cuda", orig)


def phase_e_k4_main(card, records):
    """K4 on the two calls captured from scene.json's main path in phase D
    (bounce 1's closest hit and shadow rays, lanes sorted, finished lanes
    empty): kernel vs plain, each with its bound (k4_work given the plain
    walk's hit: its closest hit, or the hit its any-hit walk stops at)."""
    from gpu_pathtracer_tpu_torch.geom import packet, packet_cuda
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    for kind in ("closest", "any"):
        if kind not in MAIN_K4:
            continue
        table, aux, n_inst, ro, rd, t_lo, t_hi, stack, kinds = MAIN_K4[kind]
        any_hit = kind == "any"
        HIT_INPUTS[f"K4 scene.json main-path {kind} call"] = hit_call(
            "K4", KNOT["scene"], table, ro, rd, t_lo, t_hi, any_hit)
        t = timed_windows({
            "kernel": lambda: packet_cuda.bvh8_walk_cuda(
                table, aux, n_inst, ro, rd, t_lo, t_hi, any_hit, stack,
                kinds),
            "plain": lambda: packet.walk_torch(
                table, aux, n_inst, ro, rd, t_lo, t_hi, any_hit, kinds,
                stack)}, min_reps=1)
        res = packet.walk_torch(table, aux, n_inst, ro, rd, t_lo, t_hi,
                                any_hit, kinds, stack, with_t=True)
        b = k4_bound(table, aux, n_inst, ro, rd, t_lo, t_hi, res[1 if any_hit
                                                                else 0],
                     any_hit)
        live = int((t_hi >= t_lo).sum())
        if not any_hit:
            v = walk_visits(table, ro, rd, t_lo, t_hi, kinds, stack)
            print(f"[E] K4 main-path closest call: {visits_line(v)}")
            records["bvh8_walk"]["visits_main"] = v
        print(f"[E] K4 {kind} hit on scene.json's main-path call (bounce 1, "
              f"{ro.shape[0]} sorted lanes, {live} live): kernel "
              f"{mean(t['kernel']):.4f} ms (windows {min(t['kernel']):.4f}-"
              f"{max(t['kernel']):.4f}), plain {mean(t['plain']):.4f} ms; "
              f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['work']})"
              f" ({card})")
        sfx = "_main" if kind == "closest" else "_main_any"
        records["bvh8_walk"].update({
            f"ms{sfx}": mean(t["kernel"]), f"plain_ms{sfx}": mean(t["plain"]),
            f"bound_ms{sfx}": b["bound_ms"], f"bound_by{sfx}": b["bound_by"],
            f"work{sfx}": b["per_ray"], f"live{sfx}": live})
    packet_cuda.check_overflow()


K1_CALLS = []   # (lanes, live lanes, wholly empty warps, warps) per call
K1_ARGS = []    # with --baseline: each call's (table, ro, rd, tmin, tmax)


def capture_k1_live():
    """Wrap dense_cuda.dense_hit_cuda so that every call records its
    lanes, the lanes whose interval is not empty (the kernel's rule,
    intersect.cuh::empty_interval) and the warps (64 lanes: 32 threads of
    two rays) that hold none, in K1_CALLS, and with --baseline a copy of
    its arguments in K1_ARGS. Returns the function that takes the wrapper
    away."""
    from gpu_pathtracer_tpu_torch.geom import dense_cuda
    orig = dense_cuda.dense_hit_cuda

    def wrapper(prims, ro, rd, tmin, tmax, any_hit, kinds):
        if BASELINE:
            K1_ARGS.append((prims, ro.clone(), rd.clone(), tmin.clone(),
                            tmax.clone()))
        live = tmax >= tmin
        if tuple(map(bool, kinds)) != (True, False, False):
            live = live | (tmax > 0.0)
        warps = torch.cat([live, live.new_zeros((-live.numel()) % 64)]) \
            .view(-1, 64).any(1)
        K1_CALLS.append((live.numel(), int(live.sum()),
                         int((~warps).sum()), warps.numel()))
        return orig(prims, ro, rd, tmin, tmax, any_hit, kinds)

    dense_cuda.dense_hit_cuda = wrapper
    return lambda: setattr(dense_cuda, "dense_hit_cuda", orig)


def k1_live_report(records, n_steps):
    """Per VPT step: the share of lanes alive at its closest hit and the
    share of K1's warps wholly empty, there and in the step's Tr-walk
    segment calls."""
    per = len(K1_CALLS) // n_steps
    check(per * n_steps == len(K1_CALLS), f"{len(K1_CALLS)} K1 calls in "
          f"{n_steps} VPT steps")
    rows = []
    for s in range(n_steps):
        calls = K1_CALLS[s * per:(s + 1) * per]
        n, live, dead, warps = calls[0]
        tr = calls[1:]
        tr_live = sum(c[1] for c in tr) / max(sum(c[0] for c in tr), 1)
        tr_dead = sum(c[2] for c in tr) / max(sum(c[3] for c in tr), 1)
        rows.append(f"step {s}: alive {live / n:.4f}, empty warps "
                    f"{dead / warps:.4f}; its {len(tr)} Tr calls: live "
                    f"{tr_live:.4f}, empty warps {tr_dead:.4f}")
    dead_all = sum(c[2] for c in K1_CALLS) / sum(c[3] for c in K1_CALLS)
    live_all = sum(c[1] for c in K1_CALLS) / sum(c[0] for c in K1_CALLS)
    print(f"[D] K1 over the VPT warm-up spp, {len(K1_CALLS)} calls ({per} a "
          f"step): lanes live {live_all:.4f}, warps wholly empty "
          f"{dead_all:.4f}")
    for r in rows:
        print(f"[D]   {r}")
    records["dense_hit"].update(vpt_live_share=live_all,
                                vpt_empty_warp_share=dead_all)
    if K1_ARGS:   # two of these calls for --baseline
        for label, k in (("step 3 closest hit", 3 * per),
                         ("step 3 first Tr segment", 3 * per + 1)):
            HIT_INPUTS[f"K1 smoke VPT {label}"] = hit_call("K1", SMOKE,
                                                           *K1_ARGS[k])
        K1_ARGS.clear()


MAIN_WALK = {}   # the track call captured on the VPT main path (phase D)


def capture_main_walk():
    """Wrap media_cuda.track_cuda so that the first Tr walk of step 1 of
    the VPT (its tag's step bits: track_tag(1, site) >> 8 == 2) keeps a
    copy of its arguments in MAIN_WALK. Returns the function that takes
    the wrapper away."""
    from gpu_pathtracer_tpu_torch.shade import media, media_cuda
    orig = media_cuda.track_cuda

    def wrapper(scene, mode, med_idx, ro, rd, tmax, key, iter_max):
        if not MAIN_WALK and mode == media.MODE_TR and key.tag >> 8 == 2:
            MAIN_WALK["args"] = (
                scene, mode, med_idx.clone(), ro.clone(), rd.clone(),
                tmax.clone(), key._replace(lanes=key.lanes.clone()), iter_max)
        return orig(scene, mode, med_idx, ro, rd, tmax, key, iter_max)

    media_cuda.track_cuda = wrapper
    return lambda: setattr(media_cuda, "track_cuda", orig)


def walking_lanes(scene, med_idx, ro, rd, tmax):
    """Lanes that walk: in a heterogeneous medium, with a non-empty clip
    (gather_medium maps -1 to medium 0, so the index is checked too)."""
    from gpu_pathtracer_tpu_torch.shade import media
    med = media.gather_medium(scene, med_idx)
    _, ln = media._box_clip(med, ro, rd, tmax)
    return (med_idx >= 0) & (med["type"] == media.HETEROGENEOUS) & (ln > 0)


def vpt_main_path(card, records):
    """The VPT main path through the CLI: scenes/smoke_port at 1024^2,
    depth 5; one warm-up spp held against the plain VPT on every lane
    (the first Tr walk of its step 1 captured for phase E), then 2 timed
    spp whose launches must be K1's and track's."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        close_frac, kernel_stats, reset_counts)
    from gpu_pathtracer_tpu_torch.integrators import vpt
    from gpu_pathtracer_tpu_torch.run import cli
    path = os.path.join(REPO, SMOKE)
    stats = kernel_stats()

    def render(n, name):
        return cli.main([path, "--integrator", "vpt", "--size", "1024",
                         "--depth", "5", "--spp", str(n), "--seed",
                         str(SEED), "--out", os.path.join(OUT, name)])

    release = capture_main_walk()
    release_k1 = capture_k1_live()
    try:
        warm = render(1, "smoke_port_1spp.png")
    finally:
        release_k1()
        release()
    check("args" in MAIN_WALK, "no Tr walk of step 1 on the VPT main path")
    k1_live_report(records, warm["renderer"].static.max_depth
                   + vpt.INTERFACE_BUDGET + 1)
    sc, mode, med_idx, ro, rd, tmax, key, _ = MAIN_WALK["args"]
    walks = walking_lanes(sc, med_idx, ro, rd, tmax)
    print(f"[D] captured the first Tr walk of step 1 (tag {key.tag:#x}): "
          f"{med_idx.numel()} lanes, {int((med_idx >= 0).sum())} in a "
          f"medium, {int(walks.sum())} walk")
    r = warm["renderer"]
    li_p = vpt.render_lanes(r.device_scene, r.static, SEED, 1, r._px, r._py,
                            plain=True)
    li_k = r.acc
    frac = close_frac(li_k, li_p)
    ratio = li_k.double().mean().item() / li_p.double().mean().item()
    err = (li_k - li_p).abs().max().item()
    print(f"[D] {SMOKE} warm-up spp vs plain VPT: {li_k.shape[0]} lanes, "
          f"agree {frac:.6f} (bit-equal "
          f"{(li_k == li_p).all(1).float().mean().item():.6f}), max abs err "
          f"{err:.3e}, mean ratio {ratio:.7f}")
    check(frac >= 0.99, f"VPT main path: agree on {frac}")
    check(abs(ratio - 1.0) <= 1e-3, f"VPT main path: mean ratio {ratio}")
    del warm, r, li_p, li_k

    reset_counts(*stats.values())
    res = render(2, "smoke_port.png")
    counts = {k: st.launches for k, st in stats.items()}
    plain = sum(st.plain_cuda for st in stats.values())
    img = res["renderer"].image()
    check(img.shape == (1024, 1024, 3) and bool(np.isfinite(img).all()),
          f"smoke_port: image {img.shape}, finite {np.isfinite(img).all()}")
    per_spp = {k: n / 2 for k, n in counts.items() if n}
    print(f"[D] {SMOKE} VPT through K1, track and vpt_shade.cu: 2 spp of "
          f"1024x1024 depth {res['renderer'].static.max_depth} in "
          f"{res['seconds']:.6f} s, then {rate(res['renderer'])}, host build "
          f"{res['build_seconds']:.2f} s ({card}); launches {counts} "
          f"({per_spp} a spp, {sum(per_spp.values()):.0f} in all), "
          f"plain-version calls on CUDA {plain}")
    check(only(counts, *VPT_KERNELS), f"VPT main path launches {counts}")
    check(plain == 0, f"VPT main path: {plain} plain-version calls on CUDA")
    for k in VPT_KERNELS:
        if k == "rng":
            records["rng"]["launches_vpt_smoke"] = counts["rng"]
        else:
            records[k]["launches"] = counts[k]
            records[k]["launches_per_spp_vpt_smoke"] = per_spp[k]


def phase_e_media(dev, rng, card, records):
    """segment_majorants (K5's function) vs its plain version vs the one
    PyTorch call of K5's lookup (med_sv_max[idx] on the same [1M, 42]
    indices); the tracking walk vs its plain version on the phase-B rays."""
    from gpu_pathtracer_tpu_torch.core.rng import TRACK_SURFACE, track_tag
    from gpu_pathtracer_tpu_torch.scene.flatten import sv_res
    from gpu_pathtracer_tpu_torch.shade import media, media_cuda
    scene, static = flat(SMOKE, dev)
    n = N_RAYS
    ro, rd, tmax, idx = smoke_rays(scene, rng, n, dev)
    med = media.gather_medium(scene, idx)
    t0, ln = media._box_clip(med, ro, rd, tmax)
    ro_h = (ro + rd * t0[:, None]).contiguous()
    idx0 = torch.clamp_min(idx, 0)
    # the [1M, 42] table indices of K5's lookup, as _segment_majorants
    # makes them
    s1 = sv_res(scene.med_type.shape[0]) + 1
    seg = media._seg_len(ln)
    ts = torch.arange(media.NSEG + 1, dtype=torch.float32,
                      device=dev)[None, :] * seg[:, None]
    p = ro_h[:, None, :] + rd[:, None, :] * ts[..., None]
    span = med["p1"] - med["p0"]
    svc = (p - med["p0"][:, None, :]) / span[:, None, :] * (s1 - 1.0)
    cell = torch.clamp(torch.floor(torch.minimum(svc[:, :-1], svc[:, 1:]))
                       .to(torch.int64) + 1, 0, s1 - 1)
    flat_idx = (idx0[:, None].long() * s1 ** 3 + cell[..., 2] * s1 * s1
                + cell[..., 1] * s1 + cell[..., 0]).contiguous()
    sv_max = scene.med_sv_max
    t = timed_windows({
        "kernel": lambda: media_cuda.segment_majorants_cuda(
            scene, ro_h, rd, ln, idx0),
        "plain": lambda: media._segment_majorants(scene, med, ro_h, rd, ln),
        "library": lambda: sv_max[flat_idx]})
    key = media.TrackKey(SEED, 1, torch.arange(n, device=dev),
                         track_tag(0, TRACK_SURFACE))
    _, _, sc = walk_modes(scene)[2]   # tr mode, ratio tracking
    out, cand = media_cuda.track_cuda(sc, media.MODE_TR, idx, ro, rd, tmax,
                                      key, static.med_iter_max)
    w = timed_windows({
        "kernel": lambda: media_cuda.track_cuda(
            sc, media.MODE_TR, idx, ro, rd, tmax, key, static.med_iter_max),
        "plain": lambda: media._track_torch(
            sc, media.MODE_TR, idx, ro, rd, tmax, key,
            static.med_iter_max)}, min_reps=1)
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    span_ = lambda v: f"{min(v):.4f}-{max(v):.4f}"  # noqa: E731
    # bounds: entry 1 reads 32 B of ray + the majorant table once and
    # writes 42 floats per ray; 43 points x 16 flops + 42 x 10 per ray
    b1 = bound(n * (32 + 4 * media.NSEG) + sv_max.numel() * 4,
               n * (43 * 16 + media.NSEG * 10))
    n_cand = int(cand.sum())
    walks = walking_lanes(scene, idx, ro, rd, tmax)
    b2 = walk_bound(scene, idx, ro, rd, tmax, n_cand)
    print(f"[E] segment_majorants (K5's function), 1M rays x 42 segments: "
          f"kernel {mean(t['kernel']):.4f} ms (windows {span_(t['kernel'])}),"
          f" plain {mean(t['plain']):.4f} ms ({span_(t['plain'])}), "
          f"med_sv_max[idx] on the [1M, 42] indices "
          f"{mean(t['library']):.4f} ms ({span_(t['library'])}); bound "
          f"{b1['bound_ms']:.4f} ms by {b1['bound_by']} ({card})")
    print(f"[E] track, tr mode (ratio), 1M phase-B rays ({n_cand} "
          f"candidates, {int(walks.sum())} lanes walk): kernel "
          f"{mean(w['kernel']):.4f} ms (windows {span_(w['kernel'])}), plain "
          f"{mean(w['plain']):.4f} ms ({span_(w['plain'])}); bound "
          f"{b2['bound_ms']:.4f} ms by {b2['bound_by']} ({card})")
    records["track"].update(
        ms=mean(t["kernel"]), plain_ms=mean(t["plain"]),
        library_ms=mean(t["library"]), **b1,
        walk_ms=mean(w["kernel"]), walk_plain_ms=mean(w["plain"]),
        walk_bound_ms=b2["bound_ms"], walk_bound_by=b2["bound_by"],
        walk_candidates=n_cand)

    # the walk on the main path's own call (captured in phase D)
    if "args" in MAIN_WALK:
        sc, mode, m_idx, m_ro, m_rd, m_tmax, m_key, it_max = MAIN_WALK["args"]
        _, m_cand = media_cuda.track_cuda(sc, mode, m_idx, m_ro, m_rd, m_tmax,
                                          m_key, it_max)
        wm = timed_windows({
            "kernel": lambda: media_cuda.track_cuda(
                sc, mode, m_idx, m_ro, m_rd, m_tmax, m_key, it_max),
            "plain": lambda: media._track_torch(
                sc, mode, m_idx, m_ro, m_rd, m_tmax, m_key, it_max)},
            min_reps=1)
        m_walks = int(walking_lanes(sc, m_idx, m_ro, m_rd, m_tmax).sum())
        bm = walk_bound(sc, m_idx, m_ro, m_rd, m_tmax, int(m_cand.sum()))
        print(f"[E] track on the VPT main path's first Tr walk of step 1 "
              f"({m_idx.numel()} lanes, {m_walks} walk, "
              f"{int(m_cand.sum())} candidates): kernel "
              f"{mean(wm['kernel']):.4f} ms (windows {span_(wm['kernel'])}),"
              f" plain {mean(wm['plain']):.4f} ms ({span_(wm['plain'])}); "
              f"bound {bm['bound_ms']:.4f} ms by {bm['bound_by']} ({card})")
        records["track"].update(
            walk_main_ms=mean(wm["kernel"]),
            walk_main_plain_ms=mean(wm["plain"]),
            walk_main_bound_ms=bm["bound_ms"],
            walk_main_bound_by=bm["bound_by"], walk_main_lanes=m_walks)


def walk_bound(scene, med_idx, ro, rd, tmax, n_cand) -> dict:
    """The walk's bound on these lanes, bytes counted by lane class: every
    lane reads its 4 B medium index and writes 8 B (out, candidates); a
    lane in a heterogeneous medium also reads its 28 B of ray (ro, rd,
    tmax) to clip it to the box; a lane that walks also reads its 8 B
    int64 lane id. Plus a 16-byte density row per candidate (at most the
    table once), the medium records and the majorant table once. ~80
    flops per candidate and, on the lanes that walk, 20 per segment (one
    segment point of three divisions and ~12 other operations, the floor
    and the optical depth: the other end of the segment is the last
    one's), counted for all 42 segments. The Philox draws (integer work)
    are not counted."""
    from gpu_pathtracer_tpu_torch.shade import media
    med = media.gather_medium(scene, med_idx)
    het = int(((med_idx >= 0) & (med["type"] == media.HETEROGENEOUS)).sum())
    n_walk = int(walking_lanes(scene, med_idx, ro, rd, tmax).sum())
    table_b = scene.med_density_oct4.numel() * 4
    return bound(med_idx.numel() * 12 + het * 28 + n_walk * 8
                 + min(n_cand * 16, table_b) + scene.med_table.numel() * 4
                 + scene.med_sv_max.numel() * 4,
                 n_cand * 80 + n_walk * media.NSEG * 20)


# ---------------------------------------------------------------- phase F

# checkpoint resume at 1024^2 depth 5: (integrator, scene, kernels)
CKPT_F = (("pt", SCENES[0], ("pt_fused", "rng")),
          ("pt", KNOT["scene"], ("bvh8_walk", "pt_shade", "rng")),
          ("vpt", SMOKE, VPT_KERNELS),
          ("ir", SCENES[0], ("dense_hit", "rng")),
          ("sppm", SCENES[0], ("dense_hit", "rng")),
          ("mlt", SCENES[0], ("pt_fused", "rng")))
# sharded renders at 1024^2 depth 5, 2 iterations: (integrator, scene,
# kernels)
SHARD_F = (("pt", SCENES[0], ("pt_fused", "rng")),
           ("vpt", SMOKE, VPT_KERNELS),
           ("lt", SCENES[0], ("dense_hit", "rng")),
           ("bdpt", SCENES[0], ("dense_hit", *BDPT_KERNELS)),
           ("ir", SCENES[0], ("dense_hit", "rng")),
           ("sppm", SCENES[0], ("dense_hit", "rng")),
           ("mlt", SCENES[0], ("pt_fused", "rng")))
BIT_EQUAL_F = ("pt", "vpt", "ir")   # kinds whose film equals bit for bit
F_TIMEOUT_S = 300   # a spawned rank's limit
# the collectives' bootstrap sockets stay on the loopback interface
LOOPBACK = {"NCCL_SOCKET_IFNAME": "lo", "GLOO_SOCKET_IFNAME": "lo"}


def f_dir() -> str:
    """Phase F's scratch directory (checkpoints, stores, rank outputs),
    emptied at the end of the phase."""
    path = os.path.join(REPO, "build", "phase_f")
    os.makedirs(path, exist_ok=True)
    return path


def f_renderer(integ, path, dev, shard=False):
    """Renderer of program `integ` on the scene at `path`, 1024^2 (the
    scenes' own size), depth 5, seed SEED."""
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    return Renderer(os.path.join(REPO, path), seed=SEED, device=dev,
                    integrator=IntegratorType[integ.upper()], max_depth=5,
                    shard=shard)


def f_counts(label, stats, knames) -> dict:
    """The launches since the counts were set to 0: each of `knames`
    launched, no other kernel, no plain version on CUDA."""
    counts = {k: st.launches for k, st in stats.items()}
    plain = sum(st.plain_cuda for st in stats.values())
    check(only(counts, *knames), f"{label}: launches {counts}")
    check(plain == 0, f"{label}: {plain} plain-version calls on CUDA")
    return {k: counts[k] for k in knames}


def phase_f_checkpoint(dev, card) -> None:
    """Each CKPT_F path renders 2 iterations, saves, renders 2 more; a
    new renderer loads the file and renders 2: PT, VPT and IR bit-equal,
    SPPM and MLT within the radiance limits (their deposits and splats
    add in no fixed order on the card) with SPPM's radius and photon
    statistic and MLT's chain luminance equal."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        kernel_stats, reset_counts)
    from gpu_pathtracer_tpu_torch.geom import packet_cuda
    from gpu_pathtracer_tpu_torch.run import checkpoint as ckpt
    stats = kernel_stats()
    for integ, path, knames in CKPT_F:
        label = f"F {integ} {path} resumed"
        f = os.path.join(f_dir(), f"{integ}.npz")
        reset_counts(*stats.values())
        a = f_renderer(integ, path, dev)
        a.render(2)
        torch.cuda.synchronize()
        t0 = time.time()
        ckpt.save_checkpoint(a, f)
        t_write = time.time() - t0
        mb = os.path.getsize(f) / 2**20
        a.render(2)
        b = f_renderer(integ, path, dev)
        torch.cuda.synchronize()
        t0 = time.time()
        ckpt.load_checkpoint(b, f)
        torch.cuda.synchronize()
        t_read = time.time() - t0
        check(b.iteration == 2, f"{label}: iteration {b.iteration}")
        b.render(2)
        torch.cuda.synchronize()
        counts = f_counts(label, stats, knames)
        print(f"[F] {integ} on {path} ({a.kind} kind), 1024x1024 depth 5: "
              f"checkpoint at 2 of 4 iterations, {mb:.3f} MB, write "
              f"{t_write:.6f} s, read {t_read:.6f} s ({card}); launches "
              f"{counts}, plain-version calls on CUDA 0")
        if integ in BIT_EQUAL_F:
            same = (a.acc == b.acc).all(1).float().mean().item()
            print(f"[F] {integ} {path} resumed vs uninterrupted: bit-equal "
                  f"on {same:.6f} of {a.acc.shape[0]} pixels")
            check(torch.equal(a.acc, b.acc), f"{label}: film differs")
        elif integ == "sppm":
            st_a, st_b = a._sppm_state, b._sppm_state
            check(torch.equal(st_a.radius, st_b.radius)
                  and torch.equal(st_a.n, st_b.n),
                  f"{label}: radius or photon statistic differs")
            hold_radiance(label, "radiance", b.acc, a.acc)
        else:
            check(torch.equal(a._mlt_state["lum"], b._mlt_state["lum"]),
                  f"{label}: chain luminance differs")
            hold_radiance(label, "film", b.acc, a.acc)
        check(bool(torch.isfinite(b.acc).all()) and b.acc.sum() > 0,
              f"{label}: film not finite or black")
        packet_cuda.check_overflow()
        os.remove(f)
        del a, b


class ReduceTimer:
    """Wraps torch.distributed.all_reduce (which parallel/dist.py calls)
    to add up its calls' milliseconds, the card synchronised around each
    call."""

    def __init__(self):
        self.ms, self.calls = 0.0, 0
        self._orig = torch.distributed.all_reduce

    def __enter__(self):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t0) * 1e3
            self.calls += 1
            return out
        torch.distributed.all_reduce = timed
        return self

    def __exit__(self, *exc):
        torch.distributed.all_reduce = self._orig


def f_arrays(r) -> dict:
    """What phase F compares of a renderer, whole, as numpy (a collective
    on a sharded renderer): the film, the rays, SPPM's radius and photon
    statistic, MLT's chain luminance."""
    out = {"film": r.film().cpu().numpy(), "rays": int(r.rays)}
    if r.kind == "sppm":
        out.update(radius=r._sppm_state.radius.cpu().numpy(),
                   n=r._sppm_state.n.cpu().numpy())
    if r.kind == "mlt":
        out["lum"] = r.shard.gather(r._mlt_state["lum"],
                                    r.width * r.height).cpu().numpy()
    return out


def f_sharded(integ, path, knames, dev, stats) -> tuple:
    """Program `integ` sharded over the current group for 2 iterations:
    (f_arrays, launches, reduction ms per iteration, ms of the read)."""
    from gpu_pathtracer_tpu_torch.run.reference import reset_counts
    r = f_renderer(integ, path, dev, shard=True)
    reset_counts(*stats.values())
    with ReduceTimer() as t_it:
        for _ in range(2):
            r.render_iteration()
    with ReduceTimer() as t_read:
        arrays = f_arrays(r)
    torch.cuda.synchronize()
    counts = f_counts(f"F {integ} sharded, rank {r.shard.rank}", stats,
                      knames)
    from gpu_pathtracer_tpu_torch.geom import packet_cuda
    packet_cuda.check_overflow()
    return arrays, counts, t_it.ms / 2, t_it.calls, t_read.ms


def hold_sharded(label, integ, got, ref) -> None:
    """A sharded render against one rank's: the rays equal; PT, VPT and
    IR bit-equal; LT and BDPT within the radiance limits; SPPM's radius
    and photon statistic equal, its film within the limits; MLT's chain
    luminance equal, its film within the limits."""
    check(got["rays"] == ref["rays"],
          f"{label}: rays {got['rays']} vs {ref['rays']}")
    a, b = torch.as_tensor(got["film"]), torch.as_tensor(ref["film"])
    if integ in BIT_EQUAL_F:
        same = (a == b).all(1).float().mean().item()
        print(f"[F] {label[2:]}: bit-equal on {same:.6f} of {a.shape[0]} "
              f"pixels")
        check(torch.equal(a, b), f"{label}: film differs")
        return
    if integ == "sppm":
        check(np.array_equal(got["radius"], ref["radius"])
              and np.array_equal(got["n"], ref["n"]),
              f"{label}: radius or photon statistic differs")
    if integ == "mlt":
        check(np.array_equal(got["lum"], ref["lum"]),
              f"{label}: chain luminance differs")
    hold_radiance(label, "film" if integ in ("lt", "mlt") else "radiance",
                  a, b)


def f_references(dev) -> dict:
    """{integ: f_arrays} of SHARD_F rendered unsharded, 2 iterations."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        kernel_stats, reset_counts)
    stats = kernel_stats()
    ref = {}
    for integ, path, knames in SHARD_F:
        reset_counts(*stats.values())
        r = f_renderer(integ, path, dev)
        for _ in range(2):
            r.render_iteration()
        ref[integ] = f_arrays(r)
        f_counts(f"F {integ} unsharded", stats, knames)
        del r
    return ref


def phase_f_shard(dev, card) -> None:
    """SHARD_F one rank unsharded (the reference), then through
    Renderer(shard=True) on a world of 1 on NCCL (in this process) and
    on 2 gloo ranks spawned on cuda:0; then whether NCCL takes 2 ranks on
    one card."""
    from gpu_pathtracer_tpu_torch.run.reference import kernel_stats
    from gpu_pathtracer_tpu_torch.parallel import dist
    os.environ.update(LOOPBACK)
    stats = kernel_stats()
    ref = f_references(dev)
    store = os.path.join(f_dir(), "store_nccl_1")
    dist.init("nccl", f"file://{store}", 0, 1, timeout_s=F_TIMEOUT_S)
    try:
        with ReduceTimer() as setup:   # NCCL makes its communicator here
            torch.distributed.all_reduce(torch.ones(1, device=dev))
        print(f"[F] one NCCL rank: the first all_reduce (communicator "
              f"set-up) {setup.ms:.3f} ms ({card})")
        for integ, path, knames in SHARD_F:
            got, counts, ms_it, calls, ms_read = f_sharded(
                integ, path, knames, dev, stats)
            print(f"[F] {integ} on {path}, 1 NCCL rank: launches {counts}, "
                  f"plain 0; reductions {ms_it:.3f} ms per iteration "
                  f"({calls} all_reduce calls in 2), read {ms_read:.3f} ms "
                  f"({card})")
            hold_sharded(f"F {integ} 1 NCCL rank vs unsharded", integ, got,
                         ref[integ])
    finally:
        torch.distributed.destroy_process_group()

    hold_ranks("gloo", 2, "2 gloo ranks on cuda:0", ref)
    rc, log = torchrun(2, ["--rank-of", "nccl-pair", f_dir()], 120)
    said = [ln for ln in log.splitlines() if "Duplicate" in ln
            or "all_reduce gave" in ln or "Error" in ln][:3]
    print(f"[F] NCCL, 2 ranks on cuda:0 (torchrun): exit {rc}: "
          + " | ".join(ln.strip()[:300] for ln in said))


def f_rank(kind: str, out: str) -> None:
    """A rank of phase F that torchrun started. "gloo": one of 2 gloo
    ranks on cuda:0, and "nccl" (--cards): one NCCL rank a card, each
    rendering SHARD_F sharded over the group, rank 0 writing the arrays
    to compare to out/<kind>_<integ>.npz; "nccl-pair": one of 2 NCCL
    ranks on cuda:0, one all_reduce."""
    from gpu_pathtracer_tpu_torch.run.reference import kernel_stats
    from gpu_pathtracer_tpu_torch.parallel import dist
    card = card_line()
    dev = torch.device("cuda", dist.local_rank() if kind == "nccl" else 0)
    torch.cuda.set_device(dev)
    rank, world = dist.init("gloo" if kind == "gloo" else "nccl",
                            timeout_s=60 if kind == "nccl-pair"
                            else F_TIMEOUT_S)
    with ReduceTimer() as setup:
        x = torch.ones(1, device=dev)
        torch.distributed.all_reduce(x)
    where = f"{kind} rank {rank} of {world} on {dev}"
    print(f"[F] {where}: the first all_reduce {setup.ms:.3f} ms, all_reduce "
          f"gave {x.item()}", flush=True)
    if kind != "nccl-pair":
        stats = kernel_stats()
        for integ, path, knames in SHARD_F:
            got, counts, ms_it, calls, ms_read = f_sharded(
                integ, path, knames, dev, stats)
            print(f"[F] {integ} on {path}, {where}: launches {counts}, plain "
                  f"0; reductions {ms_it:.3f} ms per iteration ({calls} "
                  f"all_reduce calls in 2), read {ms_read:.3f} ms ({card})",
                  flush=True)
            if rank == 0:
                np.savez(os.path.join(out, f"{kind}_{integ}.npz"), **got)
    torch.distributed.destroy_process_group()


def torchrun(n: int, args: list, timeout: float, module=False):
    """Run this script (or with module=True, `-m args[0]`) as n ranks
    under torchrun in a session of its own, from the repository, with
    the collectives' sockets on loopback; past `timeout` seconds the
    whole session is killed and the phase fails. Returns (exit code,
    output)."""
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}"]
    cmd += (["-m"] if module else [os.path.abspath(__file__)]) + args
    if not module:
        cmd += ["--out", OUT]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO, **LOOPBACK),
                         start_new_session=True)
    try:
        log = p.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        fail(f"torchrun {' '.join(args[:3])} ... ran past {timeout} s")
    return p.returncode, log


def hold_ranks(kind: str, n: int, what: str, ref: dict) -> None:
    """SHARD_F over n ranks of `kind` under torchrun (f_rank), each held
    against the unsharded render `ref`."""
    rc, log = torchrun(n, ["--rank-of", kind, f_dir()], 2 * F_TIMEOUT_S)
    print(log.rstrip())
    check(rc == 0, f"F {what}: torchrun exited {rc}")
    for integ, _, _ in SHARD_F:
        got = dict(np.load(os.path.join(f_dir(), f"{kind}_{integ}.npz")))
        got["rays"] = int(got["rays"])
        hold_sharded(f"F {integ} {what} vs unsharded", integ, got,
                     ref[integ])


def phase_f_cards(dev, card, n: int) -> None:
    """--cards n (n cards): SHARD_F on one card unsharded, then sharded
    over n NCCL ranks started by torchrun, one a card, each held as in
    phase_f_shard; then the CLI's PT on cornell_port, 2 spp, on one card
    and under torchrun with --shard: the two checkpoints' films
    bit-equal."""
    from gpu_pathtracer_tpu_torch.run import cli
    check(torch.cuda.device_count() >= n,
          f"--cards {n}: {torch.cuda.device_count()} cards")
    hold_ranks("nccl", n, f"{n} NCCL ranks, one a card", f_references(dev))
    out = f_dir()
    args = [os.path.join(REPO, SCENES[0]), "--spp", "2", "--seed", str(SEED)]
    one, many = (os.path.join(out, f"cli_{k}.npz") for k in ("one", "many"))
    cli.main(args + ["--checkpoint", one, "--out",
                     os.path.join(OUT, "cli_one.png")])
    rc, log = torchrun(n, ["gpu_pathtracer_tpu_torch.run.cli", *args,
                           "--shard", "--checkpoint", many, "--out",
                           os.path.join(OUT, "cli_many.png")], F_TIMEOUT_S,
                       module=True)
    print(log.rstrip())
    check(rc == 0 and f"[shard] {n} rank(s)" in log,
          f"F the CLI under torchrun, {n} ranks: exit {rc}")
    with np.load(one) as a, np.load(many) as b:
        same = np.array_equal(a["acc"], b["acc"])
        print(f"[F] the CLI's PT on {SCENES[0]}, 2 spp: {n} ranks' "
              f"checkpoint film bit-equal to one card's: {same} ({card})")
        check(same, f"F the CLI under torchrun, {n} ranks: film differs")


def phase_f_profile(dev, card) -> None:
    """--profile through the CLI for 1 spp of cornell_port: the trace
    names K2's kernel."""
    from gpu_pathtracer_tpu_torch.run.reference import (
        kernel_stats, reset_counts)
    from gpu_pathtracer_tpu_torch.run import cli
    stats = kernel_stats()
    prof = os.path.join(f_dir(), "profile")
    reset_counts(*stats.values())
    cli.main([os.path.join(REPO, SCENES[0]), "--spp", "1", "--seed",
              str(SEED), "--out", os.path.join(OUT, "profiled.png"),
              "--profile", prof])
    counts = f_counts("F --profile", stats, ("pt_fused", "rng"))
    trace = os.path.join(prof, "trace_rank0.json")
    check(os.path.exists(trace), f"--profile wrote no {trace}")
    with open(trace) as f:
        text = f.read()
    n = text.count("pt_fused_kernel")
    print(f"[F] --profile: {trace}, {len(text) / 2**20:.3f} MB, names "
          f"pt_fused_kernel {n} times; launches {counts} ({card})")
    check(n > 0, "the --profile trace does not name K2's pt_fused_kernel")


def phase_f(dev, card) -> None:
    import shutil
    t0 = time.time()
    phase_f_checkpoint(dev, card)
    t1 = time.time()
    phase_f_shard(dev, card)
    t2 = time.time()
    phase_f_profile(dev, card)
    shutil.rmtree(f_dir())
    print(f"[F] done in {time.time() - t0:.1f} s: checkpoints "
          f"{t1 - t0:.1f} s, sharding {t2 - t1:.1f} s, profile "
          f"{time.time() - t2:.1f} s")


# phase G: the golden suite's runner (run/golden.py) at the suite's own
# settings over repo scenes whose goldens it writes all-plain
# (reference.plain_image): (name, scene, integrator, the kernels its run
# launches, golden height, golden spp, supersampling factor, the rest of
# its GOLDENS entry; "mask": golden._smoke_mask)
G_SIZE, G_SPP = 256, 128   # golden.main's defaults
GOLDEN_G = (
    # the same size, spp and seed: the run differs from its golden by the
    # golden's 8-bit rounding and the lanes where K2 and plain part
    ("cornell_port", SCENES[0], "pt", ("pt_fused",), G_SIZE, G_SPP, 1,
     {"gate": 0.01}),
    # the plain VPT's tracking walk syncs the host every round: one spp
    # at 1024^2 took 19.7-21.7 s on the H100, and 128 at 256^2 did not
    # end in 550 s (PERF.md §6). So one spp at 1024^2, averaged
    # down by 4 before the tonemap: 16 samples a pixel. The
    # RMSE is the two images' noise: 0.0909 on the H100 (PERF.md §6),
    # gated with a 10% margin
    ("smoke_port", SMOKE, "vpt", VPT_KERNELS, G_SIZE, 1, 4,
     {"gate": 0.1, "mask": True}),
    # written at 1280x720, so run_one's resample to 455x256 takes the BOX.
    # The RMSE is mostly the run's own noise on the sky-lit ground: 0.1076
    # with a 16-spp golden, 0.1004 with 64 spp on the H100 (PERF.md, PR
    # 20), gated 7% above the larger
    ("env_port", K2_VARIANTS["env"], "pt", ("pt_fused",), 720, 32, 1,
     {"gate": 0.115, "aspect": (16, 9)}),
)
GOLDEN_TPU = "GOLDEN_r5.json"   # the JAX package's RMSEs, on its TPU


def phase_g(dev, card, records) -> None:
    """The golden runner: each stand-in of GOLDEN_G through golden.run_one
    over the kernels, with every launch count set to 0 just before it and
    read just after, against a golden written by run/reference.py's
    all-plain route at the same seed; then the real suite where its
    goldens exist."""
    import tempfile
    from gpu_pathtracer_tpu_torch.film.imageio import save_png
    from gpu_pathtracer_tpu_torch.run import golden
    from gpu_pathtracer_tpu_torch.run.reference import (
        kernel_stats, plain_image, reset_counts)
    from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="golden_", dir=OUT)
    stats = kernel_stats()
    for name, scene, integ, knames, g_h, g_spp, g_f, extra in GOLDEN_G:
        path = os.path.join(REPO, scene)
        aw, ah = extra.get("aspect", (1, 1))
        host = load_scene(path)
        host.width, host.height = g_f * g_h * aw // ah, g_f * g_h
        sc, st = flatten_scene(host, dev)
        t1 = time.time()
        img = plain_image(integ, sc, st, 0, g_spp, g_f)
        g_s = time.time() - t1
        del sc, st
        cfg = dict(extra, scene=path, integrator=integ,
                   golden=os.path.join(tmp, f"{name}_golden.png"))
        if extra.get("mask"):
            cfg["mask"] = golden._smoke_mask
        save_png(cfg["golden"], img)
        reset_counts(*stats.values())
        t1 = time.time()
        rmse, ok = golden.run_one(name, cfg, G_SPP, G_SIZE, out=tmp)
        run_s = time.time() - t1
        counts = {k: s.launches for k, s in stats.items()}
        plain = sum(s.plain_cuda for s in stats.values())
        print(f"[G] {name} ({scene}, {integ}) at {G_SIZE * aw // ah}x"
              f"{G_SIZE}, {G_SPP} spp: RMSE {rmse:.6f} against gate "
              f"{cfg['gate']} ({'PASS' if ok else 'FAIL'}), run_one "
              f"{run_s:.3f} s; golden all-plain at {g_h * aw // ah}x{g_h}, "
              f"{g_spp} spp x {g_f * g_f} samples a pixel, in {g_s:.3f} s; "
              f"launches {counts}, "
              f"plain-version calls on CUDA {plain} ({card})", flush=True)
        check(ok, f"golden stand-in {name}: RMSE {rmse} >= {cfg['gate']}")
        check(only(counts, *knames),
              f"golden stand-in {name} launched {counts}")
        check(plain == 0, f"golden stand-in {name}: {plain} plain calls")
        for k in knames:
            records[k][f"launches_golden_{name}"] = counts[k]

    if not os.path.isdir(golden.RESULT):
        print(f"[G] {golden.RESULT} is absent: the five real goldens were "
              f"not run")
    else:
        out = os.path.join(tmp, "golden.json")
        code = 0
        try:   # it writes the JSON before it exits 1 for a FAIL
            golden.main(["--spp", str(G_SPP), "--size", str(G_SIZE),
                         "--out", tmp, "--json", out])
        except SystemExit as e:
            code = e.code
        with open(os.path.join(REPO, GOLDEN_TPU)) as f:
            tpu = json.load(f)["results"]
        with open(out) as f:
            res = json.load(f)["results"]
        for name, r in res.items():
            print(f"[G] golden {name}: RMSE {r['rmse']} "
                  f"({'PASS' if r['pass'] else 'FAIL'}) on this card "
                  f"({card}), {tpu.get(name, {}).get('rmse')} on the JAX "
                  f"package's TPU ({GOLDEN_TPU})")
        check(code == 0, f"the golden suite failed (exit {code})")
    print(f"[G] done in {time.time() - t0:.1f} s; renders and goldens in "
          f"{tmp}")


def main() -> None:
    global OUT, BASELINE
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="ABCDEFGRSVT",
                    help="phases to run after the build (default all)")
    ap.add_argument("--out", default=OUT,
                    help="directory for the PNGs and compiler reports")
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="another checkout of the port (e.g. a git archive "
                    "of the parent commit): phase E also times its K1, K2, "
                    "K3 and K4, phase S its pt_shade, phase V its vpt_shade "
                    "and vpt_tr_round and phase T its bdpt_step, "
                    "bdpt_connect and bdpt_finish beside this checkout's "
                    "on the same inputs")
    ap.add_argument("--time-hits", nargs=2, metavar=("INPUTS", "ROOT"),
                    help=argparse.SUPPRESS)   # --baseline's child processes
    ap.add_argument("--cards", type=int, default=1,
                    help="with N > 1: build, then only phase F's sharded "
                    "renders over N NCCL ranks under torchrun, one a card, "
                    "and the CLI under torchrun (needs N cards)")
    ap.add_argument("--rank-of", nargs=2, metavar=("KIND", "OUT"),
                    help=argparse.SUPPRESS)   # phase F's ranks (f_rank)
    args = ap.parse_args()
    phases = args.phases.upper()
    OUT = os.path.abspath(args.out)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a GPU")
    if args.time_hits:
        time_hits(*args.time_hits)
        return
    if args.rank_of:
        sys.path.insert(0, REPO)
        os.environ["GPT_TORCH_CACHE_DIR"] = os.path.join(OUT, "bvh_cache")
        f_rank(*args.rank_of)
        return
    if args.baseline:
        BASELINE = os.path.abspath(args.baseline)
        check(any(p in phases for p in "ESTV"),
              "--baseline times in phases E, S, T and V")
    card = card_line()
    print(card, flush=True)
    sys.path.insert(0, REPO)
    try:
        from gpu_pathtracer_tpu_torch import kernels
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    os.makedirs(OUT, exist_ok=True)
    # the BVH disk cache of this run, under --out (phase D empties it)
    os.environ["GPT_TORCH_CACHE_DIR"] = os.path.join(OUT, "bvh_cache")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    records = {
        ("dense_hit" if name == "dense" else name): {
            "name": "dense_hit" if name == "dense" else name,
            "route": "cuda", "source": src, "replaces": tpu}
        for name, (src, tpu) in KERNELS.items()}

    t0 = time.time()
    kernels.build(libraries())
    for name in libraries():
        b = kernels.BUILDS[name]
        print(f"[A] built {name} in {b.seconds:.2f} s: "
              f"{ptxas_summary(b.ptxas) or 'cached'}")
        with open(os.path.join(OUT, f"ptxas_{name}.txt"), "w") as f:
            f.write(b.ptxas)
    from gpu_pathtracer_tpu_torch.geom import bvh_native
    bvh_native.load()
    b = bvh_native.BUILD_INFO
    print(f"[A] built bvh_builder (g++) in {b.seconds:.2f} s: {b.path}")
    print(f"[A] builds done in {time.time() - t0:.2f} s")

    if args.cards > 1:
        import shutil
        phase_f_cards(dev, card, args.cards)
        shutil.rmtree(f_dir())
        print(f"[--cards {args.cards}] done: a partial run prints no result")
        sys.exit(0)
    if "B" in phases:
        phase_b(dev, rng, records)
    if "C" in phases:
        phase_c(dev, rng, records)
    if "R" in phases:
        phase_r(dev, card, records)
    if "S" in phases:
        phase_s(dev, rng, card, records)
    if "V" in phases:
        phase_v(dev, card, records)
    if "T" in phases:
        phase_t(dev, card, records)
    if "D" in phases:
        phase_d(dev, card, records)
    if "E" in phases:
        phase_e(dev, rng, card, records)
    if "F" in phases:
        phase_f(dev, card)
    if "G" in phases:
        phase_g(dev, card, records)
    if set(phases) != set("ABCDEFGRSVT"):
        print(f"[{phases}] done: a partial run prints no result")
        sys.exit(0)

    need = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    for rec in records.values():
        missing = [k for k in need if k not in rec]
        check(not missing, f"kernel record {rec['name']} lacks {missing}")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
