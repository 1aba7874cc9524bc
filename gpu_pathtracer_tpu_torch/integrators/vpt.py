"""Volumetric path tracer (the reference Volpath kernel, pathtracer.cu:
1025-1242).

The port of gpu_pathtracer_tpu/integrators/vpt.py: PT plus participating
media.
- Each step samples a distance in the lane's current medium
  (shade/media.py::medium_sample).
- A medium interaction does phase-function NEE, its shadow ray
  attenuated by the interface-walking transmittance, then samples the
  phase function.
- Material-less hits (matIdx == -1) are medium interfaces: the ray
  passes through, switching media by crossing side, without consuming a
  bounce (pathtracer.cu:1117-1124); the loop has INTERFACE_BUDGET extra
  steps for them.
- Surface NEE attenuates by transmittance instead of a binary shadow
  test, and the next medium follows the crossing side
  (pathtracer.cu:1224-1226).
- The camera may start inside a medium (pathtracer.cu:1043).
- A ray that misses sees the environment light on primary and specular
  bounces, and MIS weighted after a surface's BSDF sample; NEE picks
  the sky's slot of the light CDF like an area light's (vpt.py:49-76,
  137-149).

Estimator (as the JAX package's): the continuation BSDF sample is also
the MIS sample, credited on arrival at the next intersection, attenuated
by the distance-sampling weights of the segments actually crossed;
phase-sampled continuations get no arrival credit.

Random numbers (core/rng.py): sites 0-3 are the camera, step s reads the
sites 4 + 16 s + k of its three scopes (VPT_MEDIUM, VPT_SCATTER,
VPT_SURFACE), and its tracking walks draw at track_tag(s, call site,
walk segment). Every draw is keyed by the lane's pixel index, so the
image does not depend on tiling.

A step (integrators/vpt_shade.py) is the closest hit, the sample walk
(heterogeneous media), the shading step, then TR_MAX_SEGMENTS rounds of
one transmittance walk a lane: the medium-scatter NEE ray, the surface
NEE ray or the segment to a full-credit emitter hit, whichever the lane
made, each drawing at track_tag(step, its call site, segment) as a walk
of its call site alone would. The credit a walk attenuates waits for it
and is added at the start of the next step (`vpt_shade.finish` after the
last), in the order the step forms it.

On CUDA tensors a step launches the scene's intersection kernel
(geom/traverse.py), the tracking kernel (csrc/track.cu) and the step's
kernels (csrc/vpt_shade.cu), never the megakernel, and no masked
PyTorch op runs between them; every step and every round runs: lanes that finished get
an empty interval, so no host sync gates the loop (the JAX package's
`lax.cond(jnp.any(...))` skips). The step's kernels update one lane state
and one walk in place, each launch over a list of lane rows that the
launch before it built on the device (vpt_shade.py). On CPU tensors, or
with `plain`, the plain versions run and the loops stop once no lane is
alive or walking, which changes no result.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.core.rng import (
    PSS_CAM_DIMS, TRACK_SAMPLE, lane_stream, track_tag,
)
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators import vpt_shade
from gpu_pathtracer_tpu_torch.integrators.common import primary_rays
from gpu_pathtracer_tpu_torch.integrators.pt import lane_ids_of
from gpu_pathtracer_tpu_torch.shade import media as media_mod
from gpu_pathtracer_tpu_torch.shade.media import TrackKey

INTERFACE_BUDGET = vpt_shade.INTERFACE_BUDGET   # extra steps for interfaces

def render_lanes(scene, static, seed: int, iteration: int, pixel_x, pixel_y,
                 with_stats: bool = False, plain: bool = False):
    """Per-lane radiance [N, 3] of one volumetric-PT sample per lane.

    with_stats=True also returns the rays traced (closest hits and Tr
    walk segments) as a 0-d int64 tensor on the lanes' device. `plain`
    runs the plain PyTorch intersection, tracking and shading on any
    device (the reference path)."""
    lanes = lane_ids_of(static, pixel_x, pixel_y)
    ro, rd = primary_rays(
        scene, static, lane_stream(seed, iteration, lanes, None, 0,
                                   PSS_CAM_DIMS, plain=plain),
        pixel_x, pixel_y)
    eps = scene.epsilon
    lane = vpt_shade.start(scene, static, ro, rd)
    rays = torch.zeros((), dtype=torch.int64, device=ro.device)
    gate = plain or not ro.is_cuda
    walk = walk_out = None
    for it in range(vpt_shade.n_steps(static)):
        if gate and not bool(((lane.flags & vpt_shade.ALIVE) != 0).any()):
            break
        # finished lanes get an empty interval (tmax 0 < eps): the hit
        # kernels leave them at once
        t, prim, _ = traverse.closest_prim(scene, static, lane.ro, lane.rd,
                                           eps, lane.tmax, plain)
        found_t = None
        if static.has_hetero:   # delta tracking's first collision in [0, t]
            found_t, _ = media_mod.track(
                scene, static, media_mod.MODE_SAMPLE, lane.med_sample,
                lane.ro, lane.rd, t,
                TrackKey(seed, iteration, lanes, track_tag(it, TRACK_SAMPLE)),
                plain)
        lane, walk = vpt_shade.shade(scene, static, it, seed, iteration,
                                     lanes, t, prim, lane, found_t, walk,
                                     walk_out, rays, plain)
        walk_out = None
        # the step's walk through interfaces (pathtracer.cu:298-322)
        for seg in range(media_mod.TR_MAX_SEGMENTS):
            if gate and not bool(((walk.flags & (vpt_shade.WALKING
                                                  | vpt_shade.EMIT)) != 0)
                                 .any()):
                break
            t, prim, _ = traverse.closest_prim(scene, static, walk.o, walk.d,
                                               eps, walk.tmax, plain)
            nxt = vpt_shade.tr_round(scene, static, t, prim, walk, walk_out,
                                     rays, plain)
            if static.has_hetero:
                walk_out, _ = media_mod.track(
                    scene, static, media_mod.MODE_TR, nxt.track_med,
                    nxt.track_o, walk.d, nxt.track_t,
                    TrackKey(seed, iteration, lanes, track_tag(it, 0, seg),
                             walk.sites), plain)
            walk = nxt
    li = vpt_shade.finish(lane.li, walk, walk_out, plain)
    if with_stats:
        return li, rays
    return li
