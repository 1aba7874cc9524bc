"""Ambient occlusion (the reference Ao kernel, pathtracer.cu:830-877).

The port of gpu_pathtracer_tpu/integrators/ao.py: one primary ray per
lane, its closest hit, then one cosine-weighted probe from the hit whose
any-hit interval ends at the scene's `maxDist` (StaticConfig.max_dist).
A lane whose primary ray missed gets an empty probe interval (tmax 0),
so the hit kernels (K1, K3, K4 by the scene's regime) drop it at once.

Random numbers (core/rng.py): the lane id is the pixel index; sites 0-3
are the camera (pixel jitter x, y, aperture u1, u2) and sites 4-5 the
probe's (u1, u2), AO_DIMS in all, so the image does not depend on
tiling. An explicit primary-sample matrix `psample [AO_DIMS, N]` is read
row for row instead.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.core.rng import lane_stream
from gpu_pathtracer_tpu_torch.core.sampling import cosine_hemisphere
from gpu_pathtracer_tpu_torch.core.vecmath import (
    INV_PI, cross, dot, face_forward, to_world,
)
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators.common import primary_rays
from gpu_pathtracer_tpu_torch.integrators.pt import lane_ids_of

AO_DIMS = 6   # random sites per lane: camera 0-3, probe 4-5


def render_lanes(scene, static, seed: int, iteration: int, pixel_x, pixel_y,
                 with_stats: bool = False, psample=None, plain: bool = False):
    """Per-lane AO [N, 3] of one sample per lane. with_stats=True also
    returns the rays traced (closest hits + probes) as a 0-d int64
    tensor; `plain` runs the plain PyTorch intersection on any device."""
    lanes = lane_ids_of(static, pixel_x, pixel_y)
    rng = lane_stream(seed, iteration, lanes, psample, 0, AO_DIMS,
                      plain=plain)
    ro, rd = primary_rays(scene, static, rng, pixel_x, pixel_y)
    n = ro.shape[0]
    eps = scene.epsilon

    hit = traverse.intersect_closest(
        scene, static, ro, rd, eps,
        torch.full((n,), torch.inf, device=ro.device), plain)
    nor = face_forward(hit.nor, -rd)
    u1, u2 = rng.uniform2()
    local, pdf = cosine_hemisphere(u1, u2)
    uu = hit.dpdu
    probe = to_world(local, uu, nor, cross(uu, nor))
    cosine = dot(probe, nor)
    occluded = traverse.intersect_any(
        scene, static, hit.pos, probe, eps,
        torch.where(hit.valid, static.max_dist, 0.0), plain)

    v = cosine * INV_PI / torch.clamp_min(pdf, 1e-30)
    v = torch.where(hit.valid & ~occluded, v, 0.0)
    v = torch.where(torch.isnan(v), 0.0, v)
    li = torch.stack([v, v, v], -1)
    if with_stats:
        return li, n + hit.valid.sum()
    return li
