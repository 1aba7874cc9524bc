"""Shared integrator pieces: primary rays and next-event estimation.

The port of gpu_pathtracer_tpu/integrators/common.py (primary_rays,
direct_light_nee) for area lights: the light-sample half of the
reference Path kernel's MIS pair (pathtracer.cu:924-951). Draw order per
call follows the JAX package: light pick, light (u1, u2).
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.core.sampling import (
    power_heuristic, uniform_disk,
)
from gpu_pathtracer_tpu_torch.core.vecmath import dot, is_black
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import camera as camera_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod


def primary_rays(scene, static, rng, pixel_x, pixel_y):
    """Jittered primary rays with aperture samples (pathtracer.cu:892-897):
    sites 0-3 of the lane's stream."""
    ox = rng.uniform() - 0.5
    oy = rng.uniform() - 0.5
    u1, u2 = rng.uniform2()
    aperture, _ = uniform_disk(u1, u2)
    return camera_mod.generate_primary_ray(
        scene.camera, pixel_x.float() + ox, pixel_y.float() + oy, aperture,
        static.environment_camera)


def direct_light_nee(scene, static, rng, pos, nor, dpdu,
                     mat: bsdf_mod.MatParams, wi, active, plain=False):
    """Light-sampled direct lighting with the power heuristic. Returns
    (Ld [N, 3], lit [N] bool: lanes whose light sample is unoccluded,
    shadow [N] bool: lanes that traced a shadow ray)."""
    u_pick = rng.uniform()
    idx, choice_pdf = lights_mod.pick_light(scene, u_pick)
    u1, u2 = rng.uniform2()
    rad, _, sd, st, _, light_pdf = lights_mod.sample_area_light(
        scene, idx, pos, u1, u2, scene.epsilon)

    cand = active & ~is_black(rad) & (light_pdf > 0.0)
    shadow = cand
    occluded = traverse.intersect_any(scene, static, pos, sd, scene.epsilon,
                                      torch.where(cand, st, 0.0), plain)
    cand = cand & ~occluded

    fr, sample_pdf = bsdf_mod.eval_bsdf(mat, wi, sd, nor, dpdu,
                                        static.material_types)
    denom = light_pdf * choice_pdf
    weight = power_heuristic(denom, sample_pdf)
    contrib = weight[:, None] * fr * rad * \
        torch.abs(dot(nor, sd))[:, None] \
        / torch.clamp_min(denom, 1e-30)[:, None]
    return torch.where(cand[:, None], contrib, 0.0), cand, shadow
