"""Shared integrator pieces: primary rays, next-event estimation and
lane permutations.

The port of gpu_pathtracer_tpu/integrators/common.py (primary_rays,
direct_light_nee as `nee_sample` and `_occluded_sorted`, the shadow-ray
sort): the light-sample half of the reference Path kernel's MIS pair
(pathtracer.cu:924-951), toward an area light or the environment light.
Draw order per call follows the JAX package: light pick, light (u1,
u2).
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

# None: sort shadow rays on CUDA tensors in the BVH8 regime (the JAX
# package's gate, common.py:65-68); the tests force True / False to check
# that sorted and unsorted occlusion agree lane for lane
FORCE_SHADOW_SORT = None
SHADOW_SORT_MIN_LANES = 4096


def permute_lanes(order, floats, ints=()):
    """Reorder lanes by `order` with one index_select. `floats` are
    float32 [N] or [N, k] tensors, `ints` integer [N] tensors of values
    below 2^31, bit-cast into the same float32 block; returns (floats,
    int32 ints) in the given order."""
    cols = [f.reshape(f.shape[0], -1) for f in floats]
    cols += [i.to(torch.int32)[:, None].view(torch.float32) for i in ints]
    packed = torch.cat(cols, 1).index_select(0, order)
    out, c = [], 0
    for f in floats:
        w = f.shape[1] if f.dim() == 2 else 1
        out.append(packed[:, c:c + w] if f.dim() == 2 else packed[:, c])
        c += w
    return out, [packed[:, c + k].view(torch.int32) for k in range(len(ints))]


def morton_bits(q, bits: int):
    """Interleave `bits` bits of each column of q [N, D] (int32): bit b of
    column a lands at D * b + a; int32, so D * bits <= 31."""
    shift = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
    m = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for b in range(bits):
        m = m | (((q >> b) & 1) << (q.shape[1] * b + shift)).sum(
            -1, dtype=torch.int32)
    return m


def _shadow_sort_key(scene, pos, active):
    """Origin-morton (6 bits per axis) coherence key for shadow rays
    (common.py:36-53): they all aim at the light, so origin clustering
    is what groups walks; inactive lanes sort last. int32: a radix sort
    of it takes half the passes of an int64 one, in the same order."""
    q = torch.clamp(((pos - scene.world_center) / (2.0 * scene.world_radius)
                     + 0.5) * 63.999, 0.0, 63.0).to(torch.int32)
    return torch.where(active, morton_bits(q, 6), 1 << 24)


def sorts_shadows(static, pos) -> bool:
    """Whether `_occluded_sorted` sorts shadow rays from `pos` [N, 3]: on
    CUDA tensors in the BVH8 regime at >= 4096 lanes (the JAX package's
    gate, common.py:65-68), unless FORCE_SHADOW_SORT says."""
    if FORCE_SHADOW_SORT is not None:
        return FORCE_SHADOW_SORT
    return (pos.is_cuda and traverse.regime(static) in ("bvh8", "instanced")
            and pos.shape[0] >= SHADOW_SORT_MIN_LANES)


def _occluded_sorted(scene, static, pos, sd, st, cand, eps, plain=False,
                     key=None):
    """Any-hit occlusion of the candidate lanes (tmax st), shadow-sorted
    where `sorts_shadows` says, by `key` when given (else
    `_shadow_sort_key`'s). The light sample is drawn before, so the sort
    cannot change an answer: the verdicts are scattered back to their
    lanes."""
    st_w = torch.where(cand, st, 0.0)
    if not sorts_shadows(static, pos):
        return traverse.intersect_any(scene, static, pos, sd, eps, st_w,
                                      plain)
    if key is None:
        key = _shadow_sort_key(scene, pos, cand & (st_w > 0.0))
    order = torch.sort(key, stable=True).indices
    (p, d, s), _ = permute_lanes(order, (pos, sd, st_w))
    occ_s = traverse.intersect_any(scene, static, p, d, eps, s, plain)
    occ = torch.empty_like(occ_s)
    occ[order] = occ_s
    return occ


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


def sample_light(scene, static, pos, nor, idx, u1, u2):
    """The light sample toward `pos` of the picked light `idx`: an area
    light, or the environment when idx == n_lights (common.py:114-130).
    Returns (radiance, dir, tmax, light_pdf); with neither kind of
    light, zero radiance along `nor`."""
    if static.n_lights > 0:
        rad, _, sd, st, _, light_pdf = lights_mod.sample_area_light(
            scene, idx, pos, u1, u2, scene.epsilon)
    else:
        rad, sd = torch.zeros_like(pos), nor
        st = light_pdf = torch.zeros_like(u1)
    if static.has_infinite:
        rad_i, _, sd_i, st_i, _, pdf_i = lights_mod.sample_infinite_light(
            scene, pos, u1, u2, scene.epsilon)
        is_inf = idx == static.n_lights
        rad = torch.where(is_inf[:, None], rad_i, rad)
        sd = torch.where(is_inf[:, None], sd_i, sd)
        st = torch.where(is_inf, st_i, st)
        light_pdf = torch.where(is_inf, pdf_i, light_pdf)
    return rad, sd, st, light_pdf


def nee_sample(scene, static, rng, pos, nor, dpdu, mat: bsdf_mod.MatParams,
               wi, active):
    """The light-sampled half of NEE with the power heuristic, before its
    shadow ray: draws the pick and the light sample (three sites) and
    returns (contrib [N, 3]: the estimate where the shadow ray is
    unoccluded, cand [N] bool: the lanes that trace a shadow ray, its
    direction [N, 3] and tmax [N])."""
    u_pick = rng.uniform()
    idx, choice_pdf = lights_mod.pick_light(scene, u_pick)
    u1, u2 = rng.uniform2()
    rad, sd, st, light_pdf = sample_light(scene, static, pos, nor, idx, u1,
                                          u2)
    cand = active & ~is_black(rad) & (light_pdf > 0.0)
    fr, sample_pdf = bsdf_mod.eval_bsdf(mat, wi, sd, nor, dpdu,
                                        static.material_types)
    denom = light_pdf * choice_pdf
    weight = power_heuristic(denom, sample_pdf)
    contrib = weight[:, None] * fr * rad * \
        torch.abs(dot(nor, sd))[:, None] \
        / torch.clamp_min(denom, 1e-30)[:, None]
    return contrib, cand, sd, st


def shadow_transmittance(scene, static, med_idx, ro, rd, tmax, key, active,
                         plain=False):
    """The transmittance along shadow rays of the `active` lanes (tmax
    given): the interface-walking walk of shade/media.py in a scene with
    media, else an any-hit query (1 or 0). Returns (tr [N, 3], rays
    traced: 0-d int64)."""
    from gpu_pathtracer_tpu_torch.shade import media as media_mod
    tmax = torch.where(active, tmax, 0.0)
    if static.has_media:
        return media_mod.transmittance(scene, static, med_idx, ro, rd, tmax,
                                       key, active, plain)
    blocked = traverse.intersect_any(scene, static, ro, rd, scene.epsilon,
                                     tmax, plain)
    return torch.where(blocked[:, None], 0.0, torch.ones_like(ro)), \
        active.sum()
