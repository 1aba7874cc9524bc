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

On CUDA tensors the steps run over the scene's intersection kernel
(geom/traverse.py) and the tracking kernel (csrc/track.cu), never the
megakernel, and every step runs: lanes that finished are masked, so no
host sync gates the loop (the JAX package's `lax.cond(jnp.any(...))`
skips). On CPU tensors, or with `plain`, the plain versions run and the
loop stops once no lane is alive, which changes no result.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.core.rng import (
    PSS_CAM_DIMS, TRACK_EMITTER, TRACK_SAMPLE, TRACK_SCATTER, TRACK_SURFACE,
    VPT_MEDIUM, VPT_SCATTER, VPT_STEP_DIMS, VPT_SURFACE, lane_stream,
    track_tag,
)
from gpu_pathtracer_tpu_torch.core.sampling import power_heuristic
from gpu_pathtracer_tpu_torch.core.vecmath import dot, is_black, luminance
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators.common import (
    primary_rays, sample_light,
)
from gpu_pathtracer_tpu_torch.integrators.pt import (
    env_credit_weight, lane_ids_of,
)
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod
from gpu_pathtracer_tpu_torch.shade import media as media_mod
from gpu_pathtracer_tpu_torch.shade.media import TrackKey

INTERFACE_BUDGET = 8   # extra steps for interface crossings


def _sample_light_toward(scene, static, rng, pos):
    """Light pick + area or environment light sample toward `pos`
    (vpt.py:49-76). Returns (radiance, dir, tmax, light_pdf,
    choice_pdf)."""
    u_pick = rng.uniform()
    idx, choice_pdf = lights_mod.pick_light(scene, u_pick)
    u1, u2 = rng.uniform2()
    rad, sd, st, pdf = sample_light(scene, static, pos, pos, idx, u1, u2)
    return rad, sd, st, pdf, choice_pdf


def _direct_light_vol(scene, static, rng, key, pos, nor, dpdu, mat, wi,
                      med_idx, active, plain):
    """Surface NEE with the power heuristic, the shadow ray attenuated by
    the transmittance walk (pathtracer.cu:1128-1155). Returns (Ld [N, 3],
    shadow rays traced)."""
    rad, sd, st, light_pdf, choice_pdf = _sample_light_toward(
        scene, static, rng, pos)
    cand = active & ~is_black(rad) & (light_pdf > 0.0)
    fr, sample_pdf = bsdf_mod.eval_bsdf(mat, wi, sd, nor, dpdu,
                                        static.material_types)
    tr, rays = media_mod.transmittance(
        scene, static, med_idx, pos, sd, torch.where(cand, st, 0.0), key,
        cand, plain)
    weight = power_heuristic(light_pdf * choice_pdf, sample_pdf)
    denom = torch.clamp_min(light_pdf * choice_pdf, 1e-30)
    contrib = weight[:, None] * tr * fr * rad \
        * torch.abs(dot(nor, sd))[:, None] / denom[:, None]
    return torch.where(cand[:, None], contrib, 0.0), rays


def render_lanes(scene, static, seed: int, iteration: int, pixel_x, pixel_y,
                 with_stats: bool = False, plain: bool = False):
    """Per-lane radiance [N, 3] of one volumetric-PT sample per lane.

    with_stats=True also returns the rays traced (closest hits and Tr
    walk segments) as a 0-d int64 tensor on the lanes' device. `plain`
    runs the plain PyTorch intersection and tracking on any device (the
    reference path)."""
    lanes = lane_ids_of(static, pixel_x, pixel_y)
    ro, rd = primary_rays(
        scene, static, lane_stream(seed, iteration, lanes, None, 0,
                                   PSS_CAM_DIMS, plain=plain),
        pixel_x, pixel_y)
    n = ro.shape[0]
    dev = ro.device
    eps = scene.epsilon

    def stream(step, scope, budget):
        return lane_stream(seed, iteration, lanes, None,
                           PSS_CAM_DIMS + step * VPT_STEP_DIMS + scope,
                           budget, plain=plain)

    def key(step, site):
        return TrackKey(seed, iteration, lanes, track_tag(step, site))

    li = torch.zeros((n, 3), device=dev)
    beta = torch.ones((n, 3), device=dev)
    specular = torch.zeros(n, dtype=torch.bool, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    med = torch.full((n,), static.camera_medium, dtype=torch.int32,
                     device=dev)                    # pathtracer.cu:1043
    prev_pdf = torch.ones(n, device=dev)
    from_surf = torch.zeros(n, dtype=torch.bool, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    gate = plain or not ro.is_cuda

    # +1: the final bounce's continuation still owes its arrival credit
    for it in range(static.max_depth + INTERFACE_BUDGET + 1):
        if gate and not bool(alive.any()):
            break
        rays = rays + alive.sum()
        # finished lanes get an empty interval (tmax 0 < eps): the hit
        # kernels leave them at once; every read of their hit is masked
        hit = traverse.intersect_closest(
            scene, static, ro, rd, eps, torch.where(alive, torch.inf, 0.0),
            plain)
        # a miss sees the sky on primary / specular rays and, MIS
        # weighted, after a surface's BSDF sample (pathtracer.cu:1051-1055)
        if static.has_infinite:
            full = (depth == 0) | specular
            take_env = alive & ~hit.valid & (full | from_surf)
            w_env = env_credit_weight(scene, static, full, prev_pdf)
            env = lights_mod.infinite_le(scene, rd)
            li = li + torch.where(take_env[:, None],
                                  beta * env * w_env[:, None], 0.0)
        alive = alive & hit.valid

        # medium distance sampling over [0, hit.t] (pathtracer.cu:1062-1070)
        if static.has_media:
            u0 = stream(it, VPT_MEDIUM, 1).uniform()
            weight, t_med, sampled = media_mod.medium_sample(
                scene, static, med, ro, rd, hit.t, u0,
                key(it, TRACK_SAMPLE), alive, plain)
            beta = torch.where(alive[:, None], beta * weight, beta)
            alive = alive & ~is_black(beta)
        else:
            sampled = torch.zeros(n, dtype=torch.bool, device=dev)
            t_med = hit.t

        # crediting-only lanes (past max_depth) that scatter are done
        at_max = depth >= static.max_depth
        alive = alive & ~(sampled & at_max)

        # ---------- medium interaction (pathtracer.cu:1071-1101) --------
        in_scatter = alive & sampled
        if static.has_media:
            sample_pos = ro + rd * t_med[:, None]
            srng = stream(it, VPT_SCATTER, 5)
            rad, sd, st, light_pdf, choice_pdf = _sample_light_toward(
                scene, static, srng, sample_pos)
            cand = in_scatter & ~is_black(rad) & (light_pdf > 0.0)
            tr, sh = media_mod.transmittance(
                scene, static, med, sample_pos, sd,
                torch.where(cand, st, 0.0), key(it, TRACK_SCATTER), cand,
                plain)
            rays = rays + sh
            ph = media_mod.phase(scene, med, -rd, sd)
            denom = torch.clamp_min(light_pdf * choice_pdf, 1e-30)
            contrib = tr * beta * (ph / denom)[:, None] * rad
            li = li + torch.where(cand[:, None], contrib, 0.0)

            u1, u2 = srng.uniform2()
            new_dir, _ = media_mod.sample_phase(scene, med, -rd, u1, u2)
            ro = torch.where(in_scatter[:, None], sample_pos, ro)
            rd = torch.where(in_scatter[:, None], new_dir, rd)
            specular = torch.where(in_scatter, False, specular)
            from_surf = torch.where(in_scatter, False, from_surf)

        # ---------- surface interaction ---------------------------------
        on_surface = alive & ~sampled

        # emitter arrival (pathtracer.cu:1103-1115 and the reformulated
        # MIS branch of 1157-1208)
        if static.n_lights > 0:
            full = (depth == 0) | specular
            emitter = on_surface & (hit.light_idx >= 0)
            le = lights_mod.area_light_le(scene, hit.light_idx, hit.nor, -rd)
            if static.has_media:   # full-credit quirk: segment Tr (1105-1112)
                tr_e = media_mod.medium_tr_segment(
                    scene, static, med, ro, rd,
                    torch.where(emitter & full, hit.t, 0.0),
                    key(it, TRACK_EMITTER), emitter & full, plain)
            else:
                tr_e = torch.ones((n, 3), device=dev)
            li = li + torch.where((emitter & full)[:, None],
                                  tr_e * beta * le, 0.0)
            lidx = torch.clamp_min(hit.light_idx, 0)
            pdf_area, _ = lights_mod.area_light_pdf(scene, lidx, rd, hit.nor)
            lchoice = lights_mod.light_choice_pdf(scene, lidx)
            seg = hit.pos - ro
            cos_l = torch.abs(dot(hit.nor, rd))
            l_pdf = pdf_area * dot(seg, seg) / torch.clamp_min(cos_l, 1e-30)
            w_le = power_heuristic(prev_pdf, l_pdf * lchoice)
            mis_hit = emitter & ~full & from_surf & ~is_black(le)
            li = li + torch.where(mis_hit[:, None],
                                  beta * le * w_le[:, None], 0.0)
            died = emitter & full
            alive = alive & ~died
            on_surface = on_surface & ~died

        # lanes past max_depth existed only to collect arrival credit
        alive = alive & ~at_max
        on_surface = on_surface & ~at_max

        # medium interface: pass through, no bounce consumed (1117-1124)
        interface = on_surface & (hit.mat_idx == -1)
        going_out = dot(rd, hit.nor) > 0.0
        side_med = torch.where(going_out, hit.medium_outside,
                               hit.medium_inside)
        med = torch.where(interface, side_med, med)
        ro = torch.where(interface[:, None], hit.pos, ro)
        on_surface = on_surface & ~interface

        # real surface: NEE + BSDF sample (pathtracer.cu:1126-1228)
        mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
        wi = -rd
        not_delta = ~bsdf_mod.is_delta(mat.type)
        surf_rng = stream(it, VPT_SURFACE, 7)
        ld, sh = _direct_light_vol(
            scene, static, surf_rng, key(it, TRACK_SURFACE), hit.pos,
            hit.nor, hit.dpdu, mat, wi, med, on_surface & not_delta, plain)
        rays = rays + sh
        li = li + beta * ld

        u1, u2, u3 = surf_rng.uniform3()
        wo, fr, pdf = bsdf_mod.sample_bsdf(
            mat, wi, hit.nor, hit.dpdu, u1, u2, u3, static.material_types)
        dead = on_surface & (is_black(fr) | (pdf <= 0.0))
        alive = alive & ~dead
        surf_go = on_surface & ~dead
        beta_next = beta * fr * torch.abs(dot(hit.nor, wo))[:, None] \
            / torch.clamp_min(pdf, 1e-30)[:, None]
        beta = torch.where(surf_go[:, None], beta_next, beta)
        delta = bsdf_mod.is_delta(mat.type)
        specular = torch.where(surf_go, delta, specular)
        prev_pdf = torch.where(surf_go, pdf, prev_pdf)
        from_surf = torch.where(surf_go, ~delta, from_surf)

        # next-bounce medium by crossing side; reflections keep the
        # current medium (pathtracer.cu:1224-1226)
        out_side = torch.where(dot(wo, hit.nor) > 0.0, hit.medium_outside,
                               hit.medium_inside)
        same_side = dot(wi, hit.nor) * dot(wo, hit.nor) > 0.0
        med = torch.where(surf_go, torch.where(same_side, med, out_side), med)
        ro = torch.where(surf_go[:, None], hit.pos, ro)
        rd = torch.where(surf_go[:, None], wo, rd)

        # medium scatters and real surfaces consume a bounce, interfaces
        # do not (pathtracer.cu:1118)
        consumed = in_scatter | surf_go
        depth = torch.where(consumed, depth + 1, depth)

        # Russian roulette (pathtracer.cu:1231-1237), not on interfaces
        u_rr = surf_rng.uniform()
        illumate = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
        do_rr = (depth > 4) & alive & consumed
        alive = alive & ~(do_rr & (u_rr < illumate))
        rr_scale = 1.0 / torch.clamp_min(1.0 - illumate, 1e-30)
        beta = torch.where((do_rr & alive)[:, None],
                           beta * rr_scale[:, None], beta)

    # NaN/Inf guard: poisoned lanes are zeroed
    bad = ~torch.isfinite(li).all(dim=-1)
    li = torch.where(bad[:, None], 0.0, li)
    if with_stats:
        return li, rays
    return li
