"""The VPT wavefront's step, as CUDA kernels around the hit and tracking
kernels.

A step of integrators/vpt.py::render_lanes launches the closest hit, the
sample walk (shade/media.py::track in sample mode, heterogeneous media
only), `shade`, then TR_MAX_SEGMENTS rounds of (the closest hit of the
walk's segment, `tr_round`, `track` in tr mode); `finish` closes the
last step.

- `shade` takes the step's raw (t, prim), the sample walk's first
  collision and the lane state (`Lanes`) and returns the next lane state
  and the step's one transmittance walk (`Walk`): first the previous
  step's credit that waited for its walk, then the step of the plain
  VPT (the sky on a miss, the distance sample's weight, a medium
  scatter's NEE and phase sample, the emitter arrival, the interface
  pass-through, a surface's NEE and BSDF sample, the roulette).
- A lane starts at most one walk a step: the medium-scatter NEE ray
  (call site TRACK_SCATTER), the surface NEE ray (TRACK_SURFACE), or the
  segment to a full-credit emitter hit in a heterogeneous medium
  (TRACK_EMITTER, walked by round 0's track call alone). The walk's
  tracking draws at track_tag(step, its site, round), where the
  unregrouped step's three walks draw, so one walk does the work of the
  three at a third of the hit and track launches.
- The credit the walk attenuates is pending (`Walk.pending`, its factors
  kept apart) and is formed after the walk in the plain step's order:
  scatter tr * beta * (ph / denom) * rad, surface beta * (weight * tr *
  fr * rad * |cos| / denom), emitter tr * beta * le; the film is the
  unregrouped step's bit for bit.
- `tr_round` is one round of media.transmittance: the previous round's
  heterogeneous segment Tr folded in, a real material blocks, the
  segment's length and medium for the round's track call (a homogeneous
  segment's Beer-Lambert Tr at once), the interface crossing by side.
- `finish`: the last step's credit, then the NaN guard.

On CUDA tensors each launches csrc/vpt_shade.cu and counts the launch in
`STATS` (vpt_shade), `TR_STATS` (vpt_tr_round) or `FINISH_STATS`
(vpt_finish); it raises
on what the kernel does not take and has no fallback. `shade_torch`,
`tr_round_torch` and `finish_torch`, their plain versions, run for CPU
tensors and under `plain=True`, and count their calls on CUDA tensors in
`plain_cuda`.

The kernels update the lane state in place: `shade` and `tr_round` on
CUDA tensors return the `Lanes` and `Walk` they were given, changed. The
first step's `shade` (walk None) allocates the spp's one `Walk` with its
device lists (`Lists`); after that no call allocates a per-lane tensor.
Each launch covers a list of lane rows that the launch before it built
on the device: a step the rows of `shade_list`, a round those of
`round_list`. A row off a launch's list is neither read nor written by
it; the plain versions leave it bit-unchanged too, apart from the walk
fields that only a lane holding a credit reads (`live_walk`).

Lane flags (int32): SPECULAR, ALIVE, FROM_SURF. Walk flags: WALKING (the
next round traces a segment), EMIT (round 0's track call walks the
emitter segment), FOLD (tr waits for the last track call's result) and
the credit that waits: SCATTER, SURFACE or EMITTER.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from gpu_pathtracer_tpu_torch import kernels
from gpu_pathtracer_tpu_torch.core.rng import (
    PSS_CAM_DIMS, TRACK_EMITTER, TRACK_SCATTER, TRACK_SURFACE, VPT_MEDIUM,
    VPT_SCATTER, VPT_STEP_DIMS, VPT_SURFACE, lane_stream,
)
from gpu_pathtracer_tpu_torch.core.sampling import power_heuristic
from gpu_pathtracer_tpu_torch.core.vecmath import dot, is_black, luminance
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.geom.dense import kinds_of
from gpu_pathtracer_tpu_torch.integrators.common import sample_light
from gpu_pathtracer_tpu_torch.integrators.pt import env_credit_weight
from gpu_pathtracer_tpu_torch.kernels import (
    KernelStats, check_cuda_f32, check_launch, load_library,
)
from gpu_pathtracer_tpu_torch.scene.flatten import MED_COLS
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod
from gpu_pathtracer_tpu_torch.shade import media as media_mod
from gpu_pathtracer_tpu_torch.shade.lights import n_light_rows
from gpu_pathtracer_tpu_torch.shade.media import TR_MAX_SEGMENTS

STATS = KernelStats()          # vpt_shade
TR_STATS = KernelStats()       # vpt_tr_round
FINISH_STATS = KernelStats()   # vpt_finish

SPECULAR, ALIVE, FROM_SURF = 1, 2, 4               # lane flags
WALKING, EMIT, FOLD = 1, 2, 4                      # walk flags
SCATTER, SURFACE, EMITTER = 8, 16, 32              # the credit that waits
CREDIT = SCATTER | SURFACE | EMITTER
PEND = 12   # pending factors a lane: a [3], b [3], c [3], s, cos, denom
INTERFACE_BUDGET = 8   # extra steps for interface crossings


def n_steps(static) -> int:
    """The steps of a path: max_depth bounces, INTERFACE_BUDGET interface
    crossings and one more, whose arrival credits the last bounce's
    continuation."""
    return static.max_depth + INTERFACE_BUDGET + 1


@dataclass
class Lanes:
    """The lane state between steps."""
    ro: torch.Tensor          # [N, 3] the next ray
    rd: torch.Tensor          # [N, 3]
    li: torch.Tensor          # [N, 3]
    beta: torch.Tensor        # [N, 3]
    prev_pdf: torch.Tensor    # [N]
    depth: torch.Tensor       # [N] int32
    med: torch.Tensor         # [N] int32, -1 in vacuum
    flags: torch.Tensor       # [N] int32: SPECULAR | ALIVE | FROM_SURF
    tmax: torch.Tensor        # [N] the next closest hit's: inf alive, else 0
    med_sample: torch.Tensor | None   # [N] int32 the next sample walk's
    #                                   medium, -1 none; None without
    #                                   heterogeneous media


@dataclass
class Walk:
    """A step's transmittance walk (one ray a lane) and the credit that
    waits for it."""
    o: torch.Tensor           # [N, 3] the next segment's origin
    d: torch.Tensor           # [N, 3] its direction
    rem: torch.Tensor         # [N] the length left
    med: torch.Tensor         # [N] int32 the medium it crosses
    tr: torch.Tensor          # [N, 3] transmittance so far
    flags: torch.Tensor       # [N] int32 walk flags
    sites: torch.Tensor       # [N] int32 call site of its draws (0: none)
    pending: torch.Tensor     # [N, PEND] the credit's factors (0: none)
    tmax: torch.Tensor        # [N] the next round's hit tmax (rem or 0)
    track_med: torch.Tensor | None = None   # [N] int32: the round's track
    track_t: torch.Tensor | None = None     # call, medium (-1), length
    track_o: torch.Tensor | None = None     # [N, 3] and origin
    lists: Lists | None = None   # the CUDA route's device lists


@dataclass
class Lists:
    """The device lists of lane rows that csrc/vpt_shade.cu's launches
    cover and append (the CUDA route; one set a spp)."""
    shade: torch.Tensor    # [2, N] int32: step s's rows in row s % 2
    walk: torch.Tensor     # [2, N] int32: round r's rows in row r % 2
    counts: torch.Tensor   # [n_steps + 1, TR_MAX_SEGMENTS + 2] int32, 0 at
    #                        first: [s, 0] step s's length, [s, 1 + r]
    #                        round r's (step 0 covers every row, unlisted)
    step: int = 0          # the step the last shade ran
    round: int = 0         # that step's next round


def start(scene, static, ro, rd) -> Lanes:
    """Every lane alive at the camera, in the camera's medium
    (pathtracer.cu:1043)."""
    n, dev = ro.shape[0], ro.device
    i32 = dict(dtype=torch.int32, device=dev)
    med = torch.full((n,), static.camera_medium, **i32)
    med_sample = None
    if static.has_hetero:
        m = media_mod.gather_medium(scene, med[:1])
        het = (med[:1] >= 0) & (m["type"] == media_mod.HETEROGENEOUS)
        med_sample = torch.where(het, med, -1)
    return Lanes(ro, rd, torch.zeros((n, 3), device=dev),
                 torch.ones((n, 3), device=dev), torch.ones(n, device=dev),
                 torch.zeros(n, **i32), med, torch.full((n,), ALIVE, **i32),
                 torch.full((n,), torch.inf, device=dev), med_sample)


def sample_light_toward(scene, static, rng, pos):
    """Light pick + area or environment light sample toward `pos`
    (vpt.py:49-76). Returns (radiance, dir, tmax, light_pdf,
    choice_pdf)."""
    u_pick = rng.uniform()
    idx, choice_pdf = lights_mod.pick_light(scene, u_pick)
    u1, u2 = rng.uniform2()
    rad, sd, st, pdf = sample_light(scene, static, pos, pos, idx, u1, u2)
    return rad, sd, st, pdf, choice_pdf


def shade(scene, static, step, seed, iteration, lanes, t, prim,
          lane: Lanes, found_t=None, walk: Walk | None = None,
          walk_out=None, rays=None, plain=False):
    """Shade step `step` of lanes whose closest hit gave (t, prim; prim -1
    on a miss); `found_t` is the sample walk's first collision (with
    heterogeneous media), `walk` / `walk_out` the previous step's walk
    and its last track call's result (None at step 0), `rays` a 0-d int64
    count that gets the lanes alive at the step's start. Returns (Lanes,
    Walk). The kernel on CUDA tensors, else (or under `plain`)
    `shade_torch`."""
    if plain or lane.ro.device.type != "cuda":
        return shade_torch(scene, static, step, seed, iteration, lanes, t,
                           prim, lane, found_t, walk, walk_out, rays, plain)
    return shade_cuda(scene, static, step, seed, iteration, lanes, t, prim,
                      lane, found_t, walk, walk_out, rays)


def tr_round(scene, static, t, prim, walk: Walk, walk_out=None, rays=None,
             plain=False) -> Walk:
    """One round of the walk after its closest hit (t, prim); `walk_out`
    is the previous round's track result (None at round 0). `rays` gets
    the lanes walking at the round's start. Returns the walk after the
    round, with the round's track call (track_med, track_t)."""
    if plain or walk.o.device.type != "cuda":
        return tr_round_torch(scene, static, t, prim, walk, walk_out, rays)
    return tr_round_cuda(scene, static, t, prim, walk, walk_out, rays)


def finish(li, walk: Walk | None, walk_out=None, plain=False):
    """The radiance [N, 3] after the last step: its credit, then the NaN
    guard."""
    if plain or li.device.type != "cuda":
        return finish_torch(li, walk, walk_out)
    return finish_cuda(li, walk, walk_out)


def _settle(walk: Walk, walk_out, li):
    """The credit that waited for `walk`: its last heterogeneous segment's
    Tr folded in, then the credit in the plain step's order."""
    f = walk.flags
    tr = walk.tr
    if walk_out is not None:
        tr = torch.where(((f & FOLD) != 0)[:, None], tr * walk_out[:, None],
                         tr)
    p = walk.pending
    a, b, c = p[:, 0:3], p[:, 3:6], p[:, 6:9]
    s, cs, dn = p[:, 9:10], p[:, 10:11], p[:, 11:12]
    li = torch.where(((f & SCATTER) != 0)[:, None], li + tr * a * s * b, li)
    li = torch.where(((f & EMITTER) != 0)[:, None], li + tr * a * b, li)
    return torch.where(((f & SURFACE) != 0)[:, None],
                       li + c * (s * tr * a * b * cs / dn), li)


def shade_torch(scene, static, step, seed, iteration, lanes, t, prim,
                lane: Lanes, found_t=None, walk: Walk | None = None,
                walk_out=None, rays=None, plain=True):
    """The plain version of `shade`, on any device: the VPT step of
    vpt.py regrouped around one walk, in the kernel's order of
    operations."""
    if lane.ro.is_cuda:
        STATS.plain_cuda += 1
    ro, rd, beta = lane.ro, lane.rd, lane.beta
    prev_pdf, depth, med = lane.prev_pdf, lane.depth, lane.med
    n, dev = ro.shape[0], ro.device
    li = lane.li if walk is None else _settle(walk, walk_out, lane.li)
    specular = (lane.flags & SPECULAR) != 0
    alive = (lane.flags & ALIVE) != 0
    from_surf = (lane.flags & FROM_SURF) != 0
    if rays is not None:
        rays += alive.sum()

    def stream(scope, budget):
        return lane_stream(seed, iteration, lanes, None,
                           PSS_CAM_DIMS + step * VPT_STEP_DIMS + scope,
                           budget, plain=plain)

    hit = traverse._hit_attributes(scene, static, ro, rd, t, prim, prim >= 0)
    # a miss sees the sky on primary / specular rays and, MIS weighted,
    # after a surface's BSDF sample (pathtracer.cu:1051-1055)
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
        u0 = stream(VPT_MEDIUM, 1).uniform()
        weight, t_med, sampled = media_mod.sample_weight(
            scene, static, med, hit.t, u0, found_t, alive)
        beta = torch.where(alive[:, None], beta * weight, beta)
        alive = alive & ~is_black(beta)
    else:
        sampled = torch.zeros(n, dtype=torch.bool, device=dev)
        t_med = hit.t
    at_max = depth >= static.max_depth
    alive = alive & ~(sampled & at_max)

    # the step's walk and the credit that waits for it
    i32 = dict(dtype=torch.int32, device=dev)
    zero3 = torch.zeros_like(ro)
    w_flags = torch.zeros(n, **i32)
    sites = torch.zeros(n, **i32)
    w_o, w_d = zero3, zero3
    w_rem = torch.zeros(n, device=dev)
    w_med = torch.full((n,), -1, **i32)
    w_tr = torch.ones_like(ro)
    pend = torch.zeros((n, PEND), device=dev)

    def join(mask, flag, site, o, d, rem, wmed, **cols):
        nonlocal w_flags, sites, w_o, w_d, w_rem, w_med, pend
        w_flags = torch.where(mask, w_flags | flag, w_flags)
        if site:
            sites = torch.where(mask, site, sites)
            w_o = torch.where(mask[:, None], o, w_o)
            w_d = torch.where(mask[:, None], d, w_d)
            w_rem = torch.where(mask, rem, w_rem)
            w_med = torch.where(mask, wmed, w_med)
        for c0, v in cols.items():
            c = int(c0[1:])
            v = v if v.dim() == 2 else v[:, None]
            pend[:, c:c + v.shape[1]] = torch.where(
                mask[:, None], v, pend[:, c:c + v.shape[1]])

    # ---------- medium interaction (pathtracer.cu:1071-1101) ------------
    in_scatter = alive & sampled
    if static.has_media:
        sample_pos = ro + rd * t_med[:, None]
        srng = stream(VPT_SCATTER, 5)
        rad, sd, st, light_pdf, choice_pdf = sample_light_toward(
            scene, static, srng, sample_pos)
        cand = in_scatter & ~is_black(rad) & (light_pdf > 0.0)
        ph = media_mod.phase(scene, med, -rd, sd)
        denom = torch.clamp_min(light_pdf * choice_pdf, 1e-30)
        join(cand, WALKING | SCATTER, TRACK_SCATTER, sample_pos, sd, st, med,
             c0=beta, c3=rad, c9=ph / denom)
        u1, u2 = srng.uniform2()
        new_dir, _ = media_mod.sample_phase(scene, med, -rd, u1, u2)
        ro = torch.where(in_scatter[:, None], sample_pos, ro)
        rd = torch.where(in_scatter[:, None], new_dir, rd)
        specular = torch.where(in_scatter, False, specular)
        from_surf = torch.where(in_scatter, False, from_surf)

    # ---------- surface interaction -------------------------------------
    on_surface = alive & ~sampled

    # emitter arrival (pathtracer.cu:1103-1115 and the reformulated MIS
    # branch of 1157-1208); the full credit waits for the segment's Tr
    if static.n_lights > 0:
        full = (depth == 0) | specular
        emitter = on_surface & (hit.light_idx >= 0)
        le = lights_mod.area_light_le(scene, hit.light_idx, hit.nor, -rd)
        died = emitter & full
        if static.has_media:   # full-credit quirk: segment Tr (1105-1112)
            in_medium = died & (med >= 0)
            m = media_mod.gather_medium(scene, med)
            tr_h = torch.exp(m["sigma_t"]
                             * (-torch.where(died, hit.t, 0.0)[:, None]))
            het = in_medium & (m["type"] == media_mod.HETEROGENEOUS)
            w_tr = torch.where((in_medium & ~het)[:, None], tr_h, w_tr)
            if static.has_hetero:
                join(het, EMIT, TRACK_EMITTER, ro, rd, hit.t, med)
        join(died, EMITTER, 0, None, None, None, None, c0=beta, c3=le)
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
        alive = alive & ~died
        on_surface = on_surface & ~died

    # lanes past max_depth existed only to collect arrival credit
    alive = alive & ~at_max
    on_surface = on_surface & ~at_max

    # medium interface: pass through, no bounce consumed (1117-1124)
    interface = on_surface & (hit.mat_idx == -1)
    going_out = dot(rd, hit.nor) > 0.0
    side_med = torch.where(going_out, hit.medium_outside, hit.medium_inside)
    med = torch.where(interface, side_med, med)
    ro = torch.where(interface[:, None], hit.pos, ro)
    on_surface = on_surface & ~interface

    # real surface: NEE (its walk pending) + BSDF sample (1126-1228)
    mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
    wi = -rd
    not_delta = ~bsdf_mod.is_delta(mat.type)
    surf_rng = stream(VPT_SURFACE, 7)
    rad, sd, st, light_pdf, choice_pdf = sample_light_toward(
        scene, static, surf_rng, hit.pos)
    cand = on_surface & not_delta & ~is_black(rad) & (light_pdf > 0.0)
    fr, sample_pdf = bsdf_mod.eval_bsdf(mat, wi, sd, hit.nor, hit.dpdu,
                                        static.material_types)
    weight = power_heuristic(light_pdf * choice_pdf, sample_pdf)
    denom = torch.clamp_min(light_pdf * choice_pdf, 1e-30)
    join(cand, WALKING | SURFACE, TRACK_SURFACE, hit.pos, sd, st, med,
         c0=fr, c3=rad, c6=beta, c9=weight, c10=torch.abs(dot(hit.nor, sd)),
         c11=denom)
    # li + beta * Ld, Ld = 0 without a surface NEE ray
    li = torch.where(cand[:, None], li, li + beta * 0.0)

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

    # next-bounce medium by crossing side; reflections keep the current
    # medium (pathtracer.cu:1224-1226)
    out_side = torch.where(dot(wo, hit.nor) > 0.0, hit.medium_outside,
                           hit.medium_inside)
    same_side = dot(wi, hit.nor) * dot(wo, hit.nor) > 0.0
    med = torch.where(surf_go, torch.where(same_side, med, out_side), med)
    ro = torch.where(surf_go[:, None], hit.pos, ro)
    rd = torch.where(surf_go[:, None], wo, rd)

    # medium scatters and real surfaces consume a bounce, interfaces do
    # not (pathtracer.cu:1118)
    consumed = in_scatter | surf_go
    depth = torch.where(consumed, depth + 1, depth)

    # Russian roulette (pathtracer.cu:1231-1237), not on interfaces
    u_rr = surf_rng.uniform()
    illumate = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
    do_rr = (depth > 4) & alive & consumed
    alive = alive & ~(do_rr & (u_rr < illumate))
    rr_scale = 1.0 / torch.clamp_min(1.0 - illumate, 1e-30)
    beta = torch.where((do_rr & alive)[:, None], beta * rr_scale[:, None],
                       beta)

    med_sample = None
    if static.has_hetero:
        m = media_mod.gather_medium(scene, med)
        med_sample = torch.where(
            alive & (med >= 0) & (m["type"] == media_mod.HETEROGENEOUS), med,
            -1)
    flags = specular.to(torch.int32) | (alive.to(torch.int32) << 1) \
        | (from_surf.to(torch.int32) << 2)
    walking = (w_flags & WALKING) != 0
    return (Lanes(ro, rd, li, beta, prev_pdf, depth, med, flags,
                  torch.where(alive, torch.inf, 0.0), med_sample),
            Walk(w_o, w_d, w_rem, w_med, w_tr, w_flags, sites, pend,
                 torch.where(walking, w_rem, 0.0)))


def tr_round_torch(scene, static, t, prim, walk: Walk, walk_out=None,
                   rays=None) -> Walk:
    """The plain version of `tr_round`: one round of media.transmittance
    (pathtracer.cu:298-322), the heterogeneous segment's Tr left to the
    round's track call and folded in by the next round (or the next
    step's shading)."""
    if walk.o.is_cuda:
        TR_STATS.plain_cuda += 1
    f = walk.flags
    tr = walk.tr
    if walk_out is not None:
        tr = torch.where(((f & FOLD) != 0)[:, None], tr * walk_out[:, None],
                         tr)
    walking = (f & WALKING) != 0
    if rays is not None:
        rays += walking.sum()
    hit = traverse._hit_attributes(scene, static, walk.o, walk.d, t, prim,
                                   prim >= 0)
    blocked = walking & hit.valid & (hit.mat_idx != -1)
    tr = torch.where(blocked[:, None], 0.0, tr)
    walking = walking & ~blocked
    seg_len = torch.where(hit.valid, hit.t, walk.rem)
    emit = (f & EMIT) != 0   # the emitter segment [0, rem]
    track_med = torch.where(emit, walk.med, -1)
    track_t = torch.where(emit, walk.rem, 0.0)
    fold = emit
    if static.has_media:
        in_medium = walking & (walk.med >= 0)
        m = media_mod.gather_medium(scene, walk.med)
        het = in_medium & (m["type"] == media_mod.HETEROGENEOUS)
        tr_h = torch.exp(m["sigma_t"] * (-seg_len[:, None]))
        tr = torch.where((in_medium & ~het)[:, None], tr * tr_h, tr)
        track_med = torch.where(het, walk.med, track_med)
        track_t = torch.where(het, seg_len, track_t)
        fold = fold | het
    walking = walking & hit.valid
    # cross the interface: the medium by crossing side (cu:315-316)
    going_out = dot(walk.d, hit.nor) > 0.0
    med = torch.where(walking, torch.where(going_out, hit.medium_outside,
                                           hit.medium_inside), walk.med)
    rem = torch.where(walking, walk.rem - hit.t, walk.rem)
    o = torch.where(walking[:, None], hit.pos, walk.o)
    flags = (f & CREDIT) | walking.to(torch.int32) * WALKING \
        | fold.to(torch.int32) * FOLD
    return Walk(o, walk.d, rem, med, tr, flags, walk.sites, walk.pending,
                torch.where(walking, rem, 0.0), track_med, track_t, walk.o)


def finish_torch(li, walk: Walk | None, walk_out=None):
    """The plain version of `finish`."""
    if li.is_cuda:
        FINISH_STATS.plain_cuda += 1
    if walk is not None:
        li = _settle(walk, walk_out, li)
    # NaN/Inf guard: poisoned lanes are zeroed
    bad = ~torch.isfinite(li).all(dim=-1)
    return torch.where(bad[:, None], 0.0, li)


def shade_list(lane: Lanes, walk: Walk | None = None) -> torch.Tensor:
    """[N] bool: the lanes a step's `shade` changes, from the state before
    it: alive, owed the credit of the previous step's walk (a lane that
    died with a credit pending), or dead with a beta that is not finite
    (the step adds beta * 0 to its li). `shade_torch` leaves every other
    lane as it was; vpt_shade covers exactly these rows."""
    on = ((lane.flags & ALIVE) != 0) | ~torch.isfinite(lane.beta).all(1)
    if walk is not None:
        on = on | ((walk.flags & CREDIT) != 0)
    return on


def round_list(walk: Walk) -> torch.Tensor:
    """[N] bool: the lanes a `tr_round` changes: walking, with the emitter
    segment to walk (EMIT) or a segment's Tr to fold in (FOLD). The others
    keep every field, with track_med -1 and track_t 0; vpt_tr_round covers
    exactly these rows."""
    return (walk.flags & (WALKING | EMIT | FOLD)) != 0


def live_walk(walk: Walk) -> Walk:
    """`walk` with the fields that no later launch reads set to the plain
    step's values, to compare two walks: the segment, Tr, call site and
    pending factors of a lane that holds no credit (the kernels write them
    only for a lane that starts one)."""
    import dataclasses
    idle = walk.flags == 0
    col = idle[:, None]
    return dataclasses.replace(
        walk, o=torch.where(col, 0.0, walk.o), d=torch.where(col, 0.0, walk.d),
        rem=torch.where(idle, 0.0, walk.rem),
        med=torch.where(idle, -1, walk.med),
        tr=torch.where(col, 1.0, walk.tr),
        sites=torch.where(idle, 0, walk.sites),
        pending=torch.where(col, 0.0, walk.pending))


# ---------------------------------------------------------------------------
# the kernels (csrc/vpt_shade.cu)
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p


def _fields(ptrs, ints="", u32="", f32=""):
    return ([(k, _P) for k in ptrs.split()]
            + [(k, ctypes.c_int) for k in ints.split()]
            + [(k, ctypes.c_uint32) for k in u32.split()]
            + [(k, ctypes.c_float) for k in f32.split()])


class _ShadeArgs(ctypes.Structure):   # VptShadeArgs
    _fields_ = _fields(
        "t prim found_t lanes list count ro rd li beta prev_pdf depth med "
        "flags tmax med_sample w_o w_d w_rem w_med w_tr w_flags w_sites "
        "w_pend w_tmax track_med track_t w_out prim_attrs mats lights cdf "
        "med_table env_data env_u env_v env_wa tex tex_offset tex_w tex_h "
        "next_list next_count walk_list walk_count rays",
        "n step max_depth n_lights n_rows all_kinds env_w env_h aniso "
        "has_media", "seed iteration", "eps env_tmax")


class _TrArgs(ctypes.Structure):   # VptTrArgs
    _fields_ = _fields(
        "t prim list count o d rem med tr flags tmax track_med track_t "
        "track_o out prim_attrs med_table next_list next_count rays",
        "n all_kinds")


class _FinishArgs(ctypes.Structure):   # VptFinishArgs
    _fields_ = _fields("li w_tr w_flags w_pend w_out li_out", "n")


def _lib():
    lib = load_library("vpt_shade")
    if lib.vpt_shade.argtypes is None:
        for name, args in (("vpt_shade", _ShadeArgs), ("vpt_tr_round", _TrArgs),
                           ("vpt_finish", _FinishArgs)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(args), _P]
        lib.vpt_occupancy.restype = ctypes.c_int
        lib.vpt_occupancy.argtypes = [_P]
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


F32, I32, I64 = torch.float32, torch.int32, torch.int64


def _check(dev, n, *specs):
    """Each (name, tensor or None, columns or None, dtype) a contiguous
    tensor of that dtype, [n] or [n, columns], on `dev`."""
    for name, x, cols, dtype in specs:
        if x is not None:
            check_cuda_f32(name, x, (n,) if cols is None else (n, cols), dev,
                           dtype)


def _walk_specs(walk: Walk, walk_out):
    return (("walk tr", walk.tr, 3, F32), ("walk flags", walk.flags, None,
                                           I32),
            ("walk pending", walk.pending, PEND, F32),
            ("walk_out", walk_out, None, F32))


def _check_rays(rays, dev):
    if rays is None or rays.dtype != I64 or rays.numel() != 1 \
            or rays.device != dev:
        raise ValueError("rays must be a 1-element int64 tensor on the card")


def _tables(scene, static, dev):
    """The scene tables the kernels read, checked."""
    check_cuda_f32("prim_attrs", scene.prim_attrs, (None, 40), dev)
    check_cuda_f32("mat_attrs", scene.mat_attrs, (None, 24), dev)
    rows = n_light_rows(static)
    check_cuda_f32("light_attrs", scene.light_attrs, (rows, 24), dev)
    check_cuda_f32("light_cdf", scene.light_cdf, (rows + 2,), dev)
    check_cuda_f32("med_table", scene.med_table, (None, MED_COLS), dev)


def _new_walk(n, dev, steps) -> Walk:
    """The spp's one walk of the CUDA route, as the plain step leaves a
    lane without a walk, with its device lists (every count 0)."""
    f32 = dict(dtype=F32, device=dev)
    i32 = dict(dtype=I32, device=dev)
    return Walk(torch.zeros((n, 3), **f32), torch.zeros((n, 3), **f32),
                torch.zeros(n, **f32), torch.full((n,), -1, **i32),
                torch.ones((n, 3), **f32), torch.zeros(n, **i32),
                torch.zeros(n, **i32), torch.zeros((n, PEND), **f32),
                torch.zeros(n, **f32), torch.full((n,), -1, **i32),
                torch.zeros(n, **f32), torch.zeros((n, 3), **f32),
                Lists(torch.empty((2, n), **i32), torch.empty((2, n), **i32),
                      torch.zeros((steps + 1, TR_MAX_SEGMENTS + 2), **i32)))


def _count(lists: Lists, step, col):
    """The address of counts[step, col]."""
    if not 0 <= step < lists.counts.shape[0]:
        raise ValueError(f"step {step} is past the lists' "
                         f"{lists.counts.shape[0] - 1} steps")
    return lists.counts[step, col].data_ptr()


def _walk_state_specs(walk: Walk):
    return (("walk o", walk.o, 3, F32), ("walk d", walk.d, 3, F32),
            ("walk rem", walk.rem, None, F32),
            ("walk med", walk.med, None, I32),
            ("walk sites", walk.sites, None, I32),
            ("walk tmax", walk.tmax, None, F32),
            ("walk track_med", walk.track_med, None, I32),
            ("walk track_t", walk.track_t, None, F32),
            ("walk track_o", walk.track_o, 3, F32))


def _lists_of(walk: Walk, dev, n) -> Lists:
    if walk.lists is None or walk.track_med is None or walk.track_o is None:
        raise ValueError("the walk has no device lists: the CUDA route's "
                         "walk is the one its first shade_cuda made")
    lists = walk.lists
    for name, x in (("lists shade", lists.shade), ("lists walk", lists.walk)):
        check_cuda_f32(name, x, (2, n), dev, I32)
    check_cuda_f32("lists counts", lists.counts, (None, TR_MAX_SEGMENTS + 2),
                   dev, I32)
    return lists


def shade_cuda(scene, static, step, seed, iteration, lanes, t, prim,
               lane: Lanes, found_t=None, walk: Walk | None = None,
               walk_out=None, rays=None):
    """Launch csrc/vpt_shade.cu's vpt_shade: `shade`'s contract on CUDA
    tensors (`rays` required), over the step's list (walk None: every
    lane, and a new walk with its lists), updating `lane` and the walk in
    place; returns them."""
    dev = lane.ro.device
    n = lane.ro.shape[0]
    _check(dev, n, ("t", t, None, F32), ("prim", prim, None, I32),
           ("lanes", lanes, None, I64), ("ro", lane.ro, 3, F32),
           ("rd", lane.rd, 3, F32), ("li", lane.li, 3, F32),
           ("beta", lane.beta, 3, F32), ("prev_pdf", lane.prev_pdf, None, F32),
           ("depth", lane.depth, None, I32), ("med", lane.med, None, I32),
           ("flags", lane.flags, None, I32), ("tmax", lane.tmax, None, F32),
           ("med_sample", lane.med_sample, None, I32),
           ("found_t", found_t, None, F32),
           *(_walk_specs(walk, walk_out) + _walk_state_specs(walk)
             if walk is not None else ()))
    if static.has_hetero != (found_t is not None):
        raise ValueError("found_t is the sample walk's result: given with "
                         "heterogeneous media, and only then")
    if static.has_hetero != (lane.med_sample is not None):
        raise ValueError("med_sample is kept with heterogeneous media, and "
                         "only then")
    _check_rays(rays, dev)
    _tables(scene, static, dev)
    a = _ShadeArgs()
    env = dict(env_data=None, env_u=None, env_v=None, env_wa=None)
    if static.has_infinite:
        check_cuda_f32("env_data", scene.env_data, (None, None, 3), dev)
        for name in ("env_u", "env_v", "env_w"):
            check_cuda_f32(name, getattr(scene, name), (3,), dev)
        env = dict(env_data=scene.env_data.data_ptr(),
                   env_u=scene.env_u.data_ptr(), env_v=scene.env_v.data_ptr(),
                   env_wa=scene.env_w.data_ptr())
        a.env_w, a.env_h = scene.env_data.shape[1], scene.env_data.shape[0]
        a.env_tmax = 2.0 * scene.world_radius - scene.epsilon
    if static.has_textures:
        check_cuda_f32("tex_data", scene.tex_data, (None, 3), dev,
                       torch.uint8)
        n_tex = scene.tex_offset.shape[0]
        for name in ("tex_offset", "tex_w", "tex_h"):
            check_cuda_f32(name, getattr(scene, name), (n_tex,), dev,
                           torch.int32)
        a.tex, a.tex_offset, a.tex_w, a.tex_h = (
            x.data_ptr() for x in (scene.tex_data, scene.tex_offset,
                                   scene.tex_w, scene.tex_h))
    for k, v in env.items():
        setattr(a, k, v)

    if walk is None:   # every lane, unlisted
        walk = _new_walk(n, dev, n_steps(static))
        lists = walk.lists
    else:
        lists = _lists_of(walk, dev, n)
        a.list = lists.shade[step % 2].data_ptr()
        a.count = _count(lists, step, 0)
    a.next_list = lists.shade[(step + 1) % 2].data_ptr()
    a.next_count = _count(lists, step + 1, 0)
    a.walk_list = lists.walk[0].data_ptr()
    a.walk_count = _count(lists, step, 1)
    a.t, a.prim, a.found_t, a.lanes = (_ptr(x) for x in (t, prim, found_t,
                                                        lanes))
    (a.ro, a.rd, a.li, a.beta, a.prev_pdf, a.depth, a.med, a.flags,
     a.tmax) = (x.data_ptr() for x in (
         lane.ro, lane.rd, lane.li, lane.beta, lane.prev_pdf, lane.depth,
         lane.med, lane.flags, lane.tmax))
    a.med_sample = _ptr(lane.med_sample)
    (a.w_o, a.w_d, a.w_rem, a.w_med, a.w_tr, a.w_flags, a.w_sites, a.w_pend,
     a.w_tmax, a.track_med, a.track_t) = (x.data_ptr() for x in (
         walk.o, walk.d, walk.rem, walk.med, walk.tr, walk.flags, walk.sites,
         walk.pending, walk.tmax, walk.track_med, walk.track_t))
    a.w_out = _ptr(walk_out)
    a.prim_attrs, a.mats, a.lights, a.cdf, a.med_table = (
        x.data_ptr() for x in (scene.prim_attrs, scene.mat_attrs,
                               scene.light_attrs, scene.light_cdf,
                               scene.med_table))
    a.rays = rays.data_ptr()
    a.n, a.step, a.max_depth = n, step, static.max_depth
    a.n_lights, a.n_rows = static.n_lights, n_light_rows(static)
    a.all_kinds = int(kernels.all_kinds(kinds_of(static)))
    a.aniso, a.has_media = int(static.has_aniso), int(static.has_media)
    a.seed, a.iteration = int(seed) & 0xFFFFFFFF, int(iteration) & 0xFFFFFFFF
    a.eps = float(scene.epsilon)
    rc = _lib().vpt_shade(ctypes.byref(a),
                          torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "vpt_shade")
    STATS.launches += 1
    lists.step, lists.round = step, 0
    return lane, walk


def tr_round_cuda(scene, static, t, prim, walk: Walk, walk_out=None,
                  rays=None) -> Walk:
    """Launch csrc/vpt_shade.cu's vpt_tr_round: `tr_round`'s contract on
    CUDA tensors (`rays` required), over the round's list, updating the
    walk in place; returns it."""
    dev = walk.o.device
    n = walk.o.shape[0]
    _check(dev, n, ("t", t, None, F32), ("prim", prim, None, I32),
           *_walk_specs(walk, walk_out), *_walk_state_specs(walk))
    _check_rays(rays, dev)
    _tables(scene, static, dev)
    lists = _lists_of(walk, dev, n)
    r = lists.round
    if r >= TR_MAX_SEGMENTS:
        raise ValueError(f"round {r}: a step's walk has {TR_MAX_SEGMENTS}")
    a = _TrArgs()
    a.list, a.next_list = (lists.walk[k % 2].data_ptr() for k in (r, r + 1))
    a.count = _count(lists, lists.step, 1 + r)
    a.next_count = _count(lists, lists.step, 2 + r)
    a.t, a.prim, a.o, a.d, a.rem, a.med, a.tr, a.flags, a.tmax = (
        x.data_ptr() for x in (t, prim, walk.o, walk.d, walk.rem, walk.med,
                               walk.tr, walk.flags, walk.tmax))
    a.track_med, a.track_t, a.track_o = (
        x.data_ptr() for x in (walk.track_med, walk.track_t, walk.track_o))
    a.out = _ptr(walk_out)
    a.prim_attrs = scene.prim_attrs.data_ptr()
    a.med_table = scene.med_table.data_ptr()
    a.rays = rays.data_ptr()
    a.n = n
    a.all_kinds = int(kernels.all_kinds(kinds_of(static)))
    rc = _lib().vpt_tr_round(ctypes.byref(a),
                             torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "vpt_tr_round")
    TR_STATS.launches += 1
    lists.round = r + 1
    return walk


def occupancy() -> dict:
    """The kernels' launch shapes on this card (csrc/vpt_shade.cu's
    vpt_occupancy): {"vpt_shade (env e, tex t, all kinds a, heterogeneous
    h)" or "vpt_tr_round (all kinds a)": {threads, blocks_per_sm,
    registers, local_bytes, blocks}}."""
    out = (ctypes.c_int * 90)()
    check_launch(_lib().vpt_occupancy(out), "vpt_occupancy")
    keys = ("threads", "blocks_per_sm", "registers", "local_bytes", "blocks")
    names = [f"vpt_shade (env {k >> 3 & 1}, tex {k >> 2 & 1}, all kinds "
             f"{k >> 1 & 1}, heterogeneous {k & 1})" for k in range(16)]
    names += [f"vpt_tr_round (all kinds {k})" for k in range(2)]
    return {name: dict(zip(keys, out[5 * j:5 * j + 5]))
            for j, name in enumerate(names)}


def finish_cuda(li, walk: Walk | None, walk_out=None):
    """Launch csrc/vpt_shade.cu's vpt_finish: `finish`'s contract on CUDA
    tensors."""
    dev = li.device
    n = li.shape[0]
    _check(dev, n, ("li", li, 3, F32),
           *(_walk_specs(walk, walk_out) if walk is not None else ()))
    a = _FinishArgs()
    if walk is not None:
        a.w_tr, a.w_flags, a.w_pend = (walk.tr.data_ptr(),
                                       walk.flags.data_ptr(),
                                       walk.pending.data_ptr())
        a.w_out = _ptr(walk_out)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    a.li, a.li_out, a.n = li.data_ptr(), out.data_ptr(), n
    rc = _lib().vpt_finish(ctypes.byref(a),
                           torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "vpt_finish")
    FINISH_STATS.launches += 1
    return out
