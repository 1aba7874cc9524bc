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

STATS = KernelStats()          # vpt_shade
TR_STATS = KernelStats()       # vpt_tr_round
FINISH_STATS = KernelStats()   # vpt_finish

SPECULAR, ALIVE, FROM_SURF = 1, 2, 4               # lane flags
WALKING, EMIT, FOLD = 1, 2, 4                      # walk flags
SCATTER, SURFACE, EMITTER = 8, 16, 32              # the credit that waits
CREDIT = SCATTER | SURFACE | EMITTER
PEND = 12   # pending factors a lane: a [3], b [3], c [3], s, cos, denom


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
    track_t: torch.Tensor | None = None     # call, medium (-1) and length


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
                torch.where(walking, rem, 0.0), track_med, track_t)


def finish_torch(li, walk: Walk | None, walk_out=None):
    """The plain version of `finish`."""
    if li.is_cuda:
        FINISH_STATS.plain_cuda += 1
    if walk is not None:
        li = _settle(walk, walk_out, li)
    # NaN/Inf guard: poisoned lanes are zeroed
    bad = ~torch.isfinite(li).all(dim=-1)
    return torch.where(bad[:, None], 0.0, li)


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
        "t prim found_t lanes ro rd li beta prev_pdf depth med flags w_tr "
        "w_flags w_pend w_out prim_attrs mats lights cdf med_table env_data "
        "env_u env_v env_wa tex tex_offset tex_w tex_h ro_out rd_out li_out "
        "beta_out pdf_out depth_out med_out flags_out tmax_out "
        "med_sample_out wo_out wd_out wrem_out wmed_out wtr_out wflags_out "
        "sites_out pend_out wtmax_out rays",
        "n step max_depth n_lights n_rows all_kinds env_w env_h aniso "
        "has_media", "seed iteration", "eps env_tmax")


class _TrArgs(ctypes.Structure):   # VptTrArgs
    _fields_ = _fields(
        "t prim o d rem med tr flags out prim_attrs med_table o_out rem_out "
        "med_out tr_out flags_out tmax_out track_med_out track_t_out rays",
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


def shade_cuda(scene, static, step, seed, iteration, lanes, t, prim,
               lane: Lanes, found_t=None, walk: Walk | None = None,
               walk_out=None, rays=None):
    """Launch csrc/vpt_shade.cu's vpt_shade: `shade`'s contract on CUDA
    tensors (`rays` required)."""
    dev = lane.ro.device
    n = lane.ro.shape[0]
    _check(dev, n, ("t", t, None, F32), ("prim", prim, None, I32),
           ("lanes", lanes, None, I64), ("ro", lane.ro, 3, F32),
           ("rd", lane.rd, 3, F32), ("li", lane.li, 3, F32),
           ("beta", lane.beta, 3, F32), ("prev_pdf", lane.prev_pdf, None, F32),
           ("depth", lane.depth, None, I32), ("med", lane.med, None, I32),
           ("flags", lane.flags, None, I32), ("found_t", found_t, None, F32),
           *(_walk_specs(walk, walk_out) if walk is not None else ()))
    if static.has_hetero != (found_t is not None):
        raise ValueError("found_t is the sample walk's result: given with "
                         "heterogeneous media, and only then")
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

    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = Lanes(*(torch.empty((n, 3), **f32) for _ in range(4)),
                torch.empty(n, **f32), torch.empty(n, **i32),
                torch.empty(n, **i32), torch.empty(n, **i32),
                torch.empty(n, **f32),
                torch.empty(n, **i32) if static.has_hetero else None)
    w = Walk(torch.empty((n, 3), **f32), torch.empty((n, 3), **f32),
             torch.empty(n, **f32), torch.empty(n, **i32),
             torch.empty((n, 3), **f32), torch.empty(n, **i32),
             torch.empty(n, **i32), torch.empty((n, PEND), **f32),
             torch.empty(n, **f32))
    a.t, a.prim, a.found_t, a.lanes = (_ptr(x) for x in (t, prim, found_t,
                                                        lanes))
    a.ro, a.rd, a.li, a.beta, a.prev_pdf, a.depth, a.med, a.flags = (
        x.data_ptr() for x in (lane.ro, lane.rd, lane.li, lane.beta,
                               lane.prev_pdf, lane.depth, lane.med,
                               lane.flags))
    if walk is not None:
        a.w_tr, a.w_flags, a.w_pend = (walk.tr.data_ptr(),
                                       walk.flags.data_ptr(),
                                       walk.pending.data_ptr())
        a.w_out = _ptr(walk_out)
    a.prim_attrs, a.mats, a.lights, a.cdf, a.med_table = (
        x.data_ptr() for x in (scene.prim_attrs, scene.mat_attrs,
                               scene.light_attrs, scene.light_cdf,
                               scene.med_table))
    (a.ro_out, a.rd_out, a.li_out, a.beta_out, a.pdf_out, a.depth_out,
     a.med_out, a.flags_out, a.tmax_out) = (
        x.data_ptr() for x in (out.ro, out.rd, out.li, out.beta,
                               out.prev_pdf, out.depth, out.med, out.flags,
                               out.tmax))
    a.med_sample_out = _ptr(out.med_sample)
    (a.wo_out, a.wd_out, a.wrem_out, a.wmed_out, a.wtr_out, a.wflags_out,
     a.sites_out, a.pend_out, a.wtmax_out) = (
        x.data_ptr() for x in (w.o, w.d, w.rem, w.med, w.tr, w.flags,
                               w.sites, w.pending, w.tmax))
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
    return out, w


def tr_round_cuda(scene, static, t, prim, walk: Walk, walk_out=None,
                  rays=None) -> Walk:
    """Launch csrc/vpt_shade.cu's vpt_tr_round: `tr_round`'s contract on
    CUDA tensors (`rays` required)."""
    dev = walk.o.device
    n = walk.o.shape[0]
    _check(dev, n, ("t", t, None, F32), ("prim", prim, None, I32),
           ("walk o", walk.o, 3, F32), ("walk d", walk.d, 3, F32),
           ("walk rem", walk.rem, None, F32), ("walk med", walk.med, None, I32),
           *_walk_specs(walk, walk_out))
    _check_rays(rays, dev)
    _tables(scene, static, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    w = Walk(torch.empty((n, 3), **f32), walk.d, torch.empty(n, **f32),
             torch.empty(n, **i32), torch.empty((n, 3), **f32),
             torch.empty(n, **i32), walk.sites, walk.pending,
             torch.empty(n, **f32), torch.empty(n, **i32),
             torch.empty(n, **f32))
    a = _TrArgs()
    a.t, a.prim, a.o, a.d, a.rem, a.med, a.tr, a.flags = (
        x.data_ptr() for x in (t, prim, walk.o, walk.d, walk.rem, walk.med,
                               walk.tr, walk.flags))
    a.out = _ptr(walk_out)
    a.prim_attrs = scene.prim_attrs.data_ptr()
    a.med_table = scene.med_table.data_ptr()
    (a.o_out, a.rem_out, a.med_out, a.tr_out, a.flags_out, a.tmax_out,
     a.track_med_out, a.track_t_out) = (
        x.data_ptr() for x in (w.o, w.rem, w.med, w.tr, w.flags, w.tmax,
                               w.track_med, w.track_t))
    a.rays = rays.data_ptr()
    a.n = n
    a.all_kinds = int(kernels.all_kinds(kinds_of(static)))
    rc = _lib().vpt_tr_round(ctypes.byref(a),
                             torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "vpt_tr_round")
    TR_STATS.launches += 1
    return w


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
