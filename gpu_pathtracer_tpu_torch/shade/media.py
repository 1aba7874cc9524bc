"""Participating media: homogeneous and heterogeneous (grid) media.

The port of gpu_pathtracer_tpu/shade/media.py: the reference's media
(medium.h:9-179) and the interface-walking transmittance of its Volpath
kernel (pathtracer.cu:298-322).

- `medium_sample`: distance sampling in the lane's current medium,
  homogeneous analytic (medium.h:40-48) or heterogeneous delta tracking
  (medium.h:133-157).
- `medium_tr_segment`: transmittance through one medium segment,
  Beer-Lambert or delta / ratio / residual-ratio tracking by the
  medium's `ett` (medium.h:64-131).
- `transmittance`: the shadow-ray walk through material-less interfaces,
  at most TR_MAX_SEGMENTS segments.

Heterogeneous tracking runs through `track`: one medium segment per ray,
clipped to the density box, cut into NSEG equal segments, each with the
local majorant of the supervoxel grid (`_segment_majorants`, the JAX
package's K5 lookup). Candidates are a Poisson process at the piecewise
constant rate sigma * majorant: one exponential optical depth
tau = -log(1 - u) per candidate, carried across segment boundaries
(each segment crossed takes rate * its remaining length from it), the
candidate where tau runs out; a candidate reads the trilinear density of
the bf16-pair oct table (`_density_oct`). So a walk draws one Philox
word per candidate, plus at most one whose tau outlasts the last
segment: draw 0 at the start, draw j right after candidate j - 1. On
CUDA tensors `track` launches csrc/track.cu (shade/media_cuda.py), the
counterpart of the TPU kernel ops/small_gather.py::_kernel (K5): a
classify pass, then a persistent walk over a device queue of the lanes
that walk, bound by the latency of its dependent segment and candidate
steps; its `segment_majorants` entry, bound by the bytes it writes,
computes `_segment_majorants`. On CPU tensors, or with `plain`, `track`
runs `_track_torch`, the same walk over all lanes in lock step. Both
draw the same Philox words (core/rng.py: counter (lane, 0, tag, j), j
counting the lane's draws) in the same order, so they agree bit for
bit.

The walk matches the JAX estimator in distribution, not in bits: the JAX
package draws each segment's Poisson count at once and evaluates the
candidates in chunks. Deviations: no SEG_COUNT_CAP truncation of a
segment's count; ratio and residual-ratio Tr keep medium.h's Russian
roulette below 0.1 after every candidate (the JAX CPU route does it per
chunk of 32, media.py:932-937); the walk stops after `med_iter_max`
draws, which count candidates (plus the last draw), as the reference's
iterMax does.

Not ported, as the GPU gathers per lane and the CUDA walk keeps its own
queue of the lanes that walk: the TPU's lane compaction and slicing
(`FORCE_COMPACT`, `_compact_*`, `_track_slices`, `_prefix_slices`,
`_cumsum_lanes`), its flat candidate queue (`FLAT_QUEUE`,
`_flat_candidate_loop`), `_select_by_segment`, the u16 / bf16 row
packing of majorants and counts, `_bf16_up`, and the unused `_density`
of the x-pair grid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpu_pathtracer_tpu_torch.core.rng import bits_to_uniform, track_words
from gpu_pathtracer_tpu_torch.core.sampling import hg_phase, hg_sample
from gpu_pathtracer_tpu_torch.core.vecmath import (
    dot, make_coordinate, to_world,
)
from gpu_pathtracer_tpu_torch.scene.flatten import sv_res
from gpu_pathtracer_tpu_torch.scene.model import MediumType

TR_MAX_SEGMENTS = 8   # interface crossings of the Tr walk
NSEG = 42             # ray segments of the tracking walk: ceil(sqrt(3) * 24)
MODE_SAMPLE = 0       # `track` modes: first collision t, or transmittance
MODE_TR = 1
HETEROGENEOUS = int(MediumType.HETEROGENEOUS)


class TrackKey(NamedTuple):
    """Where a tracking walk draws: Philox counters (lane, 0, tag, j)
    under key (seed, iteration); `tag` from core/rng.py::track_tag. With
    `sites` (int32 [N]), lane i draws at tag | (sites[i] << 4): the call
    site field of track_tag set per lane, so that one walk serves lanes
    of several call sites, each where its own walk would draw."""
    seed: int
    iteration: int
    lanes: torch.Tensor   # [N] lane ids (pixel indices)
    tag: int
    sites: torch.Tensor | None = None   # [N] int32 call sites, or None


def gather_medium(scene, med_idx):
    """Per-lane medium record, one row of `scene.med_table` per lane;
    med_idx may be -1 (vacuum: callers mask)."""
    k = torch.clamp_min(med_idx, 0).long()
    a = scene.med_table[k]
    return {
        "type": a[:, 0].to(torch.int32), "g": a[:, 1],
        "sigma_a": a[:, 2:5], "sigma_s": a[:, 5:8], "sigma_t": a[:, 8:11],
        "inv_max_density": a[:, 11], "ett": a[:, 12].to(torch.int32),
        "p0": a[:, 13:16], "p1": a[:, 16:19],
        "n": a[:, 19:22].to(torch.int32), "sigma": a[:, 22], "idx": k,
    }


def _density_oct(scene, med_idx, med_n, pos_norm):
    """Trilinear density at [M] points (media.py:152-204): ONE row of the
    oct table holds a cell's 8 corners as bf16 pairs, decoded as
    (vi & 0xFFFF0000) and (vi << 16). Corners outside [0, n-1] read the
    zero border; far-outside taps are clipped into it."""
    _, dz1, dy1, dx1, _ = scene.med_density_oct4.shape
    ps = pos_norm * med_n.float()
    psi = torch.floor(ps)
    f = ps - psi
    xi = torch.clamp(psi[:, 0].to(torch.int32) + 1, 0, dx1 - 1)
    yi = torch.clamp(psi[:, 1].to(torch.int32) + 1, 0, dy1 - 1)
    zi = torch.clamp(psi[:, 2].to(torch.int32) + 1, 0, dz1 - 1)
    flat = (med_idx * (dz1 * dy1 * dx1) + zi * (dy1 * dx1) + yi * dx1 + xi)
    vi = scene.med_density_oct4.reshape(-1, 4)[flat.long()] \
        .view(torch.int32)
    ve = (vi & -65536).view(torch.float32)
    vo = (vi << 16).view(torch.float32)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    d00 = ve[:, 0] * (1.0 - fx) + vo[:, 0] * fx
    d10 = ve[:, 1] * (1.0 - fx) + vo[:, 1] * fx
    d01 = ve[:, 2] * (1.0 - fx) + vo[:, 2] * fx
    d11 = ve[:, 3] * (1.0 - fx) + vo[:, 3] * fx
    d0 = d00 * (1.0 - fy) + d10 * fy
    d1 = d01 * (1.0 - fy) + d11 * fy
    return d0 * (1.0 - fz) + d1 * fz


def _box_clip(med, ro, rd, tmax):
    """Ray / density-box overlap [t0, t0 + ln] within [0, tmax]
    (media.py:216-231): density is zero outside the box."""
    eps = 1e-20
    inv = 1.0 / torch.where(torch.abs(rd) > eps, rd,
                            torch.where(rd >= 0.0, eps, -eps))
    t1 = (med["p0"] - ro) * inv
    t2 = (med["p1"] - ro) * inv
    tn = torch.amax(torch.minimum(t1, t2), -1)
    tf = torch.amin(torch.maximum(t1, t2), -1)
    t0 = torch.minimum(torch.clamp_min(tn, 0.0), tmax)
    t_end = torch.minimum(torch.clamp_min(tf, 0.0), tmax)
    return t0, torch.clamp_min(t_end - t0, 0.0)


def _seg_len(tmax):
    """tmax / NSEG as an IEEE division. (PyTorch's CUDA division by a
    Python scalar multiplies by the scalar's reciprocal, which rounds
    differently; csrc/track.cu divides.)"""
    return tmax / torch.full_like(tmax, float(NSEG))


def _segment_majorants(scene, med, ro, rd, tmax):
    """Local majorant of each of the NSEG equal segments of [0, tmax]
    (media.py:234-262, the JAX package's K5 lookup): the max over the
    2x2x2 supervoxel block at the segment's low corner, read from
    `med_sv_max`; the medium's global majorant where a segment spans
    more than one supervoxel on some axis. Returns maj [N, NSEG]."""
    s1 = sv_res(scene.med_type.shape[0]) + 1
    span = med["p1"] - med["p0"]
    seg = _seg_len(tmax)
    ts = torch.arange(NSEG + 1, dtype=torch.float32,
                      device=ro.device)[None, :] * seg[:, None]
    p = ro[:, None, :] + rd[:, None, :] * ts[..., None]
    svc = (p - med["p0"][:, None, :]) / span[:, None, :] * (s1 - 1.0)
    lo = torch.minimum(svc[:, :-1], svc[:, 1:])
    cell = torch.clamp(torch.floor(lo).to(torch.int32) + 1, 0, s1 - 1)
    flat = (med["idx"][:, None].to(torch.int32) * (s1 * s1 * s1)
            + cell[..., 2] * (s1 * s1) + cell[..., 1] * s1 + cell[..., 0])
    maj = scene.med_sv_max[flat.long()]
    local_ok = (torch.abs(svc[:, 1] - svc[:, 0]) <= 1.0).all(-1)
    maxd = 1.0 / torch.clamp_min(med["inv_max_density"], 1e-30)
    return torch.where(local_ok[:, None], maj, maxd[:, None])


def track(scene, static, mode: int, med_idx, ro, rd, tmax, key: TrackKey,
          plain: bool = False):
    """The tracking walk of one medium segment [0, tmax] per ray, for
    lanes whose medium is heterogeneous (med_idx = -1 elsewhere).
    Returns (out [N], candidates [N] i32): in MODE_SAMPLE out is the
    distance of the first collision from ro, +inf if none; in MODE_TR
    the transmittance (1 on other lanes). CUDA tensors launch the kernel
    unless `plain`; CPU tensors run the plain version."""
    if ro.is_cuda and not plain:
        from gpu_pathtracer_tpu_torch.shade import media_cuda
        return media_cuda.track_cuda(scene, mode, med_idx, ro, rd, tmax,
                                     key, static.med_iter_max)
    return _track_torch(scene, mode, med_idx, ro, rd, tmax, key,
                        static.med_iter_max)


def _track_torch(scene, mode, med_idx, ro, rd, tmax, key, iter_max):
    """The plain version of `track`: every lane walks its segments and
    candidates in lock step, with per-lane state (segment s, draws j,
    position t, optical depth tau left of the last draw); each loop pass
    either crosses a segment or takes a candidate on each lane still
    walking. Draw 0 comes first, draw j right after candidate j - 1
    unless the walk ends there. csrc/track.cu does the same walk one
    thread per lane."""
    if ro.is_cuda:
        from gpu_pathtracer_tpu_torch.shade import media_cuda
        media_cuda.STATS.plain_cuda += 1
    n = ro.shape[0]
    dev = ro.device
    med = gather_medium(scene, med_idx)
    het = (med_idx >= 0) & (med["type"] == HETEROGENEOUS)
    t_box, ln = _box_clip(med, ro, rd, tmax)
    ln = torch.where(het, ln, 0.0)
    ro_h = ro + rd * t_box[:, None]
    maj = _segment_majorants(scene, med, ro_h, rd, ln)
    seg_len = _seg_len(ln)
    ce = 0.5 * (1.0 / torch.clamp_min(med["inv_max_density"], 1e-30))
    sigma, ett = med["sigma"], med["ett"]
    span = torch.clamp_min(med["p1"] - med["p0"], 1e-30)
    lanes = key.lanes.to(torch.int64) & 0xFFFFFFFF
    tags = key.tag if key.sites is None else \
        key.tag | (key.sites.to(torch.int64) << 4)

    def draw(i, j_i):
        """(tau, acceptance uniform, roulette uniform) of draw j_i."""
        w0, w1, w2 = track_words(key.seed, key.iteration, lanes[i],
                                 tags if key.sites is None else tags[i], j_i)
        return (-torch.log(1.0 - bits_to_uniform(w0)), bits_to_uniform(w1),
                bits_to_uniform(w2))

    t = torch.zeros(n, device=dev)
    s = torch.zeros(n, dtype=torch.int64, device=dev)
    j = torch.zeros(n, dtype=torch.int64, device=dev)
    tr = torch.ones(n, device=dev)
    found = torch.full((n,), torch.inf, device=dev)
    cand = torch.zeros(n, dtype=torch.int32, device=dev)
    live = torch.nonzero(het & (ln > 0.0))[:, 0]
    tau = torch.zeros(n, device=dev)      # optical depth left of the draw
    u_acc = torch.zeros(n, device=dev)    # its acceptance uniform
    u_rr = torch.zeros(n, device=dev)     # and its roulette uniform
    tau[live], u_acc[live], u_rr[live] = draw(live, 0)
    j[live] = 1
    while live.numel():
        i = live
        m = maj[i, s[i]]
        e = ett[i]
        rate = torch.maximum(m, ce[i]) if mode == MODE_TR else m
        if mode == MODE_TR:
            rate = torch.where(e == 2, rate, m)
        lam = sigma[i] * rate
        s_end = (s[i] + 1).float() * seg_len[i]
        t_i, tau_i = t[i], tau[i]
        # tau outlasts the segment: cross it; else the candidate
        depth = lam * (s_end - t_i)
        cross = ~(tau_i < depth)
        is_cand = ~cross
        tau_i = torch.where(cross, tau_i - depth, tau_i)
        ti = torch.where(cross, s_end,
                         torch.minimum(t_i + tau[i] / lam, s_end))
        t[i] = ti
        s[i] = s[i] + cross.long()
        cand[i] = cand[i] + is_cand.int()

        p = ro_h[i] + rd[i] * ti[:, None]
        pos_norm = (p - med["p0"][i]) / span[i]
        dens = _density_oct(scene, torch.where(is_cand, med_idx[i], 0)
                            .to(torch.int32), med["n"][i], pos_norm)
        hit = is_cand & (dens > u_acc[i] * m)
        if mode == MODE_SAMPLE:
            found[i] = torch.where(hit, t_box[i] + ti, found[i])
            stop = hit
        else:
            tr_i = tr[i]
            f_ratio = 1.0 - dens / torch.clamp_min(m, 1e-30)
            f_res = 1.0 - (dens - ce[i]) / torch.clamp_min(rate, 1e-30)
            tr_new = torch.where(e == 0, torch.where(hit, 0.0, tr_i),
                                 torch.where(e == 1, tr_i * f_ratio,
                                             tr_i * f_res))
            tr_new = torch.where(is_cand, tr_new, tr_i)
            # Russian roulette below 0.1 (medium.h:95-104, 117-127)
            rr = is_cand & (e != 0) & (tr_new < 0.1) & (tr_new >= 0.0)
            kill = rr & (u_rr[i] < 1.0 - tr_new)
            tr_new = torch.where(kill, 0.0, torch.where(rr, 1.0, tr_new))
            tr[i] = tr_new
            stop = is_cand & (tr_new == 0.0)
        # the next draw, after a candidate that does not end the walk
        after = is_cand & ~stop
        redraw = after & (j[i] < iter_max)
        d_tau, d_acc, d_rr = draw(i, j[i])
        tau[i] = torch.where(redraw, d_tau, tau_i)
        u_acc[i] = torch.where(redraw, d_acc, u_acc[i])
        u_rr[i] = torch.where(redraw, d_rr, u_rr[i])
        j[i] = j[i] + redraw.long()
        go = ~stop & (redraw | ~after) & (s[i] < NSEG)
        live = i[go]
    if mode == MODE_SAMPLE:
        return found, cand
    tc = torch.exp(-ln * ce * sigma)   # the residual-ratio control
    return torch.where(ett == 2, tr * tc, tr), cand


def medium_sample(scene, static, med_idx, ro, rd, tmax, u0, key: TrackKey,
                  active, plain: bool = False):
    """Distance sampling in the lane's current medium over [0, tmax]
    (media.py:508-566). u0 [N] drives the homogeneous sample; the
    heterogeneous walk draws at `key`. Returns (weight [N, 3], t [N],
    sampled [N]); lanes outside a medium or not active get weight 1,
    t = tmax, sampled False."""
    found_t = None
    if static.has_hetero:
        med = gather_medium(scene, med_idx)
        is_het = active & (med_idx >= 0) & (med["type"] == HETEROGENEOUS)
        found_t, _ = track(scene, static, MODE_SAMPLE,
                           torch.where(is_het, med_idx, -1), ro, rd, tmax,
                           key, plain)
    return sample_weight(scene, static, med_idx, tmax, u0, found_t, active)


def sample_weight(scene, static, med_idx, tmax, u0, found_t, active):
    """`medium_sample` after its walk: found_t [N] is the heterogeneous
    walk's first collision (+inf if none; None without heterogeneous
    media). Returns (weight [N, 3], t [N], sampled [N])."""
    in_medium = active & (med_idx >= 0)
    med = gather_medium(scene, med_idx)
    sigma = med["sigma"]

    # homogeneous analytic (medium.h:40-48)
    dist_h = -torch.log(torch.clamp_min(1.0 - u0, 1e-30)) / sigma
    tr_h = torch.exp(med["sigma_t"] * (-dist_h[:, None]))
    pdf_h = sigma * torch.exp(-sigma * dist_h)
    sampled_h = dist_h < tmax
    w_h = torch.where(sampled_h[:, None],
                      tr_h * med["sigma_s"] / pdf_h[:, None],
                      med["sigma_t"] * tr_h / pdf_h[:, None])
    if not static.has_hetero:
        return (torch.where(in_medium[:, None], w_h, 1.0),
                torch.where(in_medium, dist_h, tmax), in_medium & sampled_h)

    # heterogeneous delta tracking (medium.h:133-157)
    is_het = in_medium & (med["type"] == HETEROGENEOUS)
    hit_d = is_het & torch.isfinite(found_t)
    w_d = torch.where(hit_d[:, None], med["sigma_s"]
                      / torch.clamp_min(med["sigma_t"], 1e-30), 1.0)
    weight = torch.where(is_het[:, None], w_d,
                         torch.where(in_medium[:, None], w_h, 1.0))
    t = torch.where(is_het, torch.where(hit_d, found_t, tmax),
                    torch.where(in_medium, dist_h, tmax))
    sampled = torch.where(is_het, hit_d, in_medium & sampled_h)
    return weight, t, sampled


def medium_tr_segment(scene, static, med_idx, ro, rd, tmax, key: TrackKey,
                      active, plain: bool = False):
    """Transmittance through one medium segment of length tmax
    (media.py:771-818): Beer-Lambert, or the tracking walk in the
    medium's `ett` mode. Returns tr [N, 3]."""
    in_medium = active & (med_idx >= 0)
    med = gather_medium(scene, med_idx)
    tr_h = torch.exp(med["sigma_t"] * (-tmax[:, None]))
    if not static.has_hetero:
        return torch.where(in_medium[:, None], tr_h, 1.0)
    is_het = in_medium & (med["type"] == HETEROGENEOUS)
    tr_d, _ = track(scene, static, MODE_TR, torch.where(is_het, med_idx, -1),
                    ro, rd, tmax, key, plain)
    return torch.where(is_het[:, None], tr_d[:, None],
                       torch.where(in_medium[:, None], tr_h, 1.0))


def transmittance(scene, static, med_idx, ro, rd, tmax, key: TrackKey,
                  active, plain: bool = False):
    """Shadow transmittance through interfaces (pathtracer.cu:298-322,
    media.py:950-1053): any hit with a real material blocks (tr = 0); a
    material-less hit switches the medium by crossing side and the walk
    goes on, for at most TR_MAX_SEGMENTS segments. Segment w tracks at
    tag `key.tag + w`. Returns (tr [N, 3], segment rays traced: 0-d
    int64).

    On CUDA tensors every segment runs (lanes that stopped walking are
    masked, so no host sync gates the loop); elsewhere the loop ends
    once no lane walks, which changes no result."""
    from gpu_pathtracer_tpu_torch.geom import traverse
    n = ro.shape[0]
    tr = torch.ones((n, 3), device=ro.device)
    rays = torch.zeros((), dtype=torch.int64, device=ro.device)
    cur_o, cur_med, remaining, walking = ro, med_idx, tmax, active
    gate = plain or not ro.is_cuda
    for seg in range(TR_MAX_SEGMENTS):
        if gate and not bool(walking.any()):
            break
        rays = rays + walking.sum()
        hit = traverse.intersect_closest(
            scene, static, cur_o, rd, scene.epsilon,
            torch.where(walking, remaining, 0.0), plain)
        blocked = walking & hit.valid & (hit.mat_idx != -1)
        tr = torch.where(blocked[:, None], 0.0, tr)
        walking = walking & ~blocked
        seg_len = torch.where(hit.valid, hit.t, remaining)
        if static.has_media:
            seg_tr = medium_tr_segment(
                scene, static, cur_med, cur_o, rd, seg_len,
                key._replace(tag=key.tag + seg), walking, plain)
            tr = torch.where(walking[:, None], tr * seg_tr, tr)
        walking = walking & hit.valid
        # cross the interface: the medium by crossing side (cu:315-316)
        going_out = dot(rd, hit.nor) > 0.0
        next_med = torch.where(going_out, hit.medium_outside,
                               hit.medium_inside)
        cur_med = torch.where(walking, next_med, cur_med)
        remaining = torch.where(walking, remaining - hit.t, remaining)
        cur_o = torch.where(walking[:, None], hit.pos, cur_o)
    return tr, rays


def sample_phase(scene, med_idx, wi, u1, u2):
    """Medium::SamplePhase (media.py:1056-1070): HG or isotropic, sampled
    about `wi` (the JAX package's deviation from the reference's fixed
    +Y frame, so that the returned phase equals phase(wi, d) for g != 0).
    Returns (dir [N, 3], phase [N]) with pdf == phase."""
    med = gather_medium(scene, med_idx)
    d_local, ph = hg_sample(u1, u2, med["g"])
    uu, ww = make_coordinate(wi)
    return to_world(d_local, uu, wi, ww), ph


def phase(scene, med_idx, wi, wo):
    """Medium::Phase (medium.h:222-234), wi/wo as the reference's
    Phase(-r.d, shadowRay.d)."""
    return hg_phase(dot(wi, wo), gather_medium(scene, med_idx)["g"])
