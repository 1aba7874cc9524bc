"""Wavefront path tracer (the reference Path kernel, pathtracer.cu:880-1021).

The port of gpu_pathtracer_tpu/integrators/pt.py. Per bounce: closest
hit -> the shading step (integrators/pt_shade.py, one CUDA kernel on
CUDA tensors): arrival credit (an emitter hit, or the sky on a miss,
MIS weighted against the previous BSDF pdf), NEE's light sample toward
an area light or the sky, BSDF sample (continuation + MIS pdf, the
diffuse colour read from the hit's texture where it has one), Russian
roulette after bounce 3 -> the shadow rays' any-hit query, whose
unoccluded credit the next bounce's shading step adds first; an
epilogue intersection and shading step collect the last NEE and
arrival credits. Lane state is one 16-float record a lane
(integrators/pt_shade.py::Wave) beside the next ray's [N, 3] ro and
rd; a lane that finishes writes its radiance to the caller's slot at
once and is not shaded again.

Random numbers: site d of lane i (lane id = pixel index) comes from the
Philox stream of core/rng.py, or from row d of an explicit
primary-sample matrix `psample [4 + 8 * max_depth, N]`; the megakernel
(integrators/pt_fused.py) reads the very same sites.

Coherence sorts (pt.py:80-98, 133-165, 238-256, 278-283): above
DENSE_MAX prims, where the block-culled and BVH8 walks care how close
neighbouring rays are, the primary rays are shuffled into pixel-morton
order, the lanes are re-sorted after every bounce by the next ray's
direction octant and origin cell (dead lanes last), and each lane's
radiance lands at its caller's slot when it finishes. Each sort is one
stable torch.sort of int32 keys and one gather of the next ray; the
shading step reads each lane's record through the sort's order. The
lane ids travel with the lanes and key every draw, and every step is
per lane, so the sorted estimator equals the unsorted one bit for bit,
lane for lane. An explicit `psample` (rows indexed by position) runs
unsorted, as in the JAX package.

Subsurface scattering (pt.py:190-198): a hit on a prim with a BSSRDF
adds the dipole's single and multiple scattering estimates
(shade/bssrdf.py) and ends the path. Its draws come from a stream of
their own, Philox tag BSSRDF_TAG, sites 16 b + k at bounce b, also
when an explicit `psample` drives the rest (the JAX package's psample
budget has no room for them).

Routing follows the JAX package: on CUDA tensors `render_lanes` hands
every scene that `pt_fused.supports` admits to the megakernel, the rest
run this wavefront over the intersection kernel of their regime
(geom/traverse.py); on CPU tensors the wavefront runs over the plain
intersection.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.core.rng import (
    BSSRDF_DIMS, BSSRDF_TAG, PSS_CAM_DIMS, PhiloxStream, lane_stream,
)
from gpu_pathtracer_tpu_torch.core.sampling import power_heuristic
from gpu_pathtracer_tpu_torch.core.vecmath import dot, is_black
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.geom.dense import DENSE_MAX
from gpu_pathtracer_tpu_torch.integrators.common import (
    _occluded_sorted, morton_bits, primary_rays, sorts_shadows,
)
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod


def lane_ids_of(static, pixel_x, pixel_y):
    """The lane id that keys every random site: the pixel index."""
    return pixel_y.long() * static.width + pixel_x.long()


def _sort_key(scene, ro, rd, alive):
    """Wavefront coherence key (pt.py:80-98): direction octant above a
    4-bit-per-axis origin morton code; dead lanes sort last. int32 (the
    values are below 2^21)."""
    q = torch.clamp(((ro - scene.world_center)
                     / (2.0 * max(scene.world_radius, 1e-6)) + 0.5)
                    * 15.999, 0.0, 15.0).to(torch.int32)
    octant = ((rd > 0.0).to(torch.int32)
              << torch.arange(3, dtype=torch.int32, device=rd.device)).sum(
                  -1, dtype=torch.int32)
    return torch.where(alive, (octant << 12) | morton_bits(q, 4), 1 << 20)


def _pixel_key(static, lanes):
    """Pixel-morton key of the primary rays (pt.py:148-165): tiles each
    run of lanes into a compact screen square."""
    xy = torch.stack([lanes % static.width, lanes // static.width], -1)
    return morton_bits(xy, 10)


def env_credit_weight(scene, static, full, prev_pdf):
    """MIS weight of the environment reached by a BSDF-sampled ray
    against its light-sample pdf (pt.py:50-55): 1 where `full`."""
    choice = lights_mod.light_choice_pdf(
        scene, torch.full_like(prev_pdf, static.n_lights, dtype=torch.int32))
    _, pdf_w = lights_mod.infinite_pdf(scene)
    return torch.where(full, 1.0, power_heuristic(prev_pdf, pdf_w * choice))


def _arrival_credit(scene, static, hit, ro, rd, li, beta, specular,
                    prev_pdf, alive, first: bool):
    """Emitter and environment radiance reached by the continuation ray,
    MIS-weighted against the BSDF pdf that generated it
    (pathtracer.cu:906-922, 953-992 folded). Returns (li, alive)."""
    full = specular | first
    if static.has_infinite:   # a miss sees the sky
        miss = alive & ~hit.valid
        w = env_credit_weight(scene, static, full, prev_pdf)
        env = lights_mod.infinite_le(scene, rd)
        li = li + torch.where(miss[:, None], beta * env * w[:, None], 0.0)
    alive = alive & hit.valid
    if static.n_lights > 0:
        lidx = torch.clamp_min(hit.light_idx, 0)
        emitter = alive & (hit.light_idx >= 0)
        le = lights_mod.area_light_le(scene, hit.light_idx, hit.nor, -rd)
        pdf_area, _ = lights_mod.area_light_pdf(scene, lidx, rd, hit.nor)
        lchoice = lights_mod.light_choice_pdf(scene, lidx)
        seg = hit.pos - ro
        len2 = dot(seg, seg)
        cos_l = torch.abs(dot(hit.nor, rd))
        l_pdf = pdf_area * len2 / torch.clamp_min(cos_l, 1e-30)
        w = torch.where(full, 1.0, power_heuristic(prev_pdf, l_pdf * lchoice))
        emitter = emitter & ~is_black(le)
        li = li + torch.where(emitter[:, None], beta * le * w[:, None], 0.0)
        # bounce-0 / specular emitter hits end the path (pathtracer.cu:
        # 917-922); MIS-credited hits continue
        alive = alive & ~((hit.light_idx >= 0) & full)
    return li, alive


def _subsurface(scene, static, seed, iteration, lanes, b, hit, rd, li,
                beta, sss, plain):
    """The BSSRDF hook of bounce b: the lanes `sss`, which hit a prim with
    a BSSRDF and ended there, gain beta x (single + multiple scattering).
    Returns (li, rays traced)."""
    from gpu_pathtracer_tpu_torch.shade import bssrdf as bssrdf_mod
    rng = PhiloxStream(seed, iteration, lanes, b * BSSRDF_DIMS, BSSRDF_DIMS,
                       BSSRDF_TAG, plain)
    ls, r1 = bssrdf_mod.single_scatter(scene, static, rng, hit.pos, hit.nor,
                                       hit.bssrdf_idx, -rd, sss, plain)
    lm, r2 = bssrdf_mod.multiple_scatter(scene, static, rng, hit.pos,
                                         hit.nor, hit.bssrdf_idx, -rd, sss,
                                         plain)
    ls = ls + lm
    ok = sss & torch.isfinite(ls).all(-1)
    li = li + torch.where(ok[:, None], beta * ls, 0.0)
    return li, r1 + r2


def render_lanes(scene, static, seed: int, iteration: int, pixel_x, pixel_y,
                 with_stats: bool = False, psample=None):
    """Per-lane radiance [N, 3] for one path-traced sample per lane.

    with_stats=True also returns the rays traced (closest hits + shadow
    rays) as a 0-d int64 tensor on the lanes' device."""
    from gpu_pathtracer_tpu_torch.integrators import pt_fused
    if pixel_x.is_cuda and pt_fused.supports(static):
        return pt_fused.render_lanes(scene, static, seed, iteration, pixel_x,
                                     pixel_y, with_stats, psample)
    return wavefront(scene, static, seed, iteration, pixel_x, pixel_y,
                     with_stats, psample, plain=False)


def wavefront(scene, static, seed, iteration, pixel_x, pixel_y,
              with_stats=False, psample=None, plain=False):
    """The wavefront estimator; `plain` runs it over the plain PyTorch
    intersection on any device (the megakernel's reference)."""
    with telemetry.span("pt.camera"):
        lanes = lane_ids_of(static, pixel_x, pixel_y)
        rng0 = lane_stream(seed, iteration, lanes, psample, 0, PSS_CAM_DIMS,
                           plain=plain)
        ro, rd = primary_rays(scene, static, rng0, pixel_x, pixel_y)
    return trace_paths(scene, static, seed, iteration, lanes, ro, rd,
                       with_stats, psample, plain)


def trace_paths(scene, static, seed, iteration, lanes, ro, rd,
                with_stats=False, psample=None, plain=False):
    """The wavefront's bounces from given primary rays: the part of the
    estimator that the megakernel (pt_fused.fused_call) replaces. Each
    bounce is a closest-hit query, the shading step
    (integrators/pt_shade.py: csrc/pt_shade.cu on CUDA tensors unless
    `plain`) over the lanes' records (`pt_shade.Wave`), the BSSRDF hook,
    the shadow rays' any-hit query and the coherence sort; the last NEE
    credit and arrival credit come from the shading step at b =
    max_depth. Each lane's radiance lands in the caller's order when the
    lane finishes. Lanes are sorted for coherence above DENSE_MAX prims
    unless `psample` is given. Spans (telemetry): "pt.camera" for the
    primary rays' sort and the wave's start, then per bounce b
    "pt.hit", "pt.shade", "pt.shadow" and "pt.sort"."""
    from gpu_pathtracer_tpu_torch.integrators import pt_shade
    n = ro.shape[0]
    dev = ro.device
    eps = scene.epsilon
    sort = psample is None and static.n_primitives > DENSE_MAX
    sort_shadows = sorts_shadows(static, ro)
    with telemetry.span("pt.camera"):
        slot = torch.arange(n, device=dev)   # the caller's order
        lanes = lanes.to(torch.int32)
        if sort:
            slot = torch.sort(_pixel_key(static, lanes), stable=True).indices
            ro, rd, lanes = ro[slot], rd[slot], lanes[slot]
        w = pt_shade.start(static, lanes, slot, ro, rd, sort, sort_shadows,
                           static.max_depth)
    if psample is not None and w.rec.shape[0] > n:   # the pad's columns
        psample = torch.nn.functional.pad(psample,
                                          (0, w.rec.shape[0] - n))
    occ = None
    for b in range(static.max_depth + 1):
        last = b == static.max_depth
        # finished lanes get an empty interval (tmax 0 < eps): the hit
        # kernels leave them at once; nothing reads their miss
        with telemetry.span("pt.hit", b):
            t, prim, _ = traverse.closest_prim(scene, static, w.ro, w.rd,
                                               eps, w.tmax, plain)
        with telemetry.span("pt.shade", b):
            pt_shade.shade(scene, static, b, seed, iteration, w, t, prim,
                           occ, psample, plain)
            if not last and static.has_bssrdf:
                # the lanes the shading step ended there
                _subsurface_hook(scene, static, seed, iteration, b, w, t,
                                 prim, plain)
        if last:
            break
        with telemetry.span("pt.shadow", b):
            occ = _occluded_sorted(scene, static, w.shadow_o, w.shadow_d,
                                   w.shadow_t, w.shadow_t > 0.0, eps, plain,
                                   w.shadow_key)
        if sort:   # re-sort by the next ray's coherence key
            with telemetry.span("pt.sort", b):
                pt_shade.advance(w)

    # NaN/Inf guard (pathtracer.cu:1019-1020): poisoned lanes are zeroed
    li = w.out[:n]
    bad = ~torch.isfinite(li).all(dim=-1)
    li = torch.where(bad[:, None], 0.0, li)
    if with_stats:
        return li, w.rays.sum()
    return li


def _subsurface_hook(scene, static, seed, iteration, b, w, t, prim, plain):
    """The BSSRDF hook on the records bounce b wrote: the lanes flagged
    SSS gain beta x (single + multiple scattering) in their li (their ro,
    rd are the bounce's: an SSS lane does not continue)."""
    from gpu_pathtracer_tpu_torch.integrators import pt_shade
    rec = w.written()
    f = pt_shade.fields(rec)
    sss = (f["flags"] & pt_shade.SSS) != 0
    if w.sorted:   # the records this bounce wrote of dead lanes: its list
        n = rec.shape[0]
        listed = torch.where(torch.arange(n, device=rec.device)
                             < w.counts[b + 1, 1], w.lists[(b + 1) % 2], n)
        on = torch.zeros(n + 1, dtype=torch.bool, device=rec.device)
        on[listed.long()] = True
        sss = sss & on[:n]
    hit = traverse._hit_attributes(scene, static, w.ro, w.rd, t, prim,
                                   prim >= 0)
    li, r = _subsurface(scene, static, seed, iteration, f["lanes"], b, hit,
                        w.rd, f["li"], f["beta"], sss, plain)
    rec[:, pt_shade.LI:pt_shade.LI + 3] = torch.where(sss[:, None], li,
                                                      f["li"])
    w.rays[0] += r
