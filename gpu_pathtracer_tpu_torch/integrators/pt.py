"""Wavefront path tracer (the reference Path kernel, pathtracer.cu:880-1021).

The port of gpu_pathtracer_tpu/integrators/pt.py. Per bounce: closest
hit -> arrival credit (an emitter hit, or the sky on a miss, MIS
weighted against the previous BSDF pdf) -> NEE toward an area light or
the sky -> BSDF sample (continuation + MIS pdf, the diffuse colour read
from the hit's texture where it has one) -> Russian roulette after
bounce 3; an epilogue intersection collects the last bounce's arrival
credit. Lane state is a set of [N] / [N, 3] tensors; dead lanes are
masked.

Random numbers: site d of lane i (lane id = pixel index) comes from the
Philox stream of core/rng.py, or from row d of an explicit
primary-sample matrix `psample [4 + 8 * max_depth, N]`; the megakernel
(integrators/pt_fused.py) reads the very same sites.

Coherence sorts (pt.py:80-98, 133-165, 238-256, 278-283): above
DENSE_MAX prims, where the block-culled and BVH8 walks care how close
neighbouring rays are, the primary rays are shuffled into pixel-morton
order, the lanes are re-sorted after every bounce by the next ray's
direction octant and origin cell (dead lanes last), and the radiance is
scattered back to the caller's order at the end. Each sort is one stable
torch.sort and one gather of the packed lane state. The lane ids travel
with the lanes and key every draw, and every step is per lane, so the
sorted estimator equals the unsorted one bit for bit, lane for lane. An
explicit `psample` (rows indexed by position) runs unsorted, as in the
JAX package.

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

from gpu_pathtracer_tpu_torch.core.rng import (
    BSSRDF_DIMS, BSSRDF_TAG, PSS_BOUNCE_DIMS, PSS_CAM_DIMS, PhiloxStream,
    lane_stream,
)
from gpu_pathtracer_tpu_torch.core.sampling import power_heuristic
from gpu_pathtracer_tpu_torch.core.vecmath import dot, is_black, luminance
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.geom.dense import DENSE_MAX
from gpu_pathtracer_tpu_torch.integrators.common import (
    direct_light_nee, morton_bits, permute_lanes, primary_rays,
)
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod


def lane_ids_of(static, pixel_x, pixel_y):
    """The lane id that keys every random site: the pixel index."""
    return pixel_y.long() * static.width + pixel_x.long()


def _sort_key(scene, ro, rd, alive):
    """Wavefront coherence key (pt.py:80-98): direction octant above a
    4-bit-per-axis origin morton code; dead lanes sort last."""
    q = torch.clamp(((ro - scene.world_center)
                     / (2.0 * max(scene.world_radius, 1e-6)) + 0.5)
                    * 15.999, 0.0, 15.0).to(torch.int64)
    octant = ((rd > 0.0).to(torch.int64)
              << torch.arange(3, device=rd.device)).sum(-1)
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
                beta, alive, rays, plain):
    """The BSSRDF hook of bounce b: lanes that hit a prim with a BSSRDF
    gain beta x (single + multiple scattering) and end. Returns (li,
    alive, rays)."""
    from gpu_pathtracer_tpu_torch.shade import bssrdf as bssrdf_mod
    rng = PhiloxStream(seed, iteration, lanes, b * BSSRDF_DIMS, BSSRDF_DIMS,
                       BSSRDF_TAG, plain)
    sss = alive & (hit.bssrdf_idx >= 0)
    ls, r1 = bssrdf_mod.single_scatter(scene, static, rng, hit.pos, hit.nor,
                                       hit.bssrdf_idx, -rd, sss, plain)
    lm, r2 = bssrdf_mod.multiple_scatter(scene, static, rng, hit.pos,
                                         hit.nor, hit.bssrdf_idx, -rd, sss,
                                         plain)
    ls = ls + lm
    ok = sss & torch.isfinite(ls).all(-1)
    li = li + torch.where(ok[:, None], beta * ls, 0.0)
    return li, alive & ~sss, rays + r1 + r2


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
    lanes = lane_ids_of(static, pixel_x, pixel_y)
    rng0 = lane_stream(seed, iteration, lanes, psample, 0, PSS_CAM_DIMS,
                       plain=plain)
    ro, rd = primary_rays(scene, static, rng0, pixel_x, pixel_y)
    return trace_paths(scene, static, seed, iteration, lanes, ro, rd,
                       with_stats, psample, plain)


def trace_paths(scene, static, seed, iteration, lanes, ro, rd,
                with_stats=False, psample=None, plain=False):
    """The wavefront's bounces from given primary rays: the part of the
    estimator that the megakernel (pt_fused.fused_call) replaces. Lanes
    are sorted for coherence above DENSE_MAX prims unless `psample` is
    given; the radiance comes back in the order of `lanes`."""
    n = ro.shape[0]
    dev = ro.device
    eps = scene.epsilon
    sort = psample is None and static.n_primitives > DENSE_MAX
    slot = torch.arange(n, device=dev)   # the caller's order
    if sort:
        order = torch.sort(_pixel_key(static, lanes), stable=True).indices
        (ro, rd), (lanes, slot) = permute_lanes(order, (ro, rd),
                                                (lanes, slot))

    li = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    specular = torch.zeros(n, dtype=torch.bool, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.ones(n, dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    for b in range(static.max_depth):
        rng = lane_stream(seed, iteration, lanes, psample,
                          PSS_CAM_DIMS + b * PSS_BOUNCE_DIMS, PSS_BOUNCE_DIMS,
                          plain=plain)
        rays = rays + alive.sum()
        # finished lanes get an empty interval (tmax 0 < eps): the hit
        # kernels leave them at once; nothing reads their miss
        hit = traverse.intersect_closest(
            scene, static, ro, rd, eps, torch.where(alive, torch.inf, 0.0),
            plain)
        li, alive = _arrival_credit(scene, static, hit, ro, rd, li, beta,
                                    specular, prev_pdf, alive, b == 0)
        if static.has_bssrdf:
            li, alive, rays = _subsurface(scene, static, seed, iteration,
                                          lanes, b, hit, rd, li, beta, alive,
                                          rays, plain)

        mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
        wi = -rd
        not_delta = ~bsdf_mod.is_delta(mat.type)

        # NEE light-sample branch (pathtracer.cu:925-951)
        ld, lit, shadow = direct_light_nee(scene, static, rng, hit.pos,
                                           hit.nor, hit.dpdu, mat, wi,
                                           alive & not_delta, plain)
        li = li + torch.where(lit[:, None], beta * ld, 0.0)
        rays = rays + shadow.sum()

        # one BSDF sample: continuation + MIS pdf (pathtracer.cu:997-1008)
        u1, u2, u3 = rng.uniform3()
        wo, fr, pdf = bsdf_mod.sample_bsdf(
            mat, wi, hit.nor, hit.dpdu, u1, u2, u3, static.material_types)
        alive = alive & ~(is_black(fr) | (pdf <= 0.0))
        beta_next = beta * fr * torch.abs(dot(hit.nor, wo))[:, None] \
            / torch.clamp_min(pdf, 1e-30)[:, None]
        beta = torch.where(alive[:, None], beta_next, beta)
        specular = torch.where(alive, bsdf_mod.is_delta(mat.type), specular)
        prev_pdf = torch.where(alive, pdf, prev_pdf)
        ro = torch.where(alive[:, None], hit.pos, ro)
        rd = torch.where(alive[:, None], wo, rd)

        # Russian roulette after bounce 3 (pathtracer.cu:1010-1016)
        u_rr = rng.uniform()
        if b > 3:
            illumate = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
            alive = alive & ~(u_rr < illumate)
            rr_scale = 1.0 / torch.clamp_min(1.0 - illumate, 1e-30)
            beta = torch.where(alive[:, None], beta * rr_scale[:, None],
                               beta)

        if sort:   # re-sort by the next ray's coherence key
            order = torch.sort(_sort_key(scene, ro, rd, alive),
                               stable=True).indices
            flags = specular.to(torch.int32) | (alive.to(torch.int32) << 1)
            (ro, rd, li, beta, prev_pdf), (lanes, slot, flags) = \
                permute_lanes(order, (ro, rd, li, beta, prev_pdf),
                              (lanes, slot, flags))
            specular = (flags & 1) != 0
            alive = (flags & 2) != 0

    # epilogue: the last continuation ray's emitter credit
    rays = rays + alive.sum()
    hit = traverse.intersect_closest(
        scene, static, ro, rd, eps, torch.where(alive, torch.inf, 0.0), plain)
    li, _ = _arrival_credit(scene, static, hit, ro, rd, li, beta, specular,
                            prev_pdf, alive, False)
    if sort:   # back to the caller's lane order
        li = torch.empty_like(li).index_put_((slot.long(),), li)

    # NaN/Inf guard (pathtracer.cu:1019-1020): poisoned lanes are zeroed
    bad = ~torch.isfinite(li).all(dim=-1)
    li = torch.where(bad[:, None], 0.0, li)
    if with_stats:
        return li, rays
    return li
