"""The path-tracing estimator (pathtracer.cu:880-1021), one path a lane.

Lane i renders pixel `pixels[i]` at iteration `its[i]`, so one call can
hold any mix of iterations. Draws (tag 0, keyed by the pixel index):
sites 0-1 the pixel jitter, 2-3 the aperture (unused by a pinhole);
bounce b reads 4 + 8 b + k: k = 0 the light pick, 1-2 the light point,
3-5 the BSDF sample, 6 the Russian roulette after bounce 3. Each bounce
takes the previous bounce's light sample where its shadow ray was not
blocked, then the emitter reached (MIS against the BSDF pdf, full
weight at the first hit), then samples a light and the BSDF. The last
pass, at b = max depth, adds only the two credits.
"""

from __future__ import annotations

import torch

from benchmark.reference import geometry as geo
from benchmark.reference import shading as sh
from benchmark.reference.rng import Stream

CAMERA_SITES, BOUNCE_SITES = 4, 8


def radiance(scene, seed: int, its, pixels, dtype=torch.float32):
    """[N, 3] radiance of one path for each (iteration, pixel) lane."""
    dev = pixels.device
    eps = scene.epsilon
    n = pixels.shape[0]
    its, pixels = its.to(torch.int64), pixels.to(torch.int64)
    cam = Stream(seed, its, pixels, 0, dtype)
    jx, jy = cam.uniform() - 0.5, cam.uniform() - 0.5
    ro, rd = sh.primary_rays(scene.cam, (pixels % scene.width).to(dtype) + jx,
                             (pixels // scene.width).to(dtype) + jy)
    li = torch.zeros((n, 3), dtype=dtype, device=dev)
    beta = torch.ones_like(li)
    pending = torch.zeros_like(li)
    prev_pdf = torch.zeros(n, dtype=dtype, device=dev)
    specular = torch.zeros(n, dtype=torch.bool, device=dev)
    alive = torch.ones_like(specular)
    for b in range(scene.max_depth + 1):
        last = b == scene.max_depth
        tmax = torch.where(alive, torch.inf, 0.0).to(dtype)
        t, prim = geo.closest(scene, ro, rd, eps, tmax)
        li = li + pending
        hit = geo.hit_record(scene, ro, rd, t, prim)
        # the emitter reached, MIS-weighted against the BSDF's pdf
        full = specular | (b == 0 and not last)
        alive = alive & hit.valid
        lidx = torch.clamp_min(hit.light, 0)
        le = sh.light_le(scene, hit.light, hit.nor, -rd)
        seg = hit.pos - ro
        l_pdf = (1.0 / torch.clamp_min(sh.light_area(scene, lidx), 1e-30)) \
            * geo.dot(seg, seg) \
            / torch.clamp_min(torch.abs(geo.dot(hit.nor, rd)), 1e-30)
        w = torch.where(full, 1.0, sh.power_heuristic(
            prev_pdf, l_pdf * sh.choice_pdf(scene, lidx).to(dtype)))
        emitter = alive & (hit.light >= 0) & ~geo.is_black(le)
        li = li + torch.where(emitter[:, None], beta * le * w[:, None], 0.0)
        alive = alive & ~((hit.light >= 0) & full)
        if last:
            break
        rng = Stream(seed, its, pixels, CAMERA_SITES + b * BOUNCE_SITES,
                     dtype)
        m = sh.materials(scene, hit.mat)
        wi = -rd
        # a light sample; its credit waits for the shadow ray
        idx, choice = sh.pick_light(scene, rng.uniform())
        u1, u2 = rng.uniform(), rng.uniform()
        rad, sd, st, light_pdf = sh.sample_light(scene, idx, hit.pos, u1, u2,
                                                 eps)
        cand = alive & ~geo.is_black(rad) & (light_pdf > 0.0)
        fr, bsdf_pdf = sh.eval_bsdf(m, wi, sd, hit.nor, hit.dpdu)
        den = light_pdf * choice.to(dtype)
        contrib = sh.power_heuristic(den, bsdf_pdf)[:, None] * fr * rad \
            * torch.abs(geo.dot(hit.nor, sd))[:, None] \
            / torch.clamp_min(den, 1e-30)[:, None]
        blocked = geo.occluded(scene, hit.pos, sd, eps,
                               torch.where(cand, st, 0.0))
        pending = torch.where((cand & ~blocked)[:, None], beta * contrib, 0.0)
        # the BSDF sample continues the path
        u1, u2 = rng.uniform(), rng.uniform()
        rng.uniform()
        wo, fr, pdf = sh.sample_bsdf(m, wi, hit.nor, hit.dpdu, u1, u2)
        alive = alive & ~(geo.is_black(fr) | (pdf <= 0.0))
        nxt = beta * fr * torch.abs(geo.dot(hit.nor, wo))[:, None] \
            / torch.clamp_min(pdf, 1e-30)[:, None]
        beta = torch.where(alive[:, None], nxt, beta)
        specular = torch.where(alive, False, specular)
        prev_pdf = torch.where(alive, pdf, prev_pdf)
        ro = torch.where(alive[:, None], hit.pos, ro)
        rd = torch.where(alive[:, None], wo, rd)
        u_rr = rng.uniform()
        if b > 3:
            q = torch.clamp(1.0 - sh.luminance(beta), 0.0, 1.0)
            alive = alive & ~(u_rr < q)
            beta = torch.where(alive[:, None],
                               beta * (1.0 / torch.clamp_min(1.0 - q, 1e-30)
                                       )[:, None], beta)
    return torch.where(torch.isfinite(li).all(-1)[:, None], li, 0.0)
