"""Dipole-diffusion BSSRDF (subsurface scattering).

The port of gpu_pathtracer_tpu/shade/bssrdf.py: the reference's Bssrdf
(bssrdf.h:18-141) and its single and multiple scattering hooks
(pathtracer.cu:362-487), which the reference ships dormant and the
path tracer here calls for every hit on a prim with a BSSRDF
(integrators/pt.py). Host side: `fdr` and `convert_from_diffuse`
(a diffuse colour and mean path length -> sigma_a, sigma_s'). Device
side: `dipole_A`, `rd`, `sample_probe_ray`, `single_scatter`,
`multiple_scatter`, batched over lanes.

Draws (from the stream `rng` the caller hands in): `single_scatter`
takes the distance along the refracted ray, then the light pick and
the light's (u, v); `multiple_scatter` the probe disk's (u1, u2), then
the light pick and (u, v).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpu_pathtracer_tpu_torch.core import sampling
from gpu_pathtracer_tpu_torch.core.sampling import (
    exponential, exponential_pdf,
)
from gpu_pathtracer_tpu_torch.core.vecmath import (
    INV_PI, dot, is_black, length, luminance, make_coordinate, reflect,
    refract, to_world,
)
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod
from gpu_pathtracer_tpu_torch.shade.bsdf import dielectric_fresnel


def fdr(eta: float) -> float:
    """Internal diffuse Fresnel reflectivity, polynomial approximation
    (bssrdf.h:32-41, Donner 2006 ch. 5)."""
    if eta < 1.0:
        return (-0.4399 + 0.7099 / eta - 0.3199 / (eta * eta)
                + 0.0636 / (eta ** 3))
    return -1.4399 / (eta * eta) + 0.7099 / eta + 0.6911 + 0.0636 * eta


def _rd_integral(alphap: float, A: float) -> float:
    """bssrdf.h:104-107."""
    sqrt_term = np.sqrt(3.0 * (1.0 - alphap))
    return (alphap / 2.0 * (1.0 + np.exp(-4.0 / 3.0 * A * sqrt_term))
            * np.exp(-sqrt_term))


def convert_from_diffuse(kd: np.ndarray, mean_path_length: float,
                         eta: float, g: float = 0.0):
    """kd + mean path length -> dipole (sigmaA, sigmaS') by 16 bisection
    steps on the Rd integral (bssrdf.h:110-140). Returns a model.Bssrdf."""
    from gpu_pathtracer_tpu_torch.scene.model import Bssrdf
    f = fdr(eta)
    A = (1.0 + f) / (1.0 - f)
    sigma_sp = np.zeros(3, np.float32)
    sigma_a = np.zeros(3, np.float32)
    for i in range(3):
        alpha_low, alpha_high = 0.0, 1.0
        for _ in range(16):
            alpha_mid = 0.5 * (alpha_low + alpha_high)
            if _rd_integral(alpha_mid, A) < kd[i]:
                alpha_low = alpha_mid
            else:
                alpha_high = alpha_mid
        alphap = 0.5 * (alpha_low + alpha_high)
        sigma_tr = 1.0 / mean_path_length
        sigma_prime_t = sigma_tr / np.sqrt(3.0 * (1.0 - alphap))
        sigma_sp[i] = alphap * sigma_prime_t
        sigma_a[i] = sigma_prime_t - sigma_sp[i]
    return Bssrdf(sigmaA=sigma_a, sigmaSP=sigma_sp, eta=eta, g=g)


def dipole_A(eta):
    """(1 + Fdr) / (1 - Fdr), batched over eta."""
    f_lt = (-0.4399 + 0.7099 / eta - 0.3199 / (eta * eta)
            + 0.0636 / (eta ** 3))
    f_ge = -1.4399 / (eta * eta) + 0.7099 / eta + 0.6911 + 0.0636 * eta
    f = torch.where(eta < 1.0, f_lt, f_ge)
    return (1.0 + f) / (1.0 - f)


def rd(d2, sigma_a, sigma_sp, A):
    """Dipole diffuse reflectance Rd(d^2) (bssrdf.h:44-68). d2 [...],
    sigma_a / sigma_sp [..., 3], A [..., 1] or a scalar."""
    sigma_tp = sigma_a + sigma_sp
    sigma_tr = torch.sqrt(3.0 * sigma_a * sigma_tp)
    zr = 1.0 / sigma_tp
    zv = zr + 4.0 / 3.0 * A * zr
    d2e = d2[..., None]
    dr = torch.sqrt(zr * zr + d2e)
    dv = torch.sqrt(zv * zv + d2e)
    alphap = sigma_sp / sigma_tp
    s_dr = sigma_tr * dr
    s_dv = sigma_tr * dv
    out = 0.25 * INV_PI * alphap * (
        zr * (1.0 + s_dr) * torch.exp(-s_dr) / (dr ** 3)
        + zv * (1.0 + s_dv) * torch.exp(-s_dv) / (dv ** 3))
    return torch.clamp_min(out, 0.0)


def sample_probe_ray(pos, nor, u1, u2, sigma_tr, r_max):
    """The Gaussian-disk probe ray of multiple scattering (bssrdf.h:
    70-83): a chord of the sphere of radius r_max about `pos` along the
    normal. Returns (origin, dir, tmax, pdf)."""
    xy = sampling.gaussian_disk(u1, u2, sigma_tr, r_max)
    d2 = (xy * xy).sum(-1)
    half_chord = torch.sqrt(torch.clamp_min(r_max * r_max - d2, 0.0))
    uu, ww = make_coordinate(nor)
    p_local = torch.stack([xy[..., 0], -half_chord, xy[..., 1]], -1)
    origin = to_world(p_local, uu, nor, ww) + pos
    pdf = sampling.gaussian_disk_pdf(xy[..., 0], xy[..., 1], sigma_tr, r_max)
    return origin, nor, 2.0 * half_chord, pdf


def _gather_bssrdf(scene, idx):
    i = torch.clamp_min(idx, 0).long()
    return (scene.b_sigma_a[i], scene.b_sigma_sp[i], scene.b_eta[i],
            scene.b_g[i])


def _sample_one_area_light(scene, static, rng, pos):
    """Light pick + solid-angle sample, clamped to the area lights (the
    reference indexes kernel_lights directly, pathtracer.cu:394-400).
    Returns (radiance, dir, tmax, light_nor, pdf x pick pdf)."""
    idx, choice = lights_mod.pick_light(scene, rng.uniform())
    idx = torch.clamp_max(idx, max(static.n_lights - 1, 0))
    u1, u2 = rng.uniform2()
    rad, _, sd, st, lnor, lpdf = lights_mod.sample_area_light(
        scene, idx, pos, u1, u2, scene.epsilon)
    return rad, sd, st, lnor, lpdf * choice


def _entry_terms(scene, bssrdf_idx, wi, nor):
    """(sigma_a, sigma_sp, eta, g, 1 - Fr at the entry, sigma_tr)."""
    sigma_a, sigma_sp, eta, g = _gather_bssrdf(scene, bssrdf_idx)
    coso = torch.abs(dot(wi, nor))
    sino2 = 1.0 - coso * coso
    cosi_t = torch.sqrt(torch.clamp_min(1.0 - sino2 / (eta * eta), 0.0))
    fresnel = 1.0 - dielectric_fresnel(coso, cosi_t, 1.0, eta)
    sigma_tr = luminance(torch.sqrt(3.0 * sigma_a * (sigma_a + sigma_sp)))
    return sigma_a, sigma_sp, eta, g, fresnel, sigma_tr


def single_scatter(scene, static, rng, pos, nor, bssrdf_idx, wi, active,
                   plain=False):
    """SingleScatter (pathtracer.cu:362-436): the specular credit of an
    emitter seen in the reflection, plus one single-scattering sample
    along the refracted ray. `wi` points away from the surface.
    Deviation kept from the JAX package: the refracted probe's tmin is
    epsilon (the reference passes the environment map's height).
    Returns (L [N, 3], rays traced: 0-d int64)."""
    n = pos.shape[0]
    eps = scene.epsilon
    L = torch.zeros((n, 3), device=pos.device)
    rays = torch.zeros((), dtype=torch.int64, device=pos.device)
    if static.n_lights == 0:
        return L, rays
    sigma_a, sigma_sp, eta, g, fresnel, sigma_tr = _entry_terms(
        scene, bssrdf_idx, wi, nor)
    sigma_s = sigma_sp / torch.clamp_min(1.0 - g, 1e-6)[:, None]
    sigma_t = sigma_s + sigma_a
    live = torch.where(active, torch.inf, 0.0)

    # reflected branch: the specular credit of a directly seen emitter
    rdir = reflect(wi, nor)
    hit_r = traverse.intersect_closest(scene, static, pos, rdir, eps, live,
                                       plain)
    le = lights_mod.area_light_le(scene, hit_r.light_idx, hit_r.nor, -rdir)
    take_r = active & hit_r.valid & (hit_r.light_idx >= 0)
    L = L + torch.where(take_r[:, None], (1.0 - fresnel)[:, None] * le, 0.0)

    # refracted branch: single scattering along the internal ray
    tdir = refract(wi, nor, torch.ones_like(eta), eta)
    hit_t = traverse.intersect_closest(scene, static, pos, tdir, eps, live,
                                       plain)
    seg_len = torch.where(hit_t.valid, length(hit_t.pos - pos), 0.0)
    d = exponential(rng.uniform(), sigma_tr)
    ok = active & (d <= seg_len)
    p_sample = pos + tdir * d[:, None]
    pdf_d = exponential_pdf(d, sigma_tr)

    rad, sd, st, _, lpdf = _sample_one_area_light(scene, static, rng,
                                                  p_sample)
    ok = ok & ~is_black(rad) & (lpdf > 0.0)
    # the first boundary toward the light must be this BSSRDF's surface
    # (pathtracer.cu:405-411)
    hit_w = traverse.intersect_closest(scene, static, p_sample, sd, eps,
                                       torch.where(ok, st, 0.0), plain)
    same = hit_w.valid & (hit_w.bssrdf_idx == bssrdf_idx)
    shadow = ok & same
    occluded = traverse.intersect_any(scene, static, p_sample, sd,
                                      hit_w.t + eps,
                                      torch.where(shadow, st, 0.0), plain)
    # the reflected and refracted probes, the walk to the boundary, the
    # shadow ray beyond it
    rays = rays + 2 * active.sum() + ok.sum() + shadow.sum()
    ok = shadow & ~occluded

    phase = 1.0 / (4.0 * math.pi)
    cosi = torch.abs(dot(hit_w.nor, sd))
    sini2 = 1.0 - cosi * cosi
    coso2 = torch.sqrt(torch.clamp_min(1.0 - sini2 / (eta * eta), 0.0))
    fresnel_i = 1.0 - dielectric_fresnel(cosi, coso2, 1.0, eta)
    G = torch.abs(dot(hit_w.nor, tdir)) / torch.clamp_min(cosi, 1e-6)
    sigma_tc = sigma_t * (1.0 + G)[:, None]
    di = length(hit_w.pos - p_sample)
    et = 1.0 / eta
    di_prime = di * torch.abs(dot(sd, hit_w.nor)) / torch.sqrt(
        torch.clamp_min(1.0 - et * et * (1.0 - cosi * cosi), 1e-6))
    contrib = (fresnel * fresnel_i * phase)[:, None] * sigma_s / sigma_tc \
        * torch.exp(-di_prime[:, None] * sigma_t) \
        * torch.exp(-d[:, None] * sigma_t) * rad \
        / torch.clamp_min(lpdf * pdf_d, 1e-30)[:, None]
    return L + torch.where(ok[:, None], contrib, 0.0), rays


def multiple_scatter(scene, static, rng, pos, nor, bssrdf_idx, wi, active,
                     plain=False):
    """MultipleScatter (pathtracer.cu:438-487): the dipole Rd through
    one Gaussian-disk probe ray, lit by one light sample at the probe's
    hit. Returns (L [N, 3], rays traced: 0-d int64)."""
    n = pos.shape[0]
    eps = scene.epsilon
    L = torch.zeros((n, 3), device=pos.device)
    rays = torch.zeros((), dtype=torch.int64, device=pos.device)
    if static.n_lights == 0:
        return L, rays
    sigma_a, sigma_sp, eta, _, fresnel, sigma_tr = _entry_terms(
        scene, bssrdf_idx, wi, nor)
    A = dipole_A(eta)
    r_max = torch.sqrt(math.log(0.01) / -torch.clamp_min(sigma_tr, 1e-30))

    u1, u2 = rng.uniform2()
    probe_o, probe_d, probe_tmax, pdf = sample_probe_ray(
        pos, nor, u1, u2, sigma_tr, r_max)
    hit_p = traverse.intersect_closest(
        scene, static, probe_o, probe_d, eps,
        torch.where(active, probe_tmax, 0.0), plain)
    same = hit_p.valid & (hit_p.bssrdf_idx == bssrdf_idx)
    d2 = dot(hit_p.pos - pos, hit_p.pos - pos)
    rd_val = rd(d2, sigma_a, sigma_sp, A[:, None])

    rad, sd, st, _, lpdf = _sample_one_area_light(scene, static, rng,
                                                  hit_p.pos)
    shadow = active & same
    occluded = traverse.intersect_any(scene, static, hit_p.pos, sd, eps,
                                      torch.where(shadow, st, 0.0), plain)
    ok = shadow & ~is_black(rad) & (lpdf > 0.0) & ~occluded
    rays = rays + active.sum() + shadow.sum()

    cosi = torch.abs(dot(sd, hit_p.nor))
    sini2 = 1.0 - cosi * cosi
    cost = torch.sqrt(torch.clamp_min(1.0 - sini2 / (eta * eta), 0.0))
    irradiance = rad * (cosi / torch.clamp_min(lpdf, 1e-30))[:, None]
    fresnel_i = 1.0 - dielectric_fresnel(cosi, cost, 1.0, eta)
    pdf_area = pdf * torch.abs(dot(probe_d, hit_p.nor))
    contrib = (INV_PI * fresnel * fresnel_i)[:, None] * rd_val \
        * irradiance / torch.clamp_min(pdf_area, 1e-30)[:, None]
    return L + torch.where(ok[:, None], contrib, 0.0), rays
