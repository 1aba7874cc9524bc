"""Sampling warps: uniform-random squares -> useful distributions.

The port of the warps of gpu_pathtracer_tpu/core/sampling.py that the
path tracers use (the reference's wrap.h), and the Henyey-Greenstein
phase function of the media (medium.h:197-234), and the exponential
and Gaussian-disk warps of the dipole BSSRDF (wrap.h:125-164). Directions use the
reference's local convention where the surface normal is +Y
(components (x=sin*cos, y=cos, z=sin*sin)).
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.core.vecmath import INV_FOUR_PI, INV_PI, TWO_PI


def sincos_2pi(u):
    """(cos, sin) of phi = 2*pi*u with one transcendental: the sine is
    recovered as sign(pi - phi) * sqrt(1 - cos^2)."""
    c = torch.cos(TWO_PI * u)
    s = torch.sqrt(torch.clamp_min(1.0 - c * c, 0.0))
    return c, torch.where(u <= 0.5, s, -s)


def _dir_from_u2(costheta, sintheta, u2):
    cphi, sphi = sincos_2pi(u2)
    return torch.stack([sintheta * cphi, costheta, sintheta * sphi], -1)


def uniform_sphere(u1, u2):
    """wrap.h:26-36. Returns (dir[..., 3], pdf = 1/(4 pi))."""
    costheta = 1.0 - 2.0 * u1
    sintheta = torch.sqrt(torch.clamp_min(1.0 - costheta * costheta, 0.0))
    return (_dir_from_u2(costheta, sintheta, u2),
            torch.full_like(u1, INV_FOUR_PI))


def cosine_hemisphere(u1, u2):
    """wrap.h:51-62. Local frame, +Y up. Returns (dir, pdf=cos/pi)."""
    sintheta = torch.sqrt(torch.clamp_min(u1, 0.0))
    costheta = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    return _dir_from_u2(costheta, sintheta, u2), costheta * INV_PI


def uniform_disk(u1, u2):
    """wrap.h:78-85. Returns (xy[..., 2], pdf=1/pi)."""
    r = torch.sqrt(torch.clamp_min(u1, 0.0))
    cphi, sphi = sincos_2pi(u2)
    return torch.stack([r * cphi, r * sphi], -1), torch.full_like(u1, INV_PI)


def uniform_triangle(u1, u2):
    """wrap.h:110-115. Returns barycentric (u, v) each [...]."""
    su1 = torch.sqrt(torch.clamp_min(u1, 0.0))
    return 1.0 - su1, u2 * su1


def exponential(u, falloff):
    """wrap.h:158-160: inverse-CDF sample of falloff * exp(-falloff x)."""
    return -torch.log(torch.clamp_min(u, 1e-30)) / falloff


def exponential_pdf(x, falloff):
    """wrap.h:162-164."""
    return falloff * torch.exp(-falloff * x)


def gaussian_disk_infinity(u1, u2, falloff):
    """wrap.h:125-130: a point of the untruncated Gaussian disk [..., 2]."""
    r = torch.sqrt(torch.log(torch.clamp_min(u1, 1e-30)) / -falloff)
    ct, st = sincos_2pi(u2)
    return torch.stack([r * ct, r * st], -1)


def gaussian_disk_infinity_pdf(x, y, falloff):
    """wrap.h:132-134."""
    return INV_PI * falloff * torch.exp(-falloff * (x * x + y * y))


def gaussian_disk(u1, u2, falloff, rmax):
    """wrap.h:142-147: the Gaussian disk truncated at radius rmax."""
    t = 1.0 - u1 * (1.0 - torch.exp(-falloff * rmax * rmax))
    r = torch.sqrt(torch.log(torch.clamp_min(t, 1e-30)) / -falloff)
    ct, st = sincos_2pi(u2)
    return torch.stack([r * ct, r * st], -1)


def gaussian_disk_pdf(x, y, falloff, rmax):
    """wrap.h:149-152."""
    return gaussian_disk_infinity_pdf(x, y, falloff) / (
        1.0 - torch.exp(-falloff * rmax * rmax))


def hg_sample(u1, u2, g):
    """Henyey-Greenstein phase sample (sampling.py:148-169, medium.h:
    197-220): (dir_local[..., 3] about +Y, phase[...]) with pdf == phase;
    g is per lane, and g == 0 takes the uniform-sphere branch."""
    iso_dir, _ = uniform_sphere(u1, u2)
    small = torch.abs(g) < 1e-3
    g_safe = torch.where(small, 1.0, g)
    sqrt_term = (1.0 - g * g) / (1.0 - g + 2.0 * g * u1)
    cos_hg = (1.0 + g * g - sqrt_term * sqrt_term) / (2.0 * g_safe)
    costheta = torch.where(small, 1.0 - 2.0 * u1, cos_hg)
    sintheta = torch.sqrt(torch.clamp_min(1.0 - costheta * costheta, 0.0))
    d = _dir_from_u2(costheta, sintheta, u2)
    is_iso = g == 0.0
    return (torch.where(is_iso[..., None], iso_dir, d),
            hg_phase(costheta, g))


def hg_phase(cos_theta, g):
    """HG phase function value == pdf (sampling.py:172-177)."""
    cubic = 1.0 + g * g - 2.0 * g * cos_theta
    ph = INV_FOUR_PI * (1.0 - g * g) / torch.sqrt(
        torch.clamp_min(cubic * cubic * cubic, 1e-30))
    return torch.where(g == 0.0, INV_FOUR_PI, ph)


def power_heuristic(f_pdf, g_pdf):
    """MIS power heuristic, beta = 2, one sample per strategy
    (reference pathtracer.cu:166-169)."""
    denom = f_pdf * f_pdf + g_pdf * g_pdf
    ok = denom > 0.0
    return torch.where(ok, f_pdf * f_pdf / torch.where(ok, denom, 1.0), 0.0)
