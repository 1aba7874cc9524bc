"""Sampling warps: uniform-random squares -> useful distributions.

The port of the warps of gpu_pathtracer_tpu/core/sampling.py that the
path tracer uses (the reference's wrap.h). Directions use the
reference's local convention where the surface normal is +Y
(components (x=sin*cos, y=cos, z=sin*sin)).
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.core.vecmath import INV_PI, TWO_PI


def sincos_2pi(u):
    """(cos, sin) of phi = 2*pi*u with one transcendental: the sine is
    recovered as sign(pi - phi) * sqrt(1 - cos^2)."""
    c = torch.cos(TWO_PI * u)
    s = torch.sqrt(torch.clamp_min(1.0 - c * c, 0.0))
    return c, torch.where(u <= 0.5, s, -s)


def _dir_from_u2(costheta, sintheta, u2):
    cphi, sphi = sincos_2pi(u2)
    return torch.stack([sintheta * cphi, costheta, sintheta * sphi], -1)


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


def power_heuristic(f_pdf, g_pdf):
    """MIS power heuristic, beta = 2, one sample per strategy
    (reference pathtracer.cu:166-169)."""
    denom = f_pdf * f_pdf + g_pdf * g_pdf
    ok = denom > 0.0
    return torch.where(ok, f_pdf * f_pdf / torch.where(ok, denom, 1.0), 0.0)
