"""Batched 3-vector math on torch tensors of shape [..., 3].

The port of gpu_pathtracer_tpu/core/vecmath.py. Dot and cross products
are written out component by component, left to right, so that the
plain PyTorch path and the CUDA kernels (csrc/*.cu, built without FMA
contraction) round identically.
"""

from __future__ import annotations

import torch

# Rec.709 luminance weights (reference: pathtracer.cu:206-208)
LUMA = (0.212671, 0.715160, 0.072169)

PI = 3.14159265358979323846
TWO_PI = 2.0 * PI
FOUR_PI = 4.0 * PI
INV_PI = 1.0 / PI
INV_TWO_PI = 1.0 / TWO_PI
INV_FOUR_PI = 1.0 / FOUR_PI


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def dot3(a, b):
    """Dot product keeping the trailing dim for broadcasting: [..., 1]."""
    return dot(a, b)[..., None]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def length(v):
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def normalize(v):
    return v / torch.sqrt(torch.clamp_min(dot3(v, v), 1e-30))


def luminance(c):
    """Rec.709 luminance of an RGB color batch [..., 3] -> [...]."""
    return c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]


def reflect(wi, n):
    """Mirror reflection of `wi` about `n`; both point away from the
    surface (pathtracer.cu:140-142): 2*dot(in, nor)*nor - in."""
    return 2.0 * dot3(wi, n) * n - wi


def refract(wi, n, etai, etat):
    """Refract `wi` (pointing away from the surface) through `n`
    (pathtracer.cu:144-158); etai/etat are [...] tensors. The caller has
    already rejected total internal reflection."""
    cosi = dot3(wi, n)
    enter = cosi > 0.0
    etai = etai[..., None]
    etat = etat[..., None]
    ei = torch.where(enter, etai, etat)
    et = torch.where(enter, etat, etai)
    eta = ei / et
    sini2 = 1.0 - cosi * cosi
    sint2 = sini2 * eta * eta
    cost = torch.sqrt(torch.clamp_min(1.0 - sint2, 0.0))
    sign = torch.where(enter, -1.0, 1.0)
    return normalize((n * cosi - wi) * eta + sign * cost * n)


def make_coordinate(n):
    """Orthonormal frame (u, w) around unit normal n (wrap.h:6-16)."""
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    use_x = torch.abs(nx) > torch.abs(ny)
    inv_len_x = 1.0 / torch.sqrt(nx * nx + nz * nz + 1e-30)
    wx = torch.cat([nz * inv_len_x, torch.zeros_like(inv_len_x),
                    -nx * inv_len_x], -1)
    inv_len_y = 1.0 / torch.sqrt(ny * ny + nz * nz + 1e-30)
    wy = torch.cat([torch.zeros_like(inv_len_y), nz * inv_len_y,
                    -ny * inv_len_y], -1)
    w = torch.where(use_x, wx, wy)
    return cross(w, n), w


def to_world(d, u, v, w):
    """Local->world: d.x*u + d.y*v + d.z*w (reference wrap.h:18-20)."""
    return d[..., 0:1] * u + d[..., 1:2] * v + d[..., 2:3] * w


def to_local(d, u, v, w):
    """World->local: (d.u, d.v, d.w) (reference wrap.h:22-24)."""
    return torch.stack([dot(d, u), dot(d, v), dot(d, w)], -1)


def is_black(c):
    """True where an RGB batch is black (reference common.h IsBlack)."""
    return (c[..., 0] <= 0.0) & (c[..., 1] <= 0.0) & (c[..., 2] <= 0.0)


def same_hemisphere(a, b, n):
    """dot(a,n) * dot(b,n) > 0 (reference pathtracer.cu:210-212)."""
    return dot(a, n) * dot(b, n) > 0.0


def face_forward(n, d):
    """Flip n so it faces the same hemisphere as d."""
    return torch.where(dot3(n, d) < 0.0, -n, n)
