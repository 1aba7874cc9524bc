"""Vector helpers, brute-force ray queries and the hit record.

Every ray is tested against every triangle of the scene, in chunks of
rays and triangles (no acceleration structure). The triangle test is
Moller-Trumbore as mesh.h:45-67 of brickray/gpu-pathtracer writes it,
each dot and cross product summed left to right. The closest hit keeps
the first triangle in file order among equal t; a hit at tmax counts.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

ELEMS = 1 << 25    # elements of one [rays, triangles] temporary


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    return v / torch.sqrt(torch.clamp_min(dot(v, v)[..., None], 1e-30))


def length(v):
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def is_black(c):
    return (c[..., 0] <= 0.0) & (c[..., 1] <= 0.0) & (c[..., 2] <= 0.0)


def _tri_test(ro, rd, v0, e1, e2, tmin, tmax):
    """ro, rd [R, 1] components, triangles [1, T] components: (ok, t)."""
    s1 = (rd[1] * e2[2] - rd[2] * e2[1], rd[2] * e2[0] - rd[0] * e2[2],
          rd[0] * e2[1] - rd[1] * e2[0])
    div = s1[0] * e1[0] + s1[1] * e1[1] + s1[2] * e1[2]
    ok = torch.abs(div) >= 1e-8
    inv = 1.0 / torch.where(ok, div, 1.0)
    s = (ro[0] - v0[0], ro[1] - v0[1], ro[2] - v0[2])
    b1 = (s[0] * s1[0] + s[1] * s1[1] + s[2] * s1[2]) * inv
    ok = ok & (b1 >= 0.0) & (b1 <= 1.0)
    s2 = (s[1] * e1[2] - s[2] * e1[1], s[2] * e1[0] - s[0] * e1[2],
          s[0] * e1[1] - s[1] * e1[0])
    b2 = (rd[0] * s2[0] + rd[1] * s2[1] + rd[2] * s2[2]) * inv
    ok = ok & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    t = (e2[0] * s2[0] + e2[1] * s2[1] + e2[2] * s2[2]) * inv
    return ok & (t >= tmin) & (t <= tmax), t


def _chunks(scene, n_rays):
    """Triangle chunks [(lo, v0, e1, e2)] and the rays a block takes."""
    tri = scene.tri
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    tc = min(tri.shape[0], max(ELEMS // max(n_rays, 1), 256))
    rc = max(ELEMS // tc, 1)

    def cols(x, a):
        return tuple(x[a:a + tc, k][None, :] for k in range(3))
    return [(a, cols(v0, a), cols(e1, a), cols(e2, a))
            for a in range(0, tri.shape[0], tc)], rc


def closest(scene, ro, rd, tmin, tmax):
    """(t [N], prim [N] int64, -1 on a miss) of rays [N, 3] with tmin a
    float and tmax [N]."""
    n = ro.shape[0]
    best_t, best_p = tmax.clone(), torch.full((n,), -1, dtype=torch.int64,
                                              device=ro.device)
    chunks, rc = _chunks(scene, n)
    for r0 in range(0, n, rc):
        o = tuple(ro[r0:r0 + rc, k:k + 1] for k in range(3))
        d = tuple(rd[r0:r0 + rc, k:k + 1] for k in range(3))
        bt, bp = best_t[r0:r0 + rc], best_p[r0:r0 + rc]
        for lo, v0, e1, e2 in chunks:
            ok, t = _tri_test(o, d, v0, e1, e2, tmin, bt[:, None])
            tc, j = torch.min(torch.where(ok, t, torch.inf), dim=1)
            better = tc < bt
            bt = torch.where(better, tc, bt)
            bp = torch.where(better, j + lo, bp)
        best_t[r0:r0 + rc], best_p[r0:r0 + rc] = bt, bp
    return best_t, best_p


def occluded(scene, ro, rd, tmin, tmax):
    """Any hit in [tmin, tmax] of rays [N, 3] (tmax [N]; 0 for none)."""
    n = ro.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=ro.device)
    chunks, rc = _chunks(scene, n)
    for r0 in range(0, n, rc):
        o = tuple(ro[r0:r0 + rc, k:k + 1] for k in range(3))
        d = tuple(rd[r0:r0 + rc, k:k + 1] for k in range(3))
        tm = tmax[r0:r0 + rc, None]
        for _, v0, e1, e2 in chunks:
            ok, _ = _tri_test(o, d, v0, e1, e2, tmin, tm)
            out[r0:r0 + rc] |= ok.any(1)
    return out


@dataclass
class Hit:
    valid: torch.Tensor
    pos: torch.Tensor
    nor: torch.Tensor      # interpolated shading normal
    dpdu: torch.Tensor
    mat: torch.Tensor      # int64, 0 on a miss
    light: torch.Tensor    # int64, -1 on a miss or off a light


def hit_record(scene, ro, rd, t, prim) -> Hit:
    """The hit point, its interpolated normal (barycentrics taken again at
    t) and shading tangent, material and light of triangle `prim`."""
    found = prim >= 0
    p = torch.where(found, prim, 0)
    tri, nor = scene.tri[p], scene.nor[p]
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    pos = ro + rd * t[:, None]
    s1 = cross(rd, e2)
    div = dot(s1, e1)
    inv = 1.0 / torch.where(torch.abs(div) > 1e-30, div, 1.0)
    s = ro - v0
    b1 = dot(s, s1) * inv
    b2 = dot(rd, cross(s, e1)) * inv
    w0 = (1.0 - b1 - b2)[:, None]
    n = normalize(nor[:, 0] * w0 + nor[:, 1] * b1[:, None]
                  + nor[:, 2] * b2[:, None])
    dpdu = normalize(cross(n, scene.dpdv[p]))
    light = torch.where(found, scene.light[p], -1)
    return Hit(found, pos, n, dpdu, torch.where(found, scene.mat[p], 0), light)
