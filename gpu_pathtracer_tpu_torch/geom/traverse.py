"""Closest- and any-hit queries and the hit record.

The port of gpu_pathtracer_tpu/geom/traverse.py. `intersect_closest` /
`intersect_any` route by the scene alone, as the JAX package routes on
its TPU (traverse.py:231-307), on both devices:

- instanced scenes (static.bvh8_n_inst > 0): the BVH8 walk, instanced
  (geom/packet.py, K4);
- P <= DENSE_MAX (512): brute force (geom/dense.py, K1);
- P <= BLOCKED_MAX (65,536): block culling (geom/blocked.py, K3);
- otherwise: the BVH8 walk, flat (K4).

Each regime launches its CUDA kernel on CUDA tensors and runs its plain
PyTorch version on CPU tensors; `plain=True` forces the plain version on
any device (the reference path). `_hit_attributes` rebuilds the shading
record from (t, prim), and `brute_force_closest` is the per-prim oracle.
The JAX package's binary-BVH stack walk (`_traverse`) is a test oracle
there and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.core.vecmath import (
    INV_PI, INV_TWO_PI, TWO_PI, cross, dot, make_coordinate, normalize,
)
from gpu_pathtracer_tpu_torch.geom import blocked, dense, packet
from gpu_pathtracer_tpu_torch.scene.model import GeometryType


@dataclass
class Hit:
    """Batched intersection record (intersection.h:6-19)."""
    valid: torch.Tensor      # [N] bool
    t: torch.Tensor          # [N]
    pos: torch.Tensor        # [N, 3]
    nor: torch.Tensor        # [N, 3] shading normal
    uv: torch.Tensor         # [N, 2]
    dpdu: torch.Tensor       # [N, 3] shading tangent
    mat_idx: torch.Tensor    # [N] i32 (-1 on a miss)
    light_idx: torch.Tensor  # [N] i32
    prim_idx: torch.Tensor   # [N] i32
    bssrdf_idx: torch.Tensor  # [N] i32 (-1 on a miss or no BSSRDF)
    medium_inside: torch.Tensor   # [N] i32 (-1 on a miss or no medium)
    medium_outside: torch.Tensor  # [N] i32


def _tri_intersect(ro, rd, va, e1, e2, tmin, tmax):
    """Moller-Trumbore (mesh.h:45-67). Returns (hit, t)."""
    s1 = cross(rd, e2)
    divisor = dot(s1, e1)
    ok = torch.abs(divisor) >= 1e-8
    inv_div = 1.0 / torch.where(ok, divisor, 1.0)
    s = ro - va
    b1 = dot(s, s1) * inv_div
    ok = ok & (b1 >= 0.0) & (b1 <= 1.0)
    s2 = cross(s, e1)
    b2 = dot(rd, s2) * inv_div
    ok = ok & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    t = dot(e2, s2) * inv_div
    return ok & (t >= tmin) & (t <= tmax), t


def _sphere_intersect(ro, rd, center, radius, tmin, tmax):
    """sphere.h:26-69: near root if beyond tmin, else far root."""
    op = ro - center
    b = dot(op, rd)
    c = dot(op, op) - radius * radius
    delta = b * b - c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    use_t1 = t1 > tmin
    t = torch.where(use_t1, t1, t2)
    ok = (delta >= 0.0) & (t > 0.0) & (t <= tmax)
    return ok & (use_t1 | (t1 > 0.0) | (t2 > tmin)), t


def _line_intersect(ro, rd, p0, p1, w0, w1, tmin, tmax):
    """Ray vs width-lerped segment (line.h:33-73). Returns (hit, t, s)."""
    split = lambda x: tuple(x[..., k] for k in range(3))  # noqa: E731
    t, s, ok = dense.line_param(split(ro), split(rd), split(p0), split(p1),
                                tmin, tmax)
    prl = (ro + rd * t[..., None]) - (p0 + (p1 - p0) * s[..., None])
    r = w0 * (1.0 - s) + w1 * s
    return ok & (dot(prl, prl) <= r * r), t, s


def regime(static) -> str:
    """The intersection regime of a scene: "instanced", "dense",
    "blocked" or "bvh8"."""
    if static.bvh8_n_inst:
        return "instanced"
    if static.n_primitives <= dense.DENSE_MAX:
        return "dense"
    if static.n_primitives <= blocked.BLOCKED_MAX:
        return "blocked"
    return "bvh8"


def _queries(static):
    """(closest, any) hit functions of the scene's regime."""
    r = regime(static)
    if r == "dense":
        return dense.dense_closest, dense.dense_any
    if r == "blocked":
        return blocked.blocked_closest, blocked.blocked_any
    return packet.walk_closest, packet.walk_any


def closest_prim(scene, static, ro, rd, tmin, tmax, plain: bool = False):
    """Closest-hit query (pathtracer.cu:214-255) without the hit record:
    (t [N], prim [N] i32, -1 on a miss, found [N]). `plain` forces the
    plain PyTorch intersection on any device (the reference path). Counts
    its lanes in the spp's "hit_lanes" counter (telemetry)."""
    telemetry.count("hit_lanes", ro.shape[0])
    return _queries(static)[0](scene, static, ro, rd, tmin, tmax, plain)


def intersect_closest(scene, static, ro, rd, tmin, tmax,
                      plain: bool = False) -> Hit:
    """Closest-hit query with its hit record (`closest_prim`, then
    `_hit_attributes`)."""
    t, prim, found = closest_prim(scene, static, ro, rd, tmin, tmax, plain)
    return _hit_attributes(scene, static, ro, rd, t, prim, found)


def intersect_any(scene, static, ro, rd, tmin, tmax, plain: bool = False):
    """Any-hit (shadow) query (pathtracer.cu:257-296) -> bool [N]. Counts
    its lanes in the spp's "hit_lanes" counter (telemetry)."""
    telemetry.count("hit_lanes", ro.shape[0])
    return _queries(static)[1](scene, static, ro, rd, tmin, tmax, plain)


def _hit_attributes(scene, static, ro, rd, t, prim, found) -> Hit:
    """Rebuild the full intersection record from (t, prim): one row of
    prim_attrs [P, 40] per lane."""
    p = torch.where(found, prim, 0).long()
    attrs = scene.prim_attrs[p]
    ptype = attrs[:, 29].to(torch.int32)
    v0 = attrs[:, 0:3]
    v1 = attrs[:, 3:6]
    v2 = attrs[:, 6:9]
    pos = ro + rd * t[:, None]

    nor = torch.zeros_like(pos)
    uv = torch.zeros_like(pos[:, :2])
    dpdu = torch.zeros_like(pos)

    if static.has_triangles:
        # barycentrics recomputed at the stored t (mesh.h:45-95)
        e1 = v1 - v0
        e2 = v2 - v0
        s1 = cross(rd, e2)
        divisor = dot(s1, e1)
        inv_div = 1.0 / torch.where(torch.abs(divisor) > 1e-30, divisor, 1.0)
        s = ro - v0
        b1 = dot(s, s1) * inv_div
        s2 = cross(s, e1)
        b2 = dot(rd, s2) * inv_div
        w0 = (1.0 - b1 - b2)[:, None]
        b1c = b1[:, None]
        b2c = b2[:, None]
        tri_nor = normalize(attrs[:, 9:12] * w0 + attrs[:, 12:15] * b1c
                            + attrs[:, 15:18] * b2c)
        tri_uv = attrs[:, 18:20] * w0 + attrs[:, 20:22] * b1c \
            + attrs[:, 22:24] * b2c
        tri_dpdu = normalize(cross(tri_nor, attrs[:, 24:27]))
        is_tri = (ptype == int(GeometryType.TRIANGLE))[:, None]
        nor = torch.where(is_tri, tri_nor, nor)
        uv = torch.where(is_tri, tri_uv, uv)
        dpdu = torch.where(is_tri, tri_dpdu, dpdu)

    if static.has_spheres:
        # sphere.h:72-91
        s_nor = normalize(pos - v0)
        vv = torch.acos(torch.clamp(s_nor[:, 1], -1.0, 1.0)) * INV_PI
        phi = torch.acos(torch.clamp(s_nor[:, 0], -1.0, 1.0))
        phi = torch.where(s_nor[:, 2] > 0.0, TWO_PI - phi, phi)
        s_uv = torch.stack([phi * INV_TWO_PI, vv], -1)
        s_dpdu = normalize(torch.stack(
            [-TWO_PI * pos[:, 1], TWO_PI * pos[:, 0],
             torch.zeros_like(vv)], -1))
        is_sph = (ptype == int(GeometryType.SPHERE))[:, None]
        nor = torch.where(is_sph, s_nor, nor)
        uv = torch.where(is_sph, s_uv, uv)
        dpdu = torch.where(is_sph, s_dpdu, dpdu)

    if static.has_lines:
        # line.h:74-84: camera-facing normal, uv = (s, dist / r)
        r0 = attrs[:, 27]
        r1 = attrs[:, 28]
        _, _, s_param = _line_intersect(ro, rd, v0, v1, r0, r1, 0.0,
                                        torch.inf)
        l_nor = -rd
        prl = pos - (v0 + (v1 - v0) * s_param[:, None])
        r = r0 * (1.0 - s_param) + r1 * s_param
        l_uv = torch.stack(
            [s_param, torch.sqrt(torch.clamp_min(dot(prl, prl), 0.0))
             / torch.clamp_min(r, 1e-30)], -1)
        l_dpdu, _ = make_coordinate(l_nor)
        is_line = (ptype == int(GeometryType.LINE))[:, None]
        nor = torch.where(is_line, l_nor, nor)
        uv = torch.where(is_line, l_uv, uv)
        dpdu = torch.where(is_line, l_dpdu, dpdu)

    neg1 = torch.full_like(ptype, -1)
    return Hit(
        valid=found, t=t, pos=pos, nor=nor, uv=uv, dpdu=dpdu,
        mat_idx=torch.where(found, attrs[:, 30].to(torch.int32), neg1),
        light_idx=torch.where(found, attrs[:, 31].to(torch.int32), neg1),
        prim_idx=torch.where(found, p.to(torch.int32), neg1),
        bssrdf_idx=torch.where(found, attrs[:, 32].to(torch.int32), neg1),
        medium_inside=torch.where(found, attrs[:, 33].to(torch.int32), neg1),
        medium_outside=torch.where(found, attrs[:, 34].to(torch.int32),
                                   neg1))


def brute_force_closest(scene, static, ro, rd, tmin, tmax) -> Hit:
    """O(N*P) oracle for tests: one intersection routine per prim."""
    n = ro.shape[0]
    best_t = torch.as_tensor(tmax, dtype=torch.float32,
                             device=ro.device).expand(n).clone()
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=ro.device)
    for pidx in range(scene.prim_type.shape[0]):
        ptype = int(scene.prim_type[pidx])
        v0 = scene.v0[pidx].expand_as(ro)
        v1 = scene.v1[pidx].expand_as(ro)
        if ptype == int(GeometryType.TRIANGLE):
            h, t = _tri_intersect(ro, rd, v0, v1 - v0,
                                  scene.v2[pidx].expand_as(ro) - v0,
                                  tmin, best_t)
        elif ptype == int(GeometryType.SPHERE):
            h, t = _sphere_intersect(ro, rd, v0, scene.radius0[pidx], tmin,
                                     best_t)
        else:
            h, t, _ = _line_intersect(ro, rd, v0, v1, scene.radius0[pidx],
                                      scene.radius1[pidx], tmin, best_t)
        best_prim = torch.where(h, pidx, best_prim)
        best_t = torch.where(h, t, best_t)
    return _hit_attributes(scene, static, ro, rd, best_t, best_prim,
                           best_prim >= 0)
