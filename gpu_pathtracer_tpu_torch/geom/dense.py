"""Dense (brute-force) intersection for scenes of at most DENSE_MAX prims.

The port of gpu_pathtracer_tpu/geom/dense.py. Every ray is tested
against every row of the `dense_prims` table [Pp, 16] (v0 | e1 or p1 |
e2 | type | r0 r1 | ...; type -1 marks pad rows). On a CUDA tensor
`dense_closest` / `dense_any` launch the hand-written kernel
(csrc/dense.cu through geom/dense_cuda.py); on a CPU tensor they run the
plain PyTorch versions below, over chunks of prims. The kernel reorders
the triangle test's arithmetic (FMA, one division for a row that passes)
and is held to them within the hit limits (PERF.md section 2).

Closest-hit ties keep the FIRST row with the smallest t, like the JAX
package's dense_closest (argmin over a chunk, strict `<` across chunks);
a hit exactly at tmax does not count.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.geom import dense_cuda
from gpu_pathtracer_tpu_torch.scene.model import GeometryType

DENSE_MAX = dense_cuda.DENSE_MAX
CHUNK = 32   # prims per step of the plain version ([N, CHUNK] temporaries)

_TRI = float(int(GeometryType.TRIANGLE))
_LINE = float(int(GeometryType.LINE))
_SPH = float(int(GeometryType.SPHERE))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def chunk_hits(rows, ro, rd, tmin, tmax, kinds):
    """Hit test of a [C, 16] chunk of rows against [N] rays.

    Rays are tuples of [N, 1] components, rows give [1, C] ones; returns
    (ok [N, C], t [N, C])."""
    return rec_hits([rows[:, c][None, :] for c in range(12)], ro, rd, tmin,
                    tmax, kinds)


def rec_hits(col, ro, rd, tmin, tmax, kinds):
    """Hit test of dense_prims records against rays, all broadcast
    together: `col` holds the records' first 12 columns, `ro`/`rd` the
    rays' 3 components; returns (ok, t) with `t <= tmax` accepted.
    Matches csrc/intersect.cuh::prim_hit operation for operation."""
    ptype = col[9]
    v0 = (col[0], col[1], col[2])
    a = (col[3], col[4], col[5])
    has_tri, has_sph, has_lin = kinds
    ok = None
    t = None
    if has_tri:
        e2 = (col[6], col[7], col[8])
        s1 = _cross(rd, e2)
        div = _dot(s1, a)
        okt = torch.abs(div) >= 1e-8
        inv = 1.0 / torch.where(okt, div, 1.0)
        s = _sub(ro, v0)
        b1 = _dot(s, s1) * inv
        okt = okt & (b1 >= 0.0) & (b1 <= 1.0)
        s2 = _cross(s, a)
        b2 = _dot(rd, s2) * inv
        okt = okt & (b2 >= 0.0) & (b1 + b2 <= 1.0)
        tt = _dot(e2, s2) * inv
        okt = okt & (tt >= tmin) & (tt <= tmax) & (ptype == _TRI)
        ok, t = okt, tt
    if has_sph:
        r = col[10]
        op = _sub(ro, v0)
        b = _dot(op, rd)
        c = _dot(op, op) - r * r
        delta = b * b - c
        sq = torch.sqrt(torch.clamp_min(delta, 0.0))
        t1 = -b - sq
        t2 = -b + sq
        use1 = t1 > tmin
        ts = torch.where(use1, t1, t2)
        oks = (delta >= 0.0) & (ts > 0.0) & (ts <= tmax) \
            & (use1 | (t1 > 0.0) | (t2 > tmin)) & (ptype == _SPH)
        ok = oks if ok is None else ok | oks
        t = ts if t is None else torch.where(oks, ts, t)
    if has_lin:
        tl, sl, okl = line_param(ro, rd, v0, a, tmin, tmax)
        pr = (ro[0] + rd[0] * tl, ro[1] + rd[1] * tl, ro[2] + rd[2] * tl)
        v = _sub(a, v0)
        pl = (v0[0] + v[0] * sl, v0[1] + v[1] * sl, v0[2] + v[2] * sl)
        prl = _sub(pr, pl)
        d2 = _dot(prl, prl)
        rr = col[10] * (1.0 - sl) + col[11] * sl
        okl = okl & (d2 <= rr * rr) & (ptype == _LINE)
        ok = okl if ok is None else ok | okl
        t = tl if t is None else torch.where(okl, tl, t)
    return ok, t


def line_param(ro, rd, p0, p1, tmin, tmax):
    """Closest approach of a ray and the segment p0-p1 (line.h:33-73):
    (t, s clamped to [0, 1], ok = det != 0 and tmin <= t <= tmax)."""
    v = _sub(p1, p0)
    w = _sub(ro, p0)
    a = _dot(rd, rd)
    b = _dot(rd, v)
    c = _dot(v, v)
    d = _dot(rd, w)
    e = _dot(v, w)
    det = a * c - b * b
    ok = det != 0.0
    det_s = torch.where(ok, det, 1.0)
    t = (b * e - c * d) / det_s
    s = torch.clamp((a * e - b * d) / det_s, 0.0, 1.0)
    return t, s, ok & (t >= tmin) & (t <= tmax)


def _prep(ro, rd, tmin, tmax):
    n = ro.shape[0]
    tmin = torch.as_tensor(tmin, dtype=torch.float32,
                           device=ro.device).expand(n)
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=ro.device).expand(n)
    ro_c = tuple(ro[:, k:k + 1] for k in range(3))
    rd_c = tuple(rd[:, k:k + 1] for k in range(3))
    return n, ro_c, rd_c, tmin, tmax


def _count_plain(ro):
    if ro.is_cuda:
        dense_cuda.STATS.plain_cuda += 1


def dense_closest_torch(prims, ro, rd, tmin, tmax, kinds=(True, True, True)):
    """Plain closest hit over a dense_prims table. kinds = (has_tri,
    has_sph, has_lin) leaves out absent types. Returns (t [N] = tmax on a
    miss, prim [N] i32 = -1 on a miss)."""
    _count_plain(ro)
    n, ro_c, rd_c, tmin, tmax = _prep(ro, rd, tmin, tmax)
    best_t = tmax.clone()
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=ro.device)
    tmin_c = tmin[:, None]
    for c0 in range(0, prims.shape[0], CHUNK):
        rows = prims[c0:c0 + CHUNK]
        ok, t = chunk_hits(rows, ro_c, rd_c, tmin_c, best_t[:, None], kinds)
        t_chunk, j = torch.min(torch.where(ok, t, torch.inf), dim=1)
        better = t_chunk < best_t
        best_t = torch.where(better, t_chunk, best_t)
        best_prim = torch.where(better, (j + c0).to(torch.int32), best_prim)
    return best_t, best_prim


def dense_any_torch(prims, ro, rd, tmin, tmax, kinds=(True, True, True)):
    """Plain any hit (shadow query). Returns found [N] bool."""
    _count_plain(ro)
    n, ro_c, rd_c, tmin, tmax = _prep(ro, rd, tmin, tmax)
    found = torch.zeros(n, dtype=torch.bool, device=ro.device)
    tmin_c = tmin[:, None]
    tmax_c = tmax[:, None]
    for c0 in range(0, prims.shape[0], CHUNK):
        ok, _ = chunk_hits(prims[c0:c0 + CHUNK], ro_c, rd_c, tmin_c, tmax_c,
                           kinds)
        found = found | torch.any(ok, dim=1)
    return found


def kinds_of(static):
    return (static.has_triangles, static.has_spheres, static.has_lines)


def f32n(x, n, device):
    """`x` (a tensor or a Python number) as a float32 [n] on `device`. A
    number goes to a CUDA device by a copy from pageable host memory,
    which waits on the device: the span "sync.tmin" marks it."""
    if isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
    else:
        with telemetry.sync("sync.tmin", torch.device(device)):
            x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.expand(n).contiguous()


def dense_closest(scene, static, ro, rd, tmin, tmax, plain: bool = False):
    """Brute-force closest hit -> (best_t [N], best_prim [N] i32,
    found [N]). CUDA tensors launch the kernel unless `plain`; CPU
    tensors run the plain version."""
    if ro.is_cuda and not plain:
        n = ro.shape[0]
        t, prim = dense_cuda.dense_hit_cuda(
            scene.dense_prims, ro.contiguous(), rd.contiguous(),
            f32n(tmin, n, ro.device), f32n(tmax, n, ro.device), False,
            kinds_of(static))
    else:
        t, prim = dense_closest_torch(scene.dense_prims, ro, rd, tmin, tmax,
                                      kinds_of(static))
    return t, prim, prim >= 0


def dense_any(scene, static, ro, rd, tmin, tmax, plain: bool = False):
    """Brute-force any hit -> found [N] bool (kernel on CUDA tensors)."""
    if ro.is_cuda and not plain:
        n = ro.shape[0]
        return dense_cuda.dense_hit_cuda(
            scene.dense_prims, ro.contiguous(), rd.contiguous(),
            f32n(tmin, n, ro.device), f32n(tmax, n, ro.device), True,
            kinds_of(static))
    return dense_any_torch(scene.dense_prims, ro, rd, tmin, tmax,
                           kinds_of(static))
