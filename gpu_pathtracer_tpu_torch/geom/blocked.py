"""Block-culled intersection for DENSE_MAX < P <= BLOCKED_MAX prims (K3).

The port of gpu_pathtracer_tpu/geom/dense_tpu.py::blocked_closest /
blocked_any (the block loop of dense_tpu.py:316-375). The dense_prims
table is in BVH leaf order, so 64-prim runs are spatially local and
`block_bbox [nb, 8]` bounds them tightly. A ray slab-tests each block's
box in order, with its running best t, and tests the block's 64 prims
when it enters the box; a prim hit with t <= best t is taken, so among
equal hits the last row wins (the TPU kernel's rule).

On a CUDA tensor `blocked_closest` / `blocked_any` launch the
hand-written kernel (csrc/blocked.cu through geom/blocked_cuda.py); on a
CPU tensor they run `blocked_hit_torch`, that loop in plain PyTorch: per
block, the lanes that enter the box test its rows at once with
geom/dense.py's per-prim math, and the smallest t wins with the last row
among equals. The kernel visits a ray's entered blocks nearest first
and stops behind its hit; its tie rule (t < best, or t == best and a
larger row) gives the same row whatever the order, and it is held to
this version within the hit limits (PERF.md section 2). The TPU kernel
lets a whole ray tile enter a block when any of its rays hits the box;
per-ray culling gives the same hits, since a prim lies inside its
block's box.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.geom import blocked_cuda
from gpu_pathtracer_tpu_torch.geom.dense import (
    chunk_hits, f32n, kinds_of,
)

BLOCK = blocked_cuda.BLOCK
BLOCKED_MAX = 65536   # the JAX package's blocked regime (traverse.py:253)


def safe_inv(d):
    """1 / d with |d| kept >= 1e-20 (csrc/intersect.cuh::safe_inv)."""
    return 1.0 / torch.where(d.abs() > 1e-20, d,
                             torch.where(d >= 0.0, 1e-20, -1e-20))


def slab(lo, hi, ro, inv, tmax):
    """Slab test of boxes [lo, hi] (last dim xyz) against rays, all
    broadcast together -> (hit, tn); csrc/intersect.cuh::slab_hit."""
    t1 = (lo[..., 0] - ro[..., 0]) * inv[..., 0]
    t2 = (hi[..., 0] - ro[..., 0]) * inv[..., 0]
    tn = torch.minimum(t1, t2)
    tf = torch.maximum(t1, t2)
    for a in (1, 2):
        t1 = (lo[..., a] - ro[..., a]) * inv[..., a]
        t2 = (hi[..., a] - ro[..., a]) * inv[..., a]
        tn = torch.maximum(tn, torch.minimum(t1, t2))
        tf = torch.minimum(tf, torch.maximum(t1, t2))
    return (tf > 1e-5) & (tn <= tf) & (tn <= tmax), tn


def last_min(ok, t):
    """Over the last axis: (any ok, the smallest t among ok, the LAST
    index holding it) -- an in-order loop that takes t <= best."""
    tm = torch.where(ok, t, torch.inf)
    t_min = tm.min(dim=-1).values
    idx = torch.arange(t.shape[-1], device=t.device)
    j = torch.where(ok & (tm == t_min[..., None]), idx, -1).max(dim=-1)
    return ok.any(dim=-1), t_min, j.values


def blocked_hit_torch(prims, block_bbox, ro, rd, tmin, tmax, any_hit: bool,
                      kinds=(True, True, True)):
    """Plain version of the kernel: closest hit -> (t [N] = tmax on a
    miss, prim [N] i32 = -1 on a miss), or with `any_hit` -> found [N]."""
    if ro.is_cuda:
        blocked_cuda.STATS.plain_cuda += 1
    n = ro.shape[0]
    tmin = f32n(tmin, n, ro.device)
    best_t = f32n(tmax, n, ro.device).clone()
    best = torch.full((n,), -1, dtype=torch.int32, device=ro.device)
    inv = safe_inv(rd)
    for b in range(block_bbox.shape[0]):
        box = block_bbox[b]
        hit, _ = slab(box[0:3], box[3:6], ro, inv, best_t)
        if any_hit:
            hit = hit & (best < 0)
        lanes = hit.nonzero().squeeze(1)
        if lanes.numel() == 0:
            continue
        rows = prims[b * BLOCK:(b + 1) * BLOCK]
        o, d = ro[lanes], rd[lanes]
        ok, t = chunk_hits(rows, tuple(o[:, k:k + 1] for k in range(3)),
                           tuple(d[:, k:k + 1] for k in range(3)),
                           tmin[lanes, None], best_t[lanes, None], kinds)
        got, t_new, j = last_min(ok, t)
        best_t[lanes] = torch.where(got, t_new, best_t[lanes])
        best[lanes] = torch.where(got, (j + b * BLOCK).to(torch.int32),
                                  best[lanes])
    return best >= 0 if any_hit else (best_t, best)


def blocked_closest(scene, static, ro, rd, tmin, tmax, plain: bool = False):
    """Block-culled closest hit -> (t [N], prim [N] i32, found [N]). CUDA
    tensors launch the kernel unless `plain`; CPU tensors run the plain
    version."""
    if ro.is_cuda and not plain:
        n = ro.shape[0]
        t, prim = blocked_cuda.blocked_hit_cuda(
            scene.dense_prims, scene.block_bbox, scene.block_sub,
            ro.contiguous(), rd.contiguous(), f32n(tmin, n, ro.device),
            f32n(tmax, n, ro.device), False, kinds_of(static))
    else:
        t, prim = blocked_hit_torch(scene.dense_prims, scene.block_bbox, ro,
                                    rd, tmin, tmax, False, kinds_of(static))
    return t, prim, prim >= 0


def blocked_any(scene, static, ro, rd, tmin, tmax, plain: bool = False):
    """Block-culled any hit -> found [N] bool (kernel on CUDA tensors)."""
    if ro.is_cuda and not plain:
        n = ro.shape[0]
        return blocked_cuda.blocked_hit_cuda(
            scene.dense_prims, scene.block_bbox, scene.block_sub,
            ro.contiguous(), rd.contiguous(), f32n(tmin, n, ro.device),
            f32n(tmax, n, ro.device), True, kinds_of(static))
    return blocked_hit_torch(scene.dense_prims, scene.block_bbox, ro, rd,
                             tmin, tmax, True, kinds_of(static))
