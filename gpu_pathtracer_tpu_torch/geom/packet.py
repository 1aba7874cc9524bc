"""BVH8 walk for P > BLOCKED_MAX prims and every instanced scene (K4).

The port of the JAX package's walks of the unified BVH8 table
(gpu_pathtracer_tpu/geom/packet.py:42-238 and packet_tpu.py::
_walk_kernel): their semantics, not their packet design. Each ray walks
alone with its own stack of row entries (meta > 0 node row, < 0 leaf
row). A node row slab-tests its 8 child boxes against the ray's running
best t and pushes the children it enters far to near (sorted by entry
distance, ties by slot), so the nearest pops first. A leaf row tests its
valid records (the dense_prims layout) and takes a hit with t <= best t,
so among equal hits the last slot wins (packet_tpu.py). Any-hit stops at
the first hit.

Instanced scenes (geom/tlas.py) walk instance-major like the TPU
kernel's default policy (packet_tpu.py:748-905): slab-test the
instances' world boxes (aux cols 14:20) with the ray's tmax, visit them
in order of entry distance (ties by instance), skip those that start
beyond the best t, map the ray into the instance's BLAS frame with aux
cols 0:12 without renormalising the direction (so t stays the world t,
tlas.py:9-14; equal up to rounding), walk from the root row in col 12,
and add the slot base in col 13 to the hit's BLAS-local id. A closest hit
on a triangle then takes its t from its world record (`prims`, the
scene's dense_prims) as the flat walk computes it, so that the hit point
does not carry the BLAS frame's rounding: the instanced and the flat
table give the same t wherever they take the same prim. An instanced
walk counts, as the kernel does, the (ray, instance) pairs whose world
box the ray enters (`inst_entered`) and the BLAS walks begun
(`blas_walks`), over the rays with a non-empty interval; `walk_closest`
/ `walk_any` hand the two counts, kept on the device, to the spp's
counters of the same names (telemetry).

On a CUDA tensor `walk_closest` / `walk_any` launch the hand-written
kernel (csrc/bvh8_walk.cu through geom/packet_cuda.py, its triangles-only
variant when the scene has no sphere and no line); on a CPU tensor they
run `walk_torch`, the same walk in plain PyTorch: lanes step together,
each popping its own entry, and a leaf row's 8 records are tested at
once, the smallest t winning with the last slot among equals, which is
what an in-order loop yields. The kernel visits in the same order, takes
a hit at t <= its best t as this loop does, but tests triangles without
dividing, and is held to this version within the hit limits (PERF.md
section 2). The stack holds `static.bvh8_stack` entries
(bvh8.stack_bound); a walk that would pass it raises (the kernel's at
packet_cuda.check_overflow, one spp late, or settle_overflow).
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.geom import packet_cuda
from gpu_pathtracer_tpu_torch.geom.blocked import last_min, safe_inv, slab
from gpu_pathtracer_tpu_torch.geom.dense import f32n, kinds_of, rec_hits
from gpu_pathtracer_tpu_torch.kernels import all_kinds
from gpu_pathtracer_tpu_torch.scene.model import GeometryType

BIG = 3.0e38   # entry distance of a missed instance


def _xform(m, v, point: bool):
    """Cols 0:12 of aux rows (3x4, row-major) applied to [N, 3] points
    or directions."""
    out = []
    for r in range(3):
        x = m[:, 4 * r] * v[:, 0] + m[:, 4 * r + 1] * v[:, 1] \
            + m[:, 4 * r + 2] * v[:, 2]
        out.append(x + m[:, 4 * r + 3] if point else x)
    return torch.stack(out, -1)


def _walk(table, lanes, o, d, inv, tmin, root, base, best_t, best,
          any_hit, kinds, stack_depth):
    """Walk the lanes `lanes` (their rays o, d, inv, tmin in the table's
    frame) from node rows `root`, updating best_t / best [N] in place at
    those lanes; hit ids are record col 12 + base."""
    n = lanes.numel()
    dev = o.device
    stack = torch.empty((n, stack_depth + 1), dtype=torch.int32, device=dev)
    stack[:, 0] = root
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    rank = torch.arange(8, device=dev)
    bt = best_t[lanes]
    bp = best[lanes]
    while True:
        act = (sp > 0).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        sp_a = sp[act] - 1
        sp[act] = sp_a
        e = stack[act, sp_a]
        node = e >= 0

        a = act[node]     # node rows: push the entered children
        if a.numel():
            rows = table[e[node].long(), :64].view(-1, 8, 8)
            hit, tn = slab(rows[..., 0:3], rows[..., 3:6], o[a, None, :],
                           inv[a, None, :], bt[a, None])
            meta = rows[..., 6]
            hit = hit & (meta != 0.0)
            order = torch.sort(torch.where(hit, tn, torch.inf), dim=1,
                               stable=True).indices
            nh = hit.sum(dim=1)
            top = sp[a] + nh
            if bool((top > stack_depth).any()):
                raise RuntimeError(f"BVH8 walk: a ray's stack passed "
                                   f"{stack_depth} entries")
            # rank r (0 = nearest) lands at top - 1 - r; misses go to
            # the spare last column
            pos = torch.where(rank < nh[:, None], top[:, None] - 1 - rank,
                              stack_depth)
            stack[a[:, None], pos] = meta.gather(1, order).to(torch.int32)
            sp[a] = top

        a = act[~node]    # leaf rows: test the 8 records
        if a.numel():
            rec = table[(-e[~node]).long()].view(-1, 8, 16)
            oa, da = o[a], d[a]
            ok, t = rec_hits([rec[..., c] for c in range(12)],
                             tuple(oa[:, k:k + 1] for k in range(3)),
                             tuple(da[:, k:k + 1] for k in range(3)),
                             tmin[a, None], bt[a, None], kinds)
            got, t_new, j = last_min(ok & (rec[..., 13] > 0.0), t)
            pid = rec[..., 12].gather(1, j.clamp_min(0)[:, None])[:, 0]
            bt[a] = torch.where(got, t_new, bt[a])
            bp[a] = torch.where(got, pid.to(torch.int32) + base[a], bp[a])
            if any_hit:
                sp[a] = torch.where(bp[a] >= 0, 0, sp[a])
    best_t[lanes] = bt
    best[lanes] = bp


def walk_torch(table, aux, n_inst: int, ro, rd, tmin, tmax, any_hit: bool,
               kinds=(True, True, True),
               stack_depth: int = packet_cuda.MAX_STACK,
               with_t: bool = False, counts=None, prims=None):
    """Plain version of the kernel: closest hit -> (t [N] = tmax on a
    miss, prim [N] i32 = -1 on a miss), or with `any_hit` -> found [N]
    (with `with_t` also the t of the hit each ray stopped at, tmax on a
    miss: (found, t)). An instanced walk takes the scene's dense_prims
    (`prims`), for a closest hit's world t, and adds its inst_entered and
    blas_walks to `counts` (int64 [2]) when given."""
    if ro.is_cuda:
        packet_cuda.STATS.plain_cuda += 1
    n = ro.shape[0]
    dev = ro.device
    tmin = f32n(tmin, n, dev)
    best_t = f32n(tmax, n, dev).clone()
    best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inv = safe_inv(rd)
    if n_inst == 0:
        lanes = torch.arange(n, device=dev)
        zero = torch.zeros(n, dtype=torch.int32, device=dev)
        _walk(table, lanes, ro, rd, inv, tmin, zero, zero, best_t, best,
              any_hit, kinds, stack_depth)
        return _result(best_t, best, any_hit, with_t)

    if prims is None:
        raise ValueError("an instanced walk takes the scene's world records "
                         "(prims, dense_prims)")
    # the kernel's empty interval (intersect.cuh::empty_interval): no
    # instance is entered, no walk begun
    empty = ~(best_t >= tmin)
    if all_kinds(kinds):
        empty &= ~(best_t > 0.0)
    box = aux[:n_inst]
    hit, tn = slab(box[:, 14:17], box[:, 17:20], ro[:, None, :],
                   inv[:, None, :], best_t[:, None])
    hit &= ~empty[:, None]
    if counts is not None:
        counts[0] += hit.sum()
    dist = torch.where(hit, tn.clamp_min(0.0), BIG)
    dist, order = torch.sort(dist, dim=1, stable=True)
    for k in range(n_inst):
        go = (dist[:, k] < BIG) & (dist[:, k] <= best_t)
        if any_hit:
            go = go & (best < 0)
        lanes = go.nonzero().squeeze(1)
        if lanes.numel() == 0:
            continue
        if counts is not None:
            counts[1] += lanes.numel()
        m = box[order[lanes, k]]
        o = _xform(m, ro[lanes], True)
        d = _xform(m, rd[lanes], False)
        _walk(table, lanes, o, d, safe_inv(d), tmin[lanes],
              m[:, 12].to(torch.int32), m[:, 13].to(torch.int32), best_t,
              best, any_hit, kinds, stack_depth)
    if not any_hit:
        _world_t(prims, ro, rd, best_t, best)
    return _result(best_t, best, any_hit, with_t)


def _world_t(prims, ro, rd, best_t, best):
    """Set best_t, in place, to the world t of each lane's triangle hit:
    its dense_prims record tested with the flat walk's arithmetic (the
    kernel's tri_hit), whatever the test's verdict."""
    lanes = (best >= 0).nonzero().squeeze(1)
    rec = prims[best[lanes].long()]
    _, t = rec_hits([rec[:, c] for c in range(12)],
                    tuple(ro[lanes, k] for k in range(3)),
                    tuple(rd[lanes, k] for k in range(3)), -torch.inf,
                    torch.inf, (True, False, False))
    tri = rec[:, 9] == float(GeometryType.TRIANGLE)
    best_t[lanes] = torch.where(tri, t, best_t[lanes])


def _result(best_t, best, any_hit, with_t):
    if not any_hit:
        return best_t, best
    return (best >= 0, best_t) if with_t else best >= 0


def _counts(static, device):
    """An instanced scene's walk counts (int64 [2], zero), handed by
    reference to the spp's "inst_entered" and "blas_walks" counters
    (telemetry); None for a flat scene, which counts nothing."""
    if not static.bvh8_n_inst:
        return None
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    telemetry.count("inst_entered", counts[0])
    telemetry.count("blas_walks", counts[1])
    return counts


def _kernel(scene, static, ro, rd, tmin, tmax, any_hit):
    n = ro.shape[0]
    return packet_cuda.bvh8_walk_cuda(
        scene.bvh8_table, scene.bvh8_aux, static.bvh8_n_inst,
        ro.contiguous(), rd.contiguous(), f32n(tmin, n, ro.device),
        f32n(tmax, n, ro.device), any_hit, static.bvh8_stack,
        kinds_of(static), counts=_counts(static, ro.device),
        prims=scene.dense_prims)


def _plain(scene, static, ro, rd, tmin, tmax, any_hit):
    return walk_torch(scene.bvh8_table, scene.bvh8_aux, static.bvh8_n_inst,
                      ro, rd, tmin, tmax, any_hit, kinds_of(static),
                      static.bvh8_stack, counts=_counts(static, ro.device),
                      prims=scene.dense_prims)


def walk_closest(scene, static, ro, rd, tmin, tmax, plain: bool = False):
    """BVH8 closest hit -> (t [N], prim [N] i32, found [N]). CUDA tensors
    launch the kernel unless `plain`; CPU tensors run the plain version."""
    run = _kernel if ro.is_cuda and not plain else _plain
    t, prim = run(scene, static, ro, rd, tmin, tmax, False)
    return t, prim, prim >= 0


def walk_any(scene, static, ro, rd, tmin, tmax, plain: bool = False):
    """BVH8 any hit -> found [N] bool (kernel on CUDA tensors)."""
    run = _kernel if ro.is_cuda and not plain else _plain
    return run(scene, static, ro, rd, tmin, tmax, True)
