"""Wrapper of the block-culled hit kernel (csrc/blocked.cu).

`blocked_hit_cuda` checks its tensors, allocates the outputs, launches
the kernel on the current stream and counts the launch in `STATS`. It
takes CUDA tensors only; the plain PyTorch version is geom/blocked.py::
blocked_hit_torch, which counts its calls on CUDA tensors in
`STATS.plain_cuda`. `kinds` = (has_tri, has_sph, has_lin) picks the
kernel's variant: triangles only for (True, False, False), else all
kinds.

The kernel culls in three levels: a coarse box per GROUP blocks (built
by each launch from block_bbox), the blocks' boxes, and one sub-box per
SUB rows of a block, the table `sub_boxes` makes once per scene
(DeviceScene.block_sub, port-only: the JAX package has no such table).
"""

from __future__ import annotations

import ctypes

import torch

from gpu_pathtracer_tpu_torch.kernels import (
    KernelStats, all_kinds, check_cuda_f32, check_launch, load_library,
)

BLOCK = 64   # prims per culling block (block_bbox row), as the kernel's
MAX_BLOCKS = 1024   # boxes the kernel stages (BLOCKED_MAX / BLOCK)
GROUP = 16   # blocks per coarse box
SUB = 8      # rows per sub-box of a block (divides BLOCK, 2 <= SUB)
STATS = KernelStats()

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load_library("blocked")
    if lib.blocked_hit.argtypes is None:
        lib.blocked_hit.restype = ctypes.c_int
        lib.blocked_hit.argtypes = [_P, _I, _P, _I, _I, _P, _I, _P, _P, _P,
                                    _P, _P, _P, _P, _I, _I, _I, _P]
    return lib


def sub_boxes(dense_prims: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The sub-box table [n_blocks * BLOCK // SUB, 8] (min(3) max(3)
    pad(2), block_bbox's layout): per SUB rows in row order, the box of
    what each row's test can hit (a triangle's three corners, a sphere's
    centre +- r, a segment's ends +- its larger width), widened by 1e-6
    relative so that no hit a row's test takes falls outside; NaN, which
    no slab test enters, for a run of pad rows only (and for the rows
    past the table up to n_blocks whole blocks)."""
    dev = dense_prims.device
    rows = torch.cat([dense_prims, torch.zeros(
        (n_blocks * BLOCK - dense_prims.shape[0], 16), device=dev)])
    rows[dense_prims.shape[0]:, 9] = -1.0
    ty, v0 = rows[:, 9:10], rows[:, 0:3]
    a, b = rows[:, 3:6], rows[:, 6:9]
    tri, sph, lin = ty == 0, ty == 2, ty == 1
    r_sph = rows[:, 10:11].abs()
    r_lin = rows[:, 10:12].abs().amax(1, keepdim=True)
    v1, v2 = v0 + a, v0 + b
    lo = torch.where(tri, torch.minimum(v0, torch.minimum(v1, v2)),
                     torch.where(sph, v0 - r_sph,
                                 torch.minimum(v0, a) - r_lin))
    hi = torch.where(tri, torch.maximum(v0, torch.maximum(v1, v2)),
                     torch.where(sph, v0 + r_sph,
                                 torch.maximum(v0, a) + r_lin))
    real = tri | sph | lin
    lo = torch.where(real, lo, torch.inf).view(-1, SUB, 3).amin(1)
    hi = torch.where(real, hi, -torch.inf).view(-1, SUB, 3).amax(1)
    w = 1e-6 * (1.0 + torch.maximum(lo.abs(), hi.abs()).amax(1,
                                                             keepdim=True))
    some = (lo[:, 0:1] <= hi[:, 0:1])
    out = torch.zeros((lo.shape[0], 8), dtype=torch.float32, device=dev)
    out[:, 0:3] = torch.where(some, lo - w, torch.nan)
    out[:, 3:6] = torch.where(some, hi + w, torch.nan)
    return out


def blocked_hit_cuda(dense_prims, block_bbox, block_sub, ro, rd, tmin, tmax,
                     any_hit: bool, kinds):
    """Closest hit -> (t [N] f32, prim [N] i32, -1 = miss; t = tmax on a
    miss), or with `any_hit` -> found [N] bool. `block_sub` is
    sub_boxes(dense_prims, block_bbox.shape[0])."""
    device = ro.device
    n = ro.shape[0]
    check_cuda_f32("dense_prims", dense_prims, (None, 16), device)
    check_cuda_f32("block_bbox", block_bbox, (None, 8), device)
    n_blocks = block_bbox.shape[0]
    check_cuda_f32("block_sub", block_sub, (n_blocks * BLOCK // SUB, 8),
                   device)
    if dense_prims.shape[0] > n_blocks * BLOCK:
        raise ValueError(f"{dense_prims.shape[0]} prim rows but only "
                         f"{n_blocks} blocks of {BLOCK}")
    if n_blocks > MAX_BLOCKS:
        raise ValueError(f"{n_blocks} blocks, the kernel takes at most "
                         f"{MAX_BLOCKS}")
    check_cuda_f32("ro", ro, (n, 3), device)
    check_cuda_f32("rd", rd, (n, 3), device)
    check_cuda_f32("tmin", tmin, (n,), device)
    check_cuda_f32("tmax", tmax, (n,), device)
    if any_hit:
        found = torch.empty(n, dtype=torch.bool, device=device)
        t = prim = None
    else:
        t = torch.empty(n, dtype=torch.float32, device=device)
        prim = torch.empty(n, dtype=torch.int32, device=device)
        found = None
    if n == 0:
        return found if any_hit else (t, prim)
    rc = _lib().blocked_hit(
        dense_prims.data_ptr(), dense_prims.shape[0], block_bbox.data_ptr(),
        n_blocks, GROUP, block_sub.data_ptr(), SUB, ro.data_ptr(),
        rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        t.data_ptr() if t is not None else None,
        prim.data_ptr() if prim is not None else None,
        found.data_ptr() if found is not None else None, n, int(any_hit),
        int(all_kinds(kinds)),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(rc, "blocked_hit")
    STATS.launches += 1
    return found if any_hit else (t, prim)
