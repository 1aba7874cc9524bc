"""Wrapper of the block-culled hit kernel (csrc/blocked.cu).

`blocked_hit_cuda` checks its tensors, allocates the outputs, launches
the kernel on the current stream and counts the launch in `STATS`. It
takes CUDA tensors only; the plain PyTorch version is geom/blocked.py::
blocked_hit_torch, which counts its calls on CUDA tensors in
`STATS.plain_cuda`.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_pathtracer_tpu_torch.kernels import (
    KernelStats, check_cuda_f32, check_launch, load_library,
)

BLOCK = 64   # prims per culling block (block_bbox row), as the kernel's
STATS = KernelStats()

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load_library("blocked")
    if lib.blocked_hit.argtypes is None:
        lib.blocked_hit.restype = ctypes.c_int
        lib.blocked_hit.argtypes = [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                                    _P, _I, _I, _P]
    return lib


def blocked_hit_cuda(dense_prims, block_bbox, ro, rd, tmin, tmax,
                     any_hit: bool):
    """Closest hit -> (t [N] f32, prim [N] i32, -1 = miss; t = tmax on a
    miss), or with `any_hit` -> found [N] bool."""
    device = ro.device
    n = ro.shape[0]
    check_cuda_f32("dense_prims", dense_prims, (None, 16), device)
    check_cuda_f32("block_bbox", block_bbox, (None, 8), device)
    n_blocks = block_bbox.shape[0]
    if dense_prims.shape[0] > n_blocks * BLOCK:
        raise ValueError(f"{dense_prims.shape[0]} prim rows but only "
                         f"{n_blocks} blocks of {BLOCK}")
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
        n_blocks, ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(),
        tmax.data_ptr(), t.data_ptr() if t is not None else None,
        prim.data_ptr() if prim is not None else None,
        found.data_ptr() if found is not None else None, n, int(any_hit),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(rc, "blocked_hit")
    STATS.launches += 1
    return found if any_hit else (t, prim)
