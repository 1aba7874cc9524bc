"""Wrapper of the BVH8 walk kernel (csrc/bvh8_walk.cu).

`bvh8_walk_cuda` checks its tensors, allocates the outputs, launches the
kernel on the current stream, counts the launch in `STATS`, and raises
when a ray's stack overflowed (which reads a flag back from the device:
a ray is never dropped without a word). It takes CUDA tensors only; the
plain PyTorch version is geom/packet.py::walk_torch, which counts its
calls on CUDA tensors in `STATS.plain_cuda`.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_pathtracer_tpu_torch.kernels import (
    KernelStats, check_cuda_f32, check_launch, load_library,
)

MAX_STACK = 256   # the kernel's per-thread stack (kMaxStack)
MAX_INST = 64     # instances the kernel takes (kMaxInst)
STATS = KernelStats()

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load_library("bvh8_walk")
    if lib.bvh8_walk.argtypes is None:
        lib.bvh8_walk.restype = ctypes.c_int
        lib.bvh8_walk.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _P]
    return lib


def bvh8_walk_cuda(table, aux, n_inst: int, ro, rd, tmin, tmax,
                   any_hit: bool, stack_depth: int):
    """Closest hit -> (t [N] f32, prim [N] i32, -1 = miss; t = tmax on a
    miss), or with `any_hit` -> found [N] bool. `n_inst` 0 walks the flat
    table from row 0; otherwise `aux [n_inst, 20]` lists the instances."""
    device = ro.device
    n = ro.shape[0]
    check_cuda_f32("bvh8_table", table, (None, 128), device)
    check_cuda_f32("bvh8_aux", aux, (None, 20), device)
    if not 0 <= n_inst <= min(MAX_INST, aux.shape[0]):
        raise ValueError(f"{n_inst} instances: the kernel takes 0.."
                         f"{MAX_INST} and aux has {aux.shape[0]} rows")
    if not 0 < stack_depth <= MAX_STACK:
        raise ValueError(f"stack depth {stack_depth}: the kernel takes "
                         f"1..{MAX_STACK}")
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
    overflow = torch.zeros(1, dtype=torch.int32, device=device)
    rc = _lib().bvh8_walk(
        table.data_ptr(), aux.data_ptr(), n_inst, ro.data_ptr(),
        rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        t.data_ptr() if t is not None else None,
        prim.data_ptr() if prim is not None else None,
        found.data_ptr() if found is not None else None,
        overflow.data_ptr(), n, stack_depth, int(any_hit),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(rc, "bvh8_walk")
    STATS.launches += 1
    if overflow.item():
        raise RuntimeError(f"bvh8_walk: a ray's stack passed {stack_depth} "
                           f"entries; its hit was not found")
    return found if any_hit else (t, prim)
