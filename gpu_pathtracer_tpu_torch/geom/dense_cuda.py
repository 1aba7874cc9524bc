"""Wrapper of the dense hit kernel (csrc/dense.cu).

`dense_hit_cuda` checks its tensors, allocates the outputs, launches the
kernel on the current stream and counts the launch in `STATS`. It takes
CUDA tensors only; the plain PyTorch versions are geom/dense.py::
dense_closest_torch and dense_any_torch, which count their calls on CUDA
tensors in `STATS.plain_cuda`. `kinds` = (has_tri, has_sph, has_lin)
picks the kernel's variant: triangles only for (True, False, False),
else all kinds.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_pathtracer_tpu_torch.kernels import (
    KernelStats, all_kinds, check_cuda_f32, check_launch, load_library,
)

DENSE_MAX = 512
STATS = KernelStats()

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load_library("dense")
    if lib.dense_hit.argtypes is None:
        lib.dense_hit.restype = ctypes.c_int
        lib.dense_hit.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _P]
    return lib


def dense_hit_cuda(dense_prims, ro, rd, tmin, tmax, any_hit: bool, kinds):
    """Closest hit -> (t [N] f32, prim [N] i32, -1 = miss; t = tmax on a
    miss), or with `any_hit` -> found [N] bool."""
    device = ro.device
    n = ro.shape[0]
    check_cuda_f32("dense_prims", dense_prims, (None, 16), device)
    if not 0 < dense_prims.shape[0] <= DENSE_MAX:
        raise ValueError(f"dense_prims must have 1..{DENSE_MAX} rows, got "
                         f"{dense_prims.shape[0]}")
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
    lib = _lib()
    rc = lib.dense_hit(
        dense_prims.data_ptr(), dense_prims.shape[0], ro.data_ptr(),
        rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        t.data_ptr() if t is not None else None,
        prim.data_ptr() if prim is not None else None,
        found.data_ptr() if found is not None else None, n, int(any_hit),
        int(all_kinds(kinds)),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(rc, "dense_hit")
    STATS.launches += 1
    return found if any_hit else (t, prim)
