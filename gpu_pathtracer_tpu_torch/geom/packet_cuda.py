"""Wrapper of the BVH8 walk kernel (csrc/bvh8_walk.cu).

`bvh8_walk_cuda` checks its tensors, allocates the outputs, launches the
kernel on the current stream and counts the launch in `STATS`. It takes
CUDA tensors only; the plain PyTorch version is geom/packet.py::
walk_torch, which counts its calls on CUDA tensors in `STATS.plain_cuda`.
`kinds` = (has_tri, has_sph, has_lin) picks the kernel's variant:
triangles only for (True, False, False), else all kinds.

A ray whose walk would pass its stack sets an overflow flag that stays
on the device, one per device, accumulated across launches so that a
launch never waits on the device. `check_overflow` reads it (one host
sync) and raises if any launch since the last check overflowed: the
renderer calls it once per spp, so a ray is never dropped without a word.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.kernels import (
    KernelStats, all_kinds, check_cuda_f32, check_launch, load_library,
)

MAX_STACK = 256   # stack entries the kernel takes (walk_torch's default)
MAX_GROUPS = 16   # node groups its stack holds (kMaxGroups)
MAX_INST = 64     # instances the kernel takes (kMaxInst)
STATS = KernelStats()
# device -> [overflow flag (int32 [1] on the device), the largest stack
# depth launched since the flag was last read]
_OVERFLOW: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load_library("bvh8_walk")
    if lib.bvh8_walk.argtypes is None:
        lib.bvh8_walk.restype = ctypes.c_int
        lib.bvh8_walk.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _P]
    return lib


def overflow_flag(device, stack_depth: int) -> torch.Tensor:
    """The device's overflow flag (made zero at first use), noting a
    launch with `stack_depth` entries for check_overflow's message."""
    device = torch.device(device)
    entry = _OVERFLOW.get(device)
    if entry is None:
        entry = _OVERFLOW[device] = [
            torch.zeros(1, dtype=torch.int32, device=device), 0]
    entry[1] = max(entry[1], stack_depth)
    return entry[0]


def check_overflow(device=None) -> None:
    """Raise if a walk launched on `device` (every device when None; a
    device without an index stands for every device of its type) since
    the last check overflowed its stack; clears the flag. Reads the flag
    only on devices that launched a walk, a read that waits on the device
    (the span "sync.overflow")."""
    want = None if device is None else torch.device(device)
    for dev, entry in list(_OVERFLOW.items()):
        if want is not None and (dev.type != want.type or (
                want.index is not None and dev.index != want.index)):
            continue
        flag, depth = entry
        with telemetry.span("sync.overflow"):
            overflowed = flag.item()
        if overflowed:
            flag.zero_()
            entry[1] = 0
            raise RuntimeError(f"bvh8_walk: a ray's stack passed {depth} "
                               f"entries; its hit was not found")
        entry[1] = 0


def group_cap(stack_depth: int) -> int:
    """Node groups the kernel's stack holds for a walk of `stack_depth`
    entries: a walk holds at most one group per level below the root, and
    bvh8.stack_bound gives 7 D + 8 entries for a tree of D levels, so
    (stack_depth - 1) // 7 = D + 1 covers it (at least 1, at most
    stack_depth: every stacked group holds a pending entry; at most
    MAX_GROUPS: a deeper tree overflows and raises)."""
    return max(1, min(stack_depth, (stack_depth - 1) // 7, MAX_GROUPS))


def bvh8_walk_cuda(table, aux, n_inst: int, ro, rd, tmin, tmax,
                   any_hit: bool, stack_depth: int,
                   kinds=(True, True, True)):
    """Closest hit -> (t [N] f32, prim [N] i32, -1 = miss; t = tmax on a
    miss), or with `any_hit` -> found [N] bool. `n_inst` 0 walks the flat
    table from row 0; otherwise `aux [n_inst, 20]` lists the instances.
    A stack overflow is reported by check_overflow, not here."""
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
    overflow = overflow_flag(device, stack_depth)
    rc = _lib().bvh8_walk(
        table.data_ptr(), aux.data_ptr(), n_inst, ro.data_ptr(),
        rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        t.data_ptr() if t is not None else None,
        prim.data_ptr() if prim is not None else None,
        found.data_ptr() if found is not None else None,
        overflow.data_ptr(), n, stack_depth, group_cap(stack_depth),
        int(any_hit), int(all_kinds(kinds)),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(rc, "bvh8_walk")
    STATS.launches += 1
    return found if any_hit else (t, prim)
