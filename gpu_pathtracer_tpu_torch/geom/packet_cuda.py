"""Wrapper of the BVH8 walk kernel (csrc/bvh8_walk.cu).

`bvh8_walk_cuda` checks its tensors, allocates the outputs, launches the
kernel on the current stream and counts the launch in `STATS`. It takes
CUDA tensors only; the plain PyTorch version is geom/packet.py::
walk_torch, which counts its calls on CUDA tensors in `STATS.plain_cuda`.
`kinds` = (has_tri, has_sph, has_lin) picks the kernel's variant:
triangles only for (True, False, False), else all kinds. An instanced
walk takes the scene's world records (`prims`, dense_prims), from which
a closest hit on a triangle gets its world t, and adds its (ray,
instance) pairs entered and its BLAS walks begun to `counts` (int64 [2]
on the device); a flat walk reads neither.

A ray whose walk would pass its stack sets an overflow flag that stays
on the device, one per device, accumulated across launches so that a
launch never waits on the device. The renderer calls `check_overflow`
once per spp, so a ray is never dropped without a word. On a CUDA device
the check does not wait on the spp it ends: it queues a copy of the flag
into pinned host memory (a snapshot), clears the flag behind the copy,
and raises on the previous check's snapshot, so the host waits for the
spp before, while this spp's work stays queued. `settle_overflow` takes
a snapshot and waits for it at once: the renderer's film reads and
chip_smoke.py call it, so no overflow goes unreported past them. On the
CPU both read the flag at once.
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
_OVERFLOW: dict = {}   # device -> its _Overflow

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load_library("bvh8_walk")
    if lib.bvh8_walk.argtypes is None:
        lib.bvh8_walk.restype = ctypes.c_int
        lib.bvh8_walk.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _I, _I, _I, _I, _I, _P]
    return lib


class _Overflow:
    """A device's overflow flag (int32 [1], zero at first use) and the
    largest stack depth launched since its last snapshot; where reads
    are deferred, two host buffers (pinned on CUDA) with an event each,
    taken in turn, and the snapshot not yet read: (buffer, event, depth)
    or None."""

    __slots__ = ("flag", "depth", "host", "events", "turn", "pending")

    def __init__(self, device):
        self.flag = torch.zeros(1, dtype=torch.int32, device=device)
        self.depth = 0
        self.host = self.events = None
        if _deferred(device):
            cuda = device.type == "cuda"
            self.host = [torch.zeros(1, dtype=torch.int32, pin_memory=cuda)
                         for _ in range(2)]
            self.events = [torch.cuda.Event() if cuda else None
                           for _ in range(2)]
        self.turn = 0
        self.pending = None

    def snapshot(self):
        """Queue the flag's copy into the next host buffer, clear the flag
        behind it and record the buffer's event: (buffer, event, depth)."""
        i, self.turn = self.turn, self.turn ^ 1
        buf, event = self.host[i], self.events[i]
        buf.copy_(self.flag, non_blocking=True)
        self.flag.zero_()
        if event is not None:
            event.record(torch.cuda.current_stream(self.flag.device))
        snap, self.depth = (buf, event, self.depth), 0
        return snap

    def read_now(self) -> None:
        """Read the flag at once; raise and clear it if it is set."""
        overflowed = self.flag.item()
        depth, self.depth = self.depth, 0
        if overflowed:
            self.flag.zero_()
            _raise(depth)


def _deferred(device) -> bool:
    """Whether `device`'s checks read the previous snapshot (a CUDA
    device, where the flag's copy to the host is asynchronous)."""
    return device.type == "cuda"


def _wait(snap) -> None:
    """Wait until a snapshot's copy has landed (the only wait of a
    deferred check); raise if the flag was set."""
    buf, event, depth = snap
    with telemetry.span("sync.overflow"):
        if event is not None:
            event.synchronize()
    if buf.item():
        _raise(depth)


def _raise(depth: int):
    raise RuntimeError(f"bvh8_walk: a ray's stack passed {depth} "
                       f"entries; its hit was not found")


def _entries(device):
    """The _Overflow of each device that launched a walk and that `device`
    names (every device when None; a device without an index stands for
    every device of its type)."""
    want = None if device is None else torch.device(device)
    return [e for dev, e in list(_OVERFLOW.items())
            if want is None or (dev.type == want.type and (
                want.index is None or dev.index == want.index))]


def overflow_flag(device, stack_depth: int) -> torch.Tensor:
    """The device's overflow flag (made zero at first use), noting a
    launch with `stack_depth` entries for the checks' message."""
    device = torch.device(device)
    entry = _OVERFLOW.get(device)
    if entry is None:
        entry = _OVERFLOW[device] = _Overflow(device)
    entry.depth = max(entry.depth, stack_depth)
    return entry.flag


def check_overflow(device=None) -> None:
    """Raise if a walk launched on `device` (as `_entries` reads it) up to
    the previous check overflowed its stack; the renderer calls it once a
    spp. On a CUDA device it snapshots the flag without waiting and waits
    only for the previous check's snapshot (the span "sync.overflow"):
    an overflow raises one check later. Elsewhere it reads the flag at
    once. The flag is cleared either way."""
    _check(device, settle=False)


def settle_overflow(device=None) -> None:
    """Raise if any walk launched on `device` so far overflowed: the
    pending snapshot of the last check, and the flag as it is now (a
    snapshot waited for at once). The film reads call it, so that an
    overflow raises before an image is read."""
    _check(device, settle=True)


def _check(device, settle: bool) -> None:
    for entry in _entries(device):
        if entry.host is None:
            entry.read_now()
            continue
        prev, entry.pending = entry.pending, entry.snapshot()
        if prev is not None:
            _wait(prev)
        if settle:
            last, entry.pending = entry.pending, None
            _wait(last)


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
                   kinds=(True, True, True), counts=None, prims=None):
    """Closest hit -> (t [N] f32, prim [N] i32, -1 = miss; t = tmax on a
    miss), or with `any_hit` -> found [N] bool. `n_inst` 0 walks the flat
    table from row 0; otherwise `aux [n_inst, 20]` lists the instances,
    `prims` (the scene's dense_prims [P, 16]) gives a closest hit on a
    triangle its world t, and `counts` (int64 [2] or None) gets the walk's
    inst_entered and blas_walks added. A stack overflow is reported by
    check_overflow, not here."""
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
    if counts is not None:
        check_cuda_f32("counts", counts, (2,), device, torch.int64)
    if n_inst:
        if prims is None:
            raise ValueError("an instanced walk takes the scene's world "
                             "records (prims, dense_prims)")
        check_cuda_f32("prims", prims, (None, 16), device)
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
        table.data_ptr(), aux.data_ptr(), n_inst,
        prims.data_ptr() if n_inst else None,
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        t.data_ptr() if t is not None else None,
        prim.data_ptr() if prim is not None else None,
        found.data_ptr() if found is not None else None,
        overflow.data_ptr(),
        counts.data_ptr() if counts is not None and n_inst else None, n,
        stack_depth, group_cap(stack_depth),
        int(any_hit), int(all_kinds(kinds)),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(rc, "bvh8_walk")
    STATS.launches += 1
    return found if any_hit else (t, prim)
