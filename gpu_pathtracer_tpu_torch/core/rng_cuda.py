"""Wrapper of the Philox draw kernel (csrc/rng.cu).

`philox_uniform_cuda` checks its tensor, allocates the [4 n_blocks, N]
float32 output, launches on the current stream and counts the launch in
`STATS`. It takes CUDA tensors only and has no fallback; the plain
PyTorch version is core/rng.py::philox_uniform_torch, which counts its
calls on CUDA tensors in `STATS.plain_cuda`, and core/rng.py::
philox_uniform picks between the two.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_pathtracer_tpu_torch.kernels import (
    KernelStats, check_launch, load_library,
)

STATS = KernelStats()

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_MASK32 = 0xFFFFFFFF


def _lib():
    lib = load_library("rng")
    if lib.philox_uniform.argtypes is None:
        lib.philox_uniform.restype = ctypes.c_int
        lib.philox_uniform.argtypes = [_P, _I, _U, _I, _U, _U, _U, _P, _P]
    return lib


def philox_uniform_cuda(lanes, block0: int, n_blocks: int, tag: int,
                        seed: int, iteration: int):
    """Rows 4 b + k (b < n_blocks, k < 4) = site 4 (block0 + b) + k of
    stream `tag` for each lane: float32 [4 n_blocks, N]. lanes: a
    contiguous CUDA int64 [N] of uint32 values."""
    if not lanes.is_cuda:
        raise ValueError(f"lanes must be a CUDA tensor, got {lanes.device}")
    if lanes.dtype != torch.int64 or lanes.dim() != 1:
        raise ValueError(f"lanes must be int64 of shape (N,), got "
                         f"{lanes.dtype} {tuple(lanes.shape)}")
    if not lanes.is_contiguous():
        raise ValueError("lanes must be contiguous")
    n = lanes.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"{n} lanes: the kernel takes fewer than 2**31")
    if n_blocks < 0 or block0 < 0 or block0 + n_blocks > 1 << 32:
        raise ValueError(f"counter blocks {block0} .. {block0 + n_blocks} "
                         "must lie in 0 .. 2**32")
    out = torch.empty((4 * n_blocks, n), dtype=torch.float32,
                      device=lanes.device)
    if n == 0 or n_blocks == 0:
        return out
    rc = _lib().philox_uniform(
        lanes.data_ptr(), n, block0, n_blocks, tag & _MASK32, seed & _MASK32,
        iteration & _MASK32, out.data_ptr(),
        torch.cuda.current_stream(lanes.device).cuda_stream)
    check_launch(rc, "philox_uniform")
    STATS.launches += 1
    return out
