"""Wrapper of the media tracking kernel (csrc/track.cu).

`segment_majorants_cuda` (entry point 1, the counterpart of the JAX
package's K5 lookup) and `track_cuda` (entry point 2, the tracking walk)
check their tensors, allocate the outputs (and the walk's lane queue
and its two counters), launch on the current stream and count each call
in `STATS` (one for the walk's two passes). They take CUDA tensors only
and have no fallback; the plain PyTorch versions are shade/media.py::
_segment_majorants and _track_torch, which count their calls on CUDA
tensors in `STATS.plain_cuda`.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_pathtracer_tpu_torch.kernels import (
    KernelStats, check_cuda_f32, check_launch, load_library,
)

STATS = KernelStats()

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_MASK32 = 0xFFFFFFFF


def _lib():
    lib = load_library("track")
    if lib.track.argtypes is None:
        lib.segment_majorants.restype = ctypes.c_int
        lib.segment_majorants.argtypes = [_P, _P, _I, _I, _P, _P, _P, _P, _P,
                                          _I, _P]
        lib.track.restype = ctypes.c_int
        lib.track.argtypes = [_P, _I, _P, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                              _P, _P, _P, _U, _U, _U, _I, _I, _P, _P, _P, _P,
                              _I, _P]
        lib.track_occupancy.restype = ctypes.c_int
        lib.track_occupancy.argtypes = [_I, _I, _P]
    return lib


def _check_int(name, t, n, device, dtype=torch.int32):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype or tuple(t.shape) != (n,):
        raise ValueError(f"{name} must be {dtype} of shape ({n},), got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tables(scene, device):
    """(med_table, sv_max, S1, oct4) of the scene, checked."""
    from gpu_pathtracer_tpu_torch.scene.flatten import MED_COLS, sv_res
    table = scene.med_table
    k = table.shape[0]
    s1 = sv_res(k) + 1
    check_cuda_f32("media table", table, (k, MED_COLS), device)
    check_cuda_f32("med_sv_max", scene.med_sv_max, (k * s1 ** 3,), device)
    oct4 = scene.med_density_oct4
    check_cuda_f32("med_density_oct4", oct4, (k, None, None, None, 4),
                   device)
    return table, scene.med_sv_max, s1, oct4


def segment_majorants_cuda(scene, ro, rd, tmax_h, med_idx):
    """maj [N, 42] of each ray's segments of [0, tmax_h] (the plain
    version: media._segment_majorants on gather_medium(med_idx))."""
    from gpu_pathtracer_tpu_torch.shade.media import NSEG
    device = ro.device
    n = ro.shape[0]
    table, sv_max, s1, _ = _tables(scene, device)
    check_cuda_f32("ro", ro, (n, 3), device)
    check_cuda_f32("rd", rd, (n, 3), device)
    check_cuda_f32("tmax_h", tmax_h, (n,), device)
    _check_int("med_idx", med_idx, n, device)
    maj = torch.empty((n, NSEG), dtype=torch.float32, device=device)
    if n == 0:
        return maj
    rc = _lib().segment_majorants(
        table.data_ptr(), sv_max.data_ptr(), sv_max.numel(), s1, ro.data_ptr(),
        rd.data_ptr(), tmax_h.data_ptr(), med_idx.data_ptr(), maj.data_ptr(),
        n, torch.cuda.current_stream(device).cuda_stream)
    check_launch(rc, "segment_majorants")
    STATS.launches += 1
    return maj


def track_cuda(scene, mode: int, med_idx, ro, rd, tmax, key, iter_max: int):
    """The tracking walk (shade/media.py::track) on the card -> (out [N]
    f32, candidates [N] i32). med_idx: int32 [N]; tmax: float32 [N];
    key.lanes: int64 [N], as the VPT passes them; key.sites: None or
    int32 [N]. Two launches on the current stream, no host sync: the
    classify pass, then the persistent walk over the queue of lanes that
    walk."""
    device = ro.device
    n = ro.shape[0]
    table, sv_max, s1, oct4 = _tables(scene, device)
    ro, rd, tmax = ro.contiguous(), rd.contiguous(), tmax.contiguous()
    check_cuda_f32("ro", ro, (n, 3), device)
    check_cuda_f32("rd", rd, (n, 3), device)
    check_cuda_f32("tmax", tmax, (n,), device)
    _check_int("med_idx", med_idx, n, device)
    _check_int("lanes", key.lanes, n, device, torch.int64)
    if key.sites is not None:
        _check_int("sites", key.sites, n, device)
    if mode not in (0, 1):
        raise ValueError(f"mode must be 0 (sample) or 1 (tr), got {mode}")
    out = torch.empty(n, dtype=torch.float32, device=device)
    cand = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out, cand
    queue = torch.empty(n, dtype=torch.int32, device=device)
    counters = torch.empty(2, dtype=torch.int32, device=device)
    _, dz1, dy1, dx1, _ = oct4.shape
    rc = _lib().track(
        table.data_ptr(), table.shape[0], sv_max.data_ptr(), sv_max.numel(),
        s1, oct4.data_ptr(), dz1, dy1, dx1, ro.data_ptr(), rd.data_ptr(),
        tmax.data_ptr(), med_idx.data_ptr(), key.lanes.data_ptr(),
        None if key.sites is None else key.sites.data_ptr(), key.seed & _MASK32, key.iteration & _MASK32, key.tag & _MASK32, mode,
        int(iter_max), out.data_ptr(), cand.data_ptr(), queue.data_ptr(),
        counters.data_ptr(), n, torch.cuda.current_stream(device).cuda_stream)
    check_launch(rc, "track")
    STATS.launches += 1
    return out, cand


def occupancy(scene) -> dict:
    """The launch shapes of track.cu's two persistent kernels on the
    current card for this scene's media tables: threads per block, blocks
    per SM (the occupancy API) and dynamic shared-memory bytes per block
    of the walk and of segment_majorants."""
    out = (ctypes.c_int * 6)()
    check_launch(_lib().track_occupancy(scene.med_table.shape[0],
                                        scene.med_sv_max.numel(), out),
                 "track_occupancy")
    return {"walk_threads": out[0], "walk_blocks_per_sm": out[1],
            "walk_smem_bytes": out[2], "majorant_threads": out[3],
            "majorant_blocks_per_sm": out[4], "majorant_smem_bytes": out[5]}
