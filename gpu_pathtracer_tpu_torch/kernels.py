"""Build the port's CUDA kernels (csrc/*.cu) and count their launches.

Each kernel source (csrc/<name>.cu: dense, pt_fused, blocked,
bvh8_walk, track, rng, pt_shade, vpt_shade, bdpt) is compiled by `nvcc`
into its own shared library with a plain C interface, loaded with ctypes
(no PyTorch headers, so a build takes seconds). The build runs at first use, into `build/` at the root
of the checkout, keyed by a hash of the csrc/ sources and the flags, so
a changed source is rebuilt and an unchanged one is reused; `build`
compiles several sources at once, one nvcc process each. There is no
fallback: a missing `nvcc`, a failed build or a failed load raises.

`-fmad=false` keeps nvcc from contracting a*b+c into one fused
multiply-add: the kernels then round every operation like the plain
PyTorch versions beside them, which is what lets track.cu be held to
its plain version bit for bit (rng.cu, integer work only, is bit-equal
by construction). The hit tests of dense.cu (K1),
blocked.cu (K3), bvh8_walk.cu (K4) and pt_fused.cu's prim loops (K2)
write their fused multiply-adds out (fmaf, in csrc/intersect.cuh's
tri_cross routines only) and are held to their plain versions within
the hit limits, K2 within the radiance limits (PERF.md section 2),
pt_shade.cu, vpt_shade.cu and bdpt.cu (which share csrc/shade.cuh
with K2) bit for bit; their
sphere, line and box tests and the shading stay unfused. No fast-math flag is given, so
division and sqrt are IEEE-rounded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


@dataclass
class KernelStats:
    """Counters one kernel's wrapper keeps: `launches` counts kernel
    launches, `plain_cuda` counts calls of its plain PyTorch version on
    CUDA tensors (the reference path, never the main path)."""
    launches: int = 0
    plain_cuda: int = 0


@dataclass
class BuildInfo:
    path: str
    seconds: float      # 0.0 when the library was already built
    ptxas: str          # nvcc's -Xptxas -v report (registers, spills)


_LIBS: dict[str, ctypes.CDLL] = {}
BUILDS: dict[str, BuildInfo] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(names) -> None:
    """Build (once) and load csrc/<name>.cu as build/<name>-<hash>.so for
    each name, running the nvcc processes of the missing ones at once."""
    todo = [n for n in names if n not in _LIBS]
    if not todo:
        return
    key = _source_hash()
    jobs = {}
    for name in todo:
        so = BUILD / f"{name}-{key}.so"
        if not so.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs[name] = (proc, tmp, time.perf_counter())
    reports, failed = {}, []
    for name, (proc, tmp, t0) in jobs.items():   # wait for every one
        _, err = proc.communicate()
        reports[name] = (time.perf_counter() - t0, err)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{err}")
        else:
            os.replace(tmp, BUILD / f"{name}-{key}.so")
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in todo:
        so = BUILD / f"{name}-{key}.so"
        _LIBS[name] = ctypes.CDLL(str(so))
        seconds, ptxas = reports.get(name, (0.0, ""))
        BUILDS[name] = BuildInfo(str(so), seconds, ptxas)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    build([name])
    return _LIBS[name]


def all_kinds(kinds) -> bool:
    """Whether a kernel with a triangles-only and an all-kinds variant
    runs the all-kinds one: `kinds` = (has_tri, has_sph, has_lin), the
    scene's prim kinds (geom/dense.py::kinds_of), is not triangles only."""
    return tuple(map(bool, kinds)) != (True, False, False)


def check_launch(rc: int, kernel: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def check_cuda_f32(name: str, t: torch.Tensor, shape: tuple,
                   device: torch.device, dtype=torch.float32) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` (float32 unless
    given) and `shape` (None entries are free) on the CUDA `device`."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
