"""ctypes binding of the native C++ SAH BVH builder (csrc/bvh_builder.cpp).

The port of gpu_pathtracer_tpu/geom/bvh_native.py. The library is built
at first use with `g++ -O2 -shared -fPIC` into `build/` at the root of
the checkout (beside the CUDA kernels of kernels.py), named by a hash of
the source and the flags, so a changed source is rebuilt and an
unchanged one is reused. A missing compiler, a failed build or a failed
load raises. The builder is what keeps the host build of
100,000-triangle and larger scenes short (the reference's bvh.cpp:
38-151).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time

import numpy as np

from gpu_pathtracer_tpu_torch.geom.bvh import FlatBVH
from gpu_pathtracer_tpu_torch.kernels import BUILD, CSRC, BuildInfo

SRC = CSRC / "bvh_builder.cpp"
FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
BUILD_INFO: BuildInfo | None = None   # how the loaded library was built


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return str(BUILD / f"bvh_builder-{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """The builder's library, compiled on first use."""
    global _lib, BUILD_INFO
    if _lib is not None:
        return _lib
    so = library_path()
    seconds, log = 0.0, ""
    if not os.path.exists(so):
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(["g++", *FLAGS, "-o", tmp, str(SRC)],
                              capture_output=True, text=True)
        seconds, log = time.perf_counter() - t0, proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    f32 = ctypes.POINTER(ctypes.c_float)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.build_bvh.restype = ctypes.c_int
    lib.build_bvh.argtypes = [f32, f32, ctypes.c_int32, f32, f32, i32, i32,
                              i32, ctypes.POINTER(ctypes.c_uint8), i32, i32]
    _lib, BUILD_INFO = lib, BuildInfo(so, seconds, log)
    return lib


def build_bvh_native(prim_bbox_min: np.ndarray,
                     prim_bbox_max: np.ndarray) -> FlatBVH:
    """FlatBVH of per-primitive AABBs [P, 3] from the C++ builder."""
    lib = load()
    n = prim_bbox_min.shape[0]
    if n == 0:
        raise ValueError("cannot build BVH over zero primitives")
    cap = max(2 * n, 2)
    bmin = np.ascontiguousarray(prim_bbox_min, np.float32)
    bmax = np.ascontiguousarray(prim_bbox_max, np.float32)
    nb_min = np.empty((cap, 3), np.float32)
    nb_max = np.empty((cap, 3), np.float32)
    second = np.empty(cap, np.int32)
    start = np.empty(cap, np.int32)
    end = np.empty(cap, np.int32)
    is_leaf = np.empty(cap, np.uint8)
    order = np.empty(n, np.int32)
    n_nodes = np.zeros(1, np.int32)

    def ptr(a):
        return a.ctypes.data_as(
            ctypes.POINTER(np.ctypeslib.as_ctypes_type(a.dtype)))

    rc = lib.build_bvh(ptr(bmin), ptr(bmax), n, ptr(nb_min), ptr(nb_max),
                       ptr(second), ptr(start), ptr(end), ptr(is_leaf),
                       ptr(order), ptr(n_nodes))
    if rc != 0:
        raise RuntimeError(f"native BVH build failed with code {rc}")
    k = int(n_nodes[0])
    return FlatBVH(
        bbox_min=nb_min[:k].copy(), bbox_max=nb_max[:k].copy(),
        is_leaf=is_leaf[:k].astype(bool), second_child=second[:k].copy(),
        start=start[:k].copy(), end=end[:k].copy(), prim_order=order)
