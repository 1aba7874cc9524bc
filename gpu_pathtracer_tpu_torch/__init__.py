"""PyTorch/CUDA port of gpu_pathtracer_tpu.

The package mirrors the JAX package's module paths and function names.
Plain tensor code runs on any device; the path tracer's two hot kernels
are hand-written CUDA for Hopper (csrc/), built on first use and launched
only on CUDA tensors. The package never imports JAX or the JAX package.
"""

import torch


def _init_cpu_math() -> None:
    """Call each float32 transcendental the port uses once, on one
    thread. On the CPU, PyTorch computes them with MKL's VML, which sets
    itself up on a function's first call; when that first call comes
    from several OpenMP threads at once, one thread's chunk can come out
    at VML's low-accuracy setting (about 12 bits: relative errors up to
    3e-4 on one thread's share of the elements, in about 1 of 100 fresh
    processes with 2 threads, 1 of 15 with 8). Eight elements stay on
    the calling thread."""
    x = torch.full((8,), 0.5)
    for op in (torch.sqrt, torch.exp, torch.log, torch.cos, torch.sin,
               torch.acos, torch.atan, torch.tan):
        op(x)


_init_cpu_math()

from gpu_pathtracer_tpu_torch.scene.parse import load_scene  # noqa: E402,F401
