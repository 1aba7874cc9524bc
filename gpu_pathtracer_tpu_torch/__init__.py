"""PyTorch/CUDA port of gpu_pathtracer_tpu.

The package mirrors the JAX package's module paths and function names.
Plain tensor code runs on any device; the path tracer's two hot kernels
are hand-written CUDA for Hopper (csrc/), built on first use and launched
only on CUDA tensors. The package never imports JAX or the JAX package.
"""

from gpu_pathtracer_tpu_torch.scene.parse import load_scene  # noqa: F401
