"""The card's published peaks and the operation counts held against them.

NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power limit
(a card set lower runs below them; the harness prints the limit beside
every run): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s
of HBM3.

K2's count (the path-trace megakernel, csrc/pt_fused.cu, for scenes of
at most 512 prims): it tests every ray it traces, closest-hit or shadow,
against every triangle of the scene, 40 float32 operations a test (the
Moller-Trumbore test's two cross products, three dot products, its
division and the compares of the barycentrics and of t). The count
reads only the rays and the scene's triangle count, never how K2 is
built, so a redesign of K2 moves its time and not its bound.
"""

from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
TRIANGLE_TEST_FLOPS = 40


def dense_hit_seconds(rays: float, triangles: int) -> float:
    """The least time `rays` brute-force tests of `triangles` each take at
    the float32 peak."""
    return rays * triangles * TRIANGLE_TEST_FLOPS / FP32_FLOPS
