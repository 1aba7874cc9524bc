"""The port does all that the JAX package does: every module of
gpu_pathtracer_tpu/ has a module of the same relative path in
gpu_pathtracer_tpu_torch/, or its work moved into the port's CUDA
sources (MOVED, each entry naming where)."""

import pytest

import torch_parity as tp

JAX = tp.REPO / "gpu_pathtracer_tpu"
PORT = tp.REPO / "gpu_pathtracer_tpu_torch"
# JAX module -> (its counterpart, the csrc files that hold it)
MOVED = {
    "geom/dense_tpu.py": ("K1 and K3, the dense and block-culled hits",
                          ("csrc/dense.cu", "csrc/blocked.cu")),
    "geom/packet_tpu.py": ("K4, the BVH8 / TLAS walk",
                           ("csrc/bvh8_walk.cu",)),
    "ops/small_gather.py": ("K5's majorant lookup, in the tracking walk",
                            ("csrc/track.cu",)),
    "ops/gather.py": ("plain indexing (ROADMAP.md, 'Not to port'): a "
                      "gather is a load on the GPU", ()),
    "ops/__init__.py": ("none: the package of the two ops modules above",
                        ()),
}
JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_has_a_counterpart(rel):
    if rel in MOVED:
        assert not (PORT / rel).exists(), f"{rel} is ported: drop it from MOVED"
        for src in MOVED[rel][1]:
            assert (PORT / src).is_file(), f"{rel}'s counterpart {src}"
    else:
        assert (PORT / rel).is_file(), f"{rel} has no counterpart in the port"


def test_moved_names_jax_modules():
    assert set(MOVED) <= set(JAX_MODULES)
