"""The reference against the program's plain path, and what it imports.

The program's all-plain estimators (its PyTorch versions of every
kernel, over the plain intersection) are what its kernels are held to
on the card; the reference is written apart from them, so agreeing with
them at 16 x 16 on the CPU shows that it computes the same estimator
from the same draws.
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import cells, check
from benchmark.reference import bdpt as ref_bdpt
from benchmark.reference import pt as ref_pt
from benchmark.reference import scene as ref_scene

from conftest import ROOT

SIZE = 16
SEED = 2**31 + 3   # larger than 32 signed bits hold


def _program(config: str, integrator: str):
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    host = load_scene(cells.cell(f"{config}.pt")["config_path"])
    host.width = host.height = SIZE
    return Renderer(host, seed=SEED, device="cpu", cache=False,
                    integrator=IntegratorType[integrator.upper()])


@pytest.mark.parametrize("config,its", [("cornell_box", (1, 9)),
                                        ("knot_100k", (4,))])
def test_pt_matches_program_plain_path(config, its):
    from gpu_pathtracer_tpu_torch.integrators import pt
    r = _program(config, "pt")
    ref = ref_scene.load(cells.cell(f"{config}.pt")["config_path"], "cpu",
                         size=SIZE)
    ids = torch.arange(SIZE * SIZE, dtype=torch.int32)
    for it in its:
        want = pt.wavefront(r.device_scene, r.static, SEED, it, ids % SIZE,
                            ids // SIZE, plain=True)
        got = ref_pt.radiance(ref, SEED, torch.full((SIZE * SIZE,), it), ids)
        assert check.off_share(got, want) == 0.0
        assert check.sum_gap(got, want) < 1e-6


def test_bdpt_matches_program_plain_path():
    from gpu_pathtracer_tpu_torch.integrators import bdpt
    r = _program("cornell_box", "bdpt")
    ref = ref_scene.load(cells.cell("cornell_box.bdpt")["config_path"],
                         "cpu", size=SIZE)
    ids = torch.arange(SIZE * SIZE, dtype=torch.int32)
    for it in (1, 6):
        li, film = bdpt.render_lanes(r.device_scene, r.static, SEED, it,
                                     ids % SIZE, ids // SIZE, plain=True)
        got_li, got_film = ref_bdpt.radiance(
            ref, SEED, torch.full((SIZE * SIZE,), it), ids)
        for got, want in ((got_li, li), (got_film, film)):
            assert check.off_share(got, want) == 0.0
            assert check.sum_gap(got, want) < 1e-6


def test_reference_batches_iterations():
    """One call over lanes of several iterations equals a call an
    iteration: the window check renders thousands of iterations at once."""
    ref = ref_scene.load(cells.cell("cornell_box.pt")["config_path"], "cpu",
                         size=SIZE)
    ids = torch.arange(SIZE * SIZE)
    its = torch.tensor([3, 17])
    both = ref_pt.radiance(ref, SEED, its.repeat_interleave(ids.shape[0]),
                           ids.repeat(2))
    for k, it in enumerate(its.tolist()):
        one = ref_pt.radiance(ref, SEED, torch.full_like(ids, it), ids)
        assert torch.equal(both[k * ids.shape[0]:(k + 1) * ids.shape[0]],
                           one)


def _imported(modules: list) -> set:
    """Top-level names in sys.modules of a fresh process that imports
    `modules`."""
    code = ("import json, sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_import_no_jax():
    names = _imported(["benchmark.run", "benchmark.control",
                       "benchmark.check", "benchmark.reference.pt",
                       "benchmark.reference.bdpt"])
    assert not names & {"jax", "jaxlib", "flax", "gpu_pathtracer_tpu"}


def test_reference_imports_nothing_of_the_program():
    names = _imported(["benchmark.reference.scene", "benchmark.reference.pt",
                       "benchmark.reference.bdpt", "benchmark.check"])
    assert "gpu_pathtracer_tpu_torch" not in names
    assert not names & {"jax", "jaxlib", "flax", "gpu_pathtracer_tpu"}
