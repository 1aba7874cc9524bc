"""The port's bench (gpu_pathtracer_tpu_torch/run/bench.py) on the CPU at
small sizes: its rows' scenes, their map onto the JAX package's
bench.py, one bench run of two rows, the rows it cannot run, its timing
windows and its summary of a profiler trace."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu_torch.run import bench

ENV = dict(os.environ, PYTHONPATH=str(tp.REPO))
SMALL = ["--device", "cpu", "--size", "16", "--windows", "1", "--min-spp",
         "1", "--min-seconds", "0"]
RUN_ROWS = ("cornell", "vpt")


def _bench(args, cwd):
    r = subprocess.run(
        [sys.executable, "-m", "gpu_pathtracer_tpu_torch.run.bench", *args],
        cwd=cwd, env=ENV, capture_output=True, text=True, timeout=300)
    lines = r.stdout.splitlines()
    return r, [json.loads(ln) for ln in lines if not ln.startswith("#")]


def _jax_bench_rows() -> list:
    """The rows of the JAX package's bench.py, read from its source (its
    module level imports only the standard library; nothing is run): the
    keys of SCENES and "integ_<name>" for each entry of INTEG_MATRIX."""
    tree = ast.parse((tp.REPO / "bench.py").read_text())
    rows = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.List):
            name = node.targets[0].id
            firsts = [e.elts[0].value for e in node.value.elts]
            if name == "SCENES":
                rows += firsts
            elif name == "INTEG_MATRIX":
                rows += [f"integ_{k}" for k in firsts]
    return rows


def test_jax_bench_module_imports_only_the_standard_library():
    tree = ast.parse((tp.REPO / "bench.py").read_text())
    names = {a.name.split(".")[0] for n in tree.body
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in tree.body
              if isinstance(n, ast.ImportFrom)}
    assert names <= set(sys.stdlib_module_names) | {"__future__"}, names
    assert len(_jax_bench_rows()) == 11


@pytest.mark.parametrize("entry", _jax_bench_rows())
def test_jax_bench_row_has_a_port_row(entry):
    """Every row of bench.py stands for exactly one row of the port's."""
    ported = [row.name for row in bench.ROWS if entry in row.stands_for]
    assert len(ported) == 1, (entry, ported)


@pytest.mark.parametrize("name", [row.name for row in bench.ROWS])
def test_row_scene_parses(name):
    """Every row's scene is in the repository, parses with the port at
    1024^2, has a light, and names kernels the wrappers count."""
    from gpu_pathtracer_tpu_torch.run import reference
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    row = bench.ROW_BY_NAME[name]
    host = load_scene(str(tp.REPO / "scenes" / row.scene))
    assert (host.width, host.height) == (1024, 1024)
    assert host.primitives and (host.lights or host.infinite is not None)
    assert row.integrator.upper() in IntegratorType.__members__
    assert row.kernels and set(row.kernels) <= set(reference.kernel_stats())


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """One bench run on the CPU at 16^2: one window of 1 spp of each of
    RUN_ROWS."""
    r, lines = _bench([*SMALL, "--rows", ",".join(RUN_ROWS)],
                      tmp_path_factory.mktemp("bench"))
    assert r.returncode == 0, r.stderr[-3000:]
    return lines


def test_every_line_holds_the_result_so_far(small_run):
    """One JSON line at the start, one per finished row, one at the end;
    the last holds both rows, the card and the headline."""
    assert [len(ln["rows"]) for ln in small_run] == [0, 1, 2, 2]
    last = small_run[-1]
    assert list(last["rows"]) == list(RUN_ROWS)
    assert last["card"] == "cpu" and last["device"]["platform"] == "cpu"
    assert last["value"] == last["rows"]["cornell"]["value"]
    assert last["failed"] == [] and last["flagged"] == []
    assert last["total_s"] > 0


@pytest.mark.parametrize("name", RUN_ROWS)
def test_row_on_cpu(small_run, name):
    """A row renders, is correct, and counts the rays `Renderer.rays`
    counts for the same spp of the same render."""
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    res = small_run[-1]["rows"][name]
    row = bench.ROW_BY_NAME[name]
    assert res["value"] > 0 and res["min"] <= res["value"] <= res["max"]
    assert res["correct"] is True and res["checks"]
    assert all(c["ok"] and c["rows"] > 0 for c in res["checks"])
    assert res["spp"] == 1 and res["windows"] == 1 and res["build_s"] > 0
    assert res["rates"] == [res["value"]]
    assert res["flags"] == []
    assert res["peak_mb"] is None and res["profile"] is None   # no device
    host = load_scene(str(tp.REPO / "scenes" / row.scene))
    host.width = host.height = 16
    r = Renderer(host, device="cpu", cache=False, max_depth=5,
                 integrator=IntegratorType[row.integrator.upper()])
    r.render_iteration()              # the warm-up spp
    before = int(r.rays)
    for _ in range(res["spp"]):
        r.render_iteration()
    assert res["rays"] == int(r.rays) - before > 0
    assert res["mrays_s"] == pytest.approx(
        res["rays"] / res["seconds"] / 1e6)


@pytest.mark.parametrize("args, value, rc, why", [
    (["--rows", "cornell", "--scenes", "."], -1.0, 1, "no scene"),
    (["--rows", "sppm_4card"], -2.0, 0, "needs 4 CUDA devices"),
    (["--rows", "cornell", "--budget", "0"], -2.0, 0, "budget"),
], ids=["missing-scene", "four-cards", "budget"])
def test_row_not_run(tmp_path, args, value, rc, why):
    """A row that fails prints -1.0 and the bench exits non-zero; a row
    skipped for want of cards or budget prints -2.0 and is no failure."""
    r, lines = _bench([*SMALL, *args], tmp_path)
    assert r.returncode == rc, r.stderr[-3000:]
    (res,) = lines[-1]["rows"].values()
    assert res["value"] == value and why in res["why"]
    assert lines[-1]["failed"] == ([] if rc == 0 else ["cornell"])


@pytest.mark.parametrize("budget, row_timeout, value, rc, why", [
    ("0.5", None, -2.0, 0, "budget: timed out"),
    ("1500", 0.5, -1.0, 1, "timed out after"),
], ids=["budget-cut", "row-limit"])
def test_row_timed_out(monkeypatch, capsys, budget, row_timeout, value, rc,
                       why):
    """A row whose timeout was cut to what was left of the budget, and
    expired, is skipped (-2.0) and no failure; a row that runs past its
    own limit, ROW_TIMEOUT_S, fails (-1.0) and the bench exits non-zero.
    Neither row can finish within half a second."""
    monkeypatch.setattr(bench, "MIN_ROW_S", 0)
    if row_timeout is not None:
        monkeypatch.setattr(bench, "ROW_TIMEOUT_S", row_timeout)
    assert bench.main([*SMALL, "--rows", "cornell", "--budget", budget]) == rc
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    (res,) = lines[-1]["rows"].values()
    assert res["value"] == value and why in res["why"]
    assert lines[-1]["failed"] == ([] if rc == 0 else ["cornell"])


class _FakeRenderer:
    """What `bench.windows` reads of a renderer: 7 rays a spp."""
    device = torch.device("cpu")

    class shard:
        joined = False

    def __init__(self):
        self.iteration = 0

    def render_iteration(self):
        self.iteration += 1

    @property
    def rays(self):
        return torch.tensor(7 * self.iteration)


@pytest.mark.parametrize("min_spp, min_seconds, want", [
    (1, 0.0, 1), (3, 0.0, 3), (1, 0.02, None)])
def test_windows(min_spp, min_seconds, want):
    """Each window runs at least min_spp whole spp and lasts at least
    min_seconds; its rays are the renderer's."""
    r = _FakeRenderer()
    wins = bench.windows(r, 2, min_spp, min_seconds)
    assert len(wins) == 2 and sum(w["spp"] for w in wins) == r.iteration
    for w in wins:
        assert w["spp"] >= min_spp and w["seconds"] >= min_seconds
        assert w["rays"] == 7 * w["spp"]
        if want is not None:
            assert w["spp"] == want
    s = bench.window_summary(wins)
    assert s["spp"] == r.iteration and s["rays"] == 7 * r.iteration
    assert s["min"] <= s["value"] <= s["max"]


def test_trace_summary():
    """Device time is the union of the device intervals; the gaps between
    them name the host calls open at their middle and the call that
    launched the work after them; csrc kernels get their share."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 0,
         "dur": 400, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 150, "dur": 300, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 450,
         "dur": 30, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 455, "dur": 10, "tid": 1, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "void dense_kernel<true>()",
         "ts": 100, "dur": 100, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 150,
         "dur": 100, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 500,
         "dur": 100, "args": {"correlation": 9}},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]
    s = bench.trace_summary(ev, 1e-3, 1, ["dense_kernel", "walk_kernel"])
    assert s["device_ms_per_spp"] == pytest.approx(0.25)
    assert s["traced_idle_share"] == pytest.approx(0.75)
    assert s["top_ops"][0]["name"] == "elementwise"
    assert s["top_ops"][0]["share"] == pytest.approx(0.8)
    assert [k["name"] for k in s["port_kernels"]] == ["dense_kernel"]
    (gap,) = s["gaps"]
    assert gap["ms"] == pytest.approx(0.25)
    assert gap["during"] == "aten::nonzero > cudaStreamSynchronize"
    assert gap["next"] == "aten::add > cudaLaunchKernel"


@pytest.mark.parametrize("device_ms, spp_s, idle, flagged", [
    (2.0, 250.0, 0.5, False), (50.0, 20.0, 0.0, False),
    (50.0, 21.0, -0.05, False), (50.0, 22.0, -0.1, True)])
def test_device_shares(device_ms, spp_s, idle, flagged):
    """The idle share is 1 - device ms/spp x the untraced spp/s, never
    clamped; a busy share above BUSY_MAX flags the row."""
    prof = {"device_ms_per_spp": device_ms}
    flags = bench.device_shares(prof, spp_s)
    assert prof["idle_share"] == pytest.approx(idle)
    assert prof["busy_share"] == pytest.approx(1.0 - idle)
    assert bool(flags) == flagged


@pytest.mark.parametrize("integ", ["ao", "bdpt", "lt"])
def test_sliced_reference_reads_the_renderer(integ):
    """A sliced row is held on what the timed renderer's warm-up spp
    left (AO and VPT: its film; BDPT: its per-lane radiance; LT: a pass
    over the kernels, since each path splats anywhere): it holds, and a
    film or radiance moved by one pixel, as a tiling fault would, does
    not."""
    import contextlib

    from gpu_pathtracer_tpu_torch.run import reference
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    host = load_scene(str(tp.REPO / "scenes" / "cornell_port/scene.json"))
    host.width = host.height = 16
    r = Renderer(host, device="cpu", cache=False, max_depth=5, tile_size=96,
                 integrator=IntegratorType[integ.upper()])
    keep = (reference.tile_radiance(r) if r.kind == "hybrid"
            else contextlib.nullcontext())
    with keep as tile_li:
        r.render_iteration()
    lanes = reference.slice_ids(256, r.device, 128)
    pairs = reference.plain_reference(integ, r, lanes, tile_li)
    assert [w for w, _, _ in pairs] == {
        "ao": ["radiance"], "bdpt": ["radiance", "film"], "lt": ["film"]}[integ]
    assert all(reference.held(a, b, w)["ok"] for w, a, b in pairs)
    if integ == "lt":
        return
    if tile_li is None:
        r.acc = r.acc.roll(1, 0)
    else:
        tile_li.copy_(tile_li.roll(1, 0))
    what, a, b = reference.plain_reference(integ, r, lanes, tile_li)[0]
    assert not reference.held(a, b, what)["ok"]


def test_sharded_row_on_cpu_ranks(tmp_path):
    """sppm_4card's own process under torchrun, as 4 gloo ranks on the
    CPU: the ranks agree on each window's spp, rank 0 alone reports, the
    row is correct and counts the rays one unsharded renderer counts."""
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4", "-m", "gpu_pathtracer_tpu_torch.run.bench",
         "--row", "sppm_4card", *SMALL, "--windows", "2"],
        cwd=tmp_path, env=dict(ENV, **bench.LOOPBACK), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    (res,) = [json.loads(ln[4:]) for ln in r.stdout.splitlines()
              if ln.startswith("ROW ")]
    assert res["cards"] == 4 and res["correct"] is True
    assert res["spp"] == 2 and res["unit"] == "iterations/s"
    host = load_scene(str(tp.REPO / "scenes" / "cornell_port/scene.json"))
    host.width = host.height = 16
    one = Renderer(host, device="cpu", cache=False, max_depth=5,
                   integrator=IntegratorType.SPPM,
                   photons_per_iteration=bench.SPPM_PHOTONS)
    one.render_iteration()
    before = int(one.rays)
    for _ in range(res["spp"]):
        one.render_iteration()
    assert res["rays"] == int(one.rays) - before
