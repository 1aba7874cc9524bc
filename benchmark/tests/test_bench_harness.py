"""The harness: its files found by name, its result line, its check.

The runs here go through `run.run_cell` on the CPU at 16 x 16 (the
program's plain path), which skips only the harness's look for a card;
`main` itself refuses to run without one.
"""

import contextlib
import io
import json
import os
import re
import shutil

import pytest
import torch

from benchmark import cells, check, control, run
from benchmark.reference import scene as ref_scene

from conftest import ROOT

SIZE = 16
SEED = 4_000_000_007
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
BENCH = cells.benchmark(str(ROOT))
CPU_CELLS = ("cornell_box.pt", "cornell_box.bdpt")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
    assert len(BENCH["command"]) <= 32
    for part, keys in KEYS.items():
        names = [e["name"] for e in BENCH[part]]
        assert len(names) == len(set(names)), part
        for e in BENCH[part]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}, e
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e and part in ("configs", "workloads", "per_layer"):
                    assert LINE.match(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_metrics_bounds_and_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])
    for w in BENCH["workloads"]:
        spec = cells.cell(w["name"], str(ROOT))
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        assert w["chips"] in (1, 4)


def test_every_entry_found_by_name():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert set(c["reduced"]) <= set(json.load(open(
            os.path.join(ROOT, c["file"]))))
    for w in BENCH["workloads"]:
        spec = cells.cell(w["name"], str(ROOT))
        assert spec["config_path"] == os.path.join(
            str(ROOT), "benchmark", "configs", w["config"] + ".json")
        assert spec["traffic"]["integrator"]
        assert spec["workload"]["check"]["limits"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(cells.reader(m["name"], str(ROOT)))


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric that
    a later change adds as files and BENCHMARK.json entries are found."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("*.obj", "__pycache__"))
    b = json.loads(json.dumps(BENCH))
    here = tmp_path / "benchmark"
    cfg = json.load(open(here / "configs" / "cornell_box.json"))
    json.dump(cfg, open(here / "configs" / "cornell_box_2k.json", "w"))
    json.dump(dict(json.load(open(here / "traffic" / "pt.json")), tile=4096),
              open(here / "traffic" / "pt_tiled.json", "w"))
    json.dump(json.load(open(here / "workloads" / "cornell_box.pt.json")),
              open(here / "workloads" / "cornell_box_2k.pt_tiled.json", "w"))
    (here / "metrics" / "frames_seen.py").write_text(
        "def read(s):\n    return s.get('frames')\n")
    b["configs"].append(dict(b["configs"][0], name="cornell_box_2k",
                             file="benchmark/configs/cornell_box_2k.json"))
    b["workloads"].append({"name": "cornell_box_2k.pt_tiled",
                           "config": "cornell_box_2k", "traffic": "pt_tiled",
                           "chips": 1, "why": "a test cell"})
    b["per_layer"].append({"name": "frames_seen", "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "spp_per_s"})
    json.dump(b, open(tmp_path / "BENCHMARK.json", "w"))
    spec = cells.cell("cornell_box_2k.pt_tiled", str(tmp_path))
    assert spec["traffic"]["tile"] == 4096
    assert spec["config"]["screen_width"] == 1024
    assert "frames_seen" in {m["name"] for m in spec["per_layer"]}
    # an old cell gets a metric without a workloads key too
    old = cells.cell("cornell_box.pt", str(tmp_path))
    assert "frames_seen" in {m["name"] for m in old["per_layer"]}
    got = {m["name"]: cells.reader(m["name"], str(tmp_path))({"frames": 7})
           for m in old["per_layer"] if m["name"] == "frames_seen"}
    assert got == {"frames_seen": 7}


def _run(cell, monkeypatch, traced=False, seconds=2.5):
    """run_cell on the CPU at SIZE, the window check held to 8,192
    (iteration, pixel) pairs: a broken renderer that returns at once
    renders thousands of frames in the window."""
    real = cells.cell

    def small(name, root=cells.ROOT):
        spec = real(name, root)
        spec["workload"]["check"]["window_lanes"] = 8192
        return spec
    monkeypatch.setattr(cells, "cell", small)
    return run.run_cell(cell, SEED, seconds, traced, device="cpu", size=SIZE)


@pytest.mark.parametrize("cell", CPU_CELLS)
def test_result_line(cell, monkeypatch):
    res, info = _run(cell, monkeypatch)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["attempted"] == info["spp"]
    spec = cells.cell(cell, str(ROOT))
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == set(spec["workload"]["check"]["limits"]) \
        | {"plain_calls"}
    json.dumps(res)


def test_traced_result_line(monkeypatch):
    res, _ = _run("cornell_box.pt", monkeypatch, traced=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    spec = cells.cell("cornell_box.pt", str(ROOT))
    # on the CPU no device op is traced: the device metrics stay silent
    assert set(res["metrics"]) <= {m["name"] for m in spec["per_layer"]}
    assert "scene_build_s" in res["metrics"]
    assert "device_ms_per_spp" not in res["metrics"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", "cornell_box.pt", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""
    assert "is_available() is false" in err.getvalue()


def _unchanged(monkeypatch):
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    monkeypatch.setattr(Renderer, "_render_tiles", lambda self, args: None)


def _wrapped(monkeypatch, change):
    from gpu_pathtracer_tpu_torch.run import renderer
    real = renderer.lane_program

    def lane_program(integrator):
        kind, program = real(integrator)

        def broken(*args, **kw):
            out = program(*args, **kw)
            return (change(out[0]),) + tuple(out[1:])
        return kind, broken
    monkeypatch.setattr(renderer, "lane_program", lane_program)


def _half(li):
    """Half of the lanes left out, the rest doubled: the mean kept."""
    keep = (torch.arange(li.shape[0]) % 2 == 0).to(li.device)[:, None]
    return torch.where(keep, 2.0 * li, 0.0)


FAULTS = {
    "state_unchanged": _unchanged,
    "half_the_lanes": lambda mp: _wrapped(mp, _half),
    "answers_altered": lambda mp: _wrapped(mp, lambda li: li * 1.01),
}


@pytest.mark.parametrize("cell", CPU_CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res, _ = _run(cell, monkeypatch)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CPU_CELLS)
def test_bfloat16_control_is_not_correct(cell):
    spec = cells.cell(cell, str(ROOT))
    ref = ref_scene.load(spec["config_path"], "cpu", size=SIZE)
    kept = control.control_outputs(spec, SEED, 24, "cpu", size=SIZE)
    numbers, _ = check.compare(kept, ref, spec["traffic"]["integrator"],
                               SEED, spec["workload"]["check"])
    assert not check.passed(numbers)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_card(cell, card):
    res, info = run.run_cell(cell, SEED, 2.0, False, device=card)
    assert res["correct"] is True, res["checks"]
    assert info["plain_calls"] == 0


def test_trace_summary_on_events():
    """Device intervals merged, the program's kernels apart from the glue,
    the longest idle gap named by the host call that launched its end."""
    from benchmark import trace
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void k_a_kernel<1>(P)",
         "ts": 0.0, "dur": 100.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel<128>",
         "ts": 50.0, "dur": 100.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "ts": 400.0, "dur": 100.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemsetAsync",
         "ts": 390.0, "dur": 5.0, "args": {"correlation": 3}, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::zero_", "ts": 300.0,
         "dur": 100.0, "tid": 7},
    ]
    s = trace.summary(ev, wall_s=0.001, spp=2, kernels=["k_a_kernel"])
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["device_ms_per_spp"] == pytest.approx(0.125)
    assert s["ops_per_spp"] == 1.5
    assert s["kernels"] == {"k_a_kernel": {"ms_per_spp": 0.05,
                                           "per_spp": 0.5}}
    assert s["glue_ms_per_spp"] == pytest.approx(0.1)
    assert s["idle_gaps"][0][1] == pytest.approx(250e-6)
    assert "cudaMemsetAsync" in s["idle_gaps"][0][0]
    assert trace.idle_share(0.125, 4000.0) == (0.5, None)
    assert trace.idle_share(1.0, 1200.0)[1]
