"""The port's spans and counters (gpu_pathtracer_tpu_torch/telemetry.py)
on the CPU: how spans nest and are kept, that they cost no profiler
annotation while no profiler runs and land in the profiler's trace
while one does, the spans and counters a 16 x 16 render records on the
routes of the benchmark's cells, the benchmark's readers of them on a
CPU run of a cell, and the CLI's `[spans]` line."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import torch_parity as tp
from benchmark import cells, run, trace
from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.geom.dense import DENSE_MAX
from gpu_pathtracer_tpu_torch.run.renderer import Renderer
from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
from gpu_pathtracer_tpu_torch.scene.parse import load_scene

SIZE = 16
SEED = 4_000_000_011
SETUP = {"scene.parse", "scene.flatten", "scene.bvh", "scene.upload"}
NEW_METRICS = ("host_issue_ms_per_spp", "host_sync_ms_per_spp",
               "host_syncs_per_spp", "live_lane_share", "scene_parse_s",
               "bvh_build_s")


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def test_spans_nest_and_the_ring_is_bounded():
    with telemetry.span("scene.parse"):
        with telemetry.span("scene.bvh"):
            pass
    with telemetry.iteration(1) as rec:
        with telemetry.span("pt.hit", 0):
            with telemetry.span("sync.tmin"):
                telemetry.count("hit_lanes", 7)
            telemetry.count("hit_lanes", 5)
        with telemetry.span("film.add"):
            telemetry.count("rays", torch.tensor(9))
    telemetry.count("hit_lanes", 100)   # outside a record: dropped
    names = [(s.name, s.index, s.seq, s.parent) for s in rec.spans]
    assert names == [("iteration", None, 0, None), ("pt.hit", 0, 1, 0),
                     ("sync.tmin", None, 2, 1), ("film.add", None, 3, 0)]
    assert {s.iteration for s in rec.spans} == {rec.iteration}
    assert all(s.start <= s.end for s in rec.spans)
    root = rec.spans[0]
    assert all(root.start <= s.start and s.end <= root.end
               for s in rec.spans)
    assert rec.total("hit_lanes") == 12 and rec.total("rays") == 9
    assert [s.name for s in rec.syncs()] == ["sync.tmin"]
    assert not rec.traced and rec.n == 1
    setup = telemetry.setup_spans()
    assert [(s.name, s.parent, s.iteration) for s in setup] == [
        ("scene.parse", None, None), ("scene.bvh", setup[0].seq, None)]
    for n in range(2, telemetry.RING + 50):
        with telemetry.iteration(n):
            with telemetry.span("pt.camera"):
                pass
    recs = telemetry.records()
    assert len(recs) == telemetry.RING
    assert [r.n for r in recs] == list(range(50, telemetry.RING + 50))
    assert len({r.iteration for r in recs}) == telemetry.RING
    ms, syncs = telemetry.summary(recs)
    assert list(ms) == ["iteration", "pt.camera"] and syncs == 0


def test_a_span_left_by_an_error_closes():
    with pytest.raises(ValueError):
        with telemetry.iteration(1):
            with telemetry.span("bdpt.step", 2):
                raise ValueError("inside")
    (rec,) = telemetry.records()
    assert [s.name for s in rec.spans] == ["iteration", "bdpt.step"]
    with telemetry.iteration(2) as rec2:
        pass
    assert [s.parent for s in rec2.spans] == [None]


def _render(path, integrator, spp=2):
    host = load_scene(str(path))
    host.width = host.height = SIZE
    r = Renderer(host, seed=3, integrator=integrator, device="cpu",
                 cache=False)
    for _ in range(spp):
        r.render_iteration()
    return r


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _render(tp.PORT_SCENES["cornell"], IntegratorType.BDPT, spp=1)
    _render(tp.PORT_SCENES["cornell"], IntegratorType.PT, spp=1)
    assert len(telemetry.records()) == 2
    assert not any(r.traced for r in telemetry.records())


def test_profiler_trace_names_the_phase(tmp_path):
    """Under a CPU profiler each span is a user_annotation of the trace,
    named with its index, and the benchmark's host chain at a point
    inside a phase names it."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.iteration(4) as rec:
            with telemetry.span("pt.hit", 3):
                x = x * 2.0
                time.sleep(0.01)   # the host between two ops
                x = x + 1.0
            with telemetry.span("film.add"):
                x = x.sum()
    assert rec.traced
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = {e["name"]: e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"}
    assert {"iteration", "pt.hit.3", "film.add"} <= set(notes)
    host = [e for e in events if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in trace.HOST_CATS]
    hit = notes["pt.hit.3"]
    chain = trace._host_chain(host, hit["ts"] + hit["dur"] / 2)
    assert chain.endswith("pt.hit.3") and "iteration" in chain


def _kinds(rec):
    return {s.name for s in rec.spans}


@pytest.mark.parametrize("case", ["pt", "bdpt", "pt_sorted"])
def test_render_records_every_phase(case, tmp_path):
    """PT (the CPU's wavefront; K2's route on the card records pt.camera
    and pt.fused instead), BDPT, and PT above DENSE_MAX prims, whose
    wavefront sorts."""
    if case == "pt_sorted":
        path, integrator = tp.write_knot_scene(tmp_path), IntegratorType.PT
    else:
        path = tp.PORT_SCENES["cornell"]
        integrator = IntegratorType[case.upper()]
    r = _render(path, integrator)
    assert (r.static.n_primitives > DENSE_MAX) == (case == "pt_sorted")
    setup = telemetry.setup_spans()
    assert {s.name for s in setup} == SETUP
    flat = [s for s in setup if s.name == "scene.flatten"][0]
    assert all(s.parent == flat.seq for s in setup if s.name == "scene.bvh")
    recs = telemetry.records()
    assert [rec.n for rec in recs] == [1, 2]
    depth = r.static.max_depth
    for rec in recs:
        spans = rec.spans
        assert spans[0].name == "iteration" and spans[0].parent is None
        assert all(s.parent == 0 for s in spans[1:]
                   if not s.name.startswith("sync."))
        if case == "bdpt":
            assert _kinds(rec) == {"iteration", "bdpt.start", "bdpt.hit",
                                   "bdpt.step", "bdpt.connect",
                                   "bdpt.shadow", "bdpt.finish", "film.add"}
            steps = [s.index for s in spans if s.name == "bdpt.hit"]
            assert steps == list(range(len(steps))) and 0 < len(steps) <= depth
        else:
            want = {"iteration", "pt.camera", "pt.hit", "pt.shade",
                    "pt.shadow", "film.add"}
            if case == "pt_sorted":
                want.add("pt.sort")
            assert _kinds(rec) == want
            assert [s.index for s in spans if s.name == "pt.hit"] == \
                list(range(depth + 1))
            assert [s.index for s in spans if s.name == "pt.shadow"] == \
                list(range(depth))
        # no device to sync with on the CPU
        assert rec.syncs() == []
        assert 0 < rec.total("rays") <= rec.total("hit_lanes")
    lanes = SIZE * SIZE * (2 if case == "bdpt" else 1)
    assert recs[0].counts["hit_lanes"][0] == lanes
    assert sum(rec.total("rays") for rec in recs) == int(r.rays)


def _small(monkeypatch):
    """The harness's cells with the window check held to 8,192
    (iteration, pixel) pairs, as its own CPU tests hold them."""
    real = cells.cell

    def small(name, root=cells.ROOT):
        spec = real(name, root)
        spec["workload"]["check"]["window_lanes"] = 8192
        return spec
    monkeypatch.setattr(cells, "cell", small)


@pytest.mark.parametrize("cell", ["cornell_box.pt", "cornell_box.bdpt"])
def test_readers_on_a_cpu_run_of_a_cell(cell, monkeypatch):
    _small(monkeypatch)
    res, info = run.run_cell(cell, SEED, 1.5, True, device="cpu", size=SIZE)
    listed = {m["name"] for m in cells.cell(cell)["per_layer"]}
    mine = [m for m in NEW_METRICS if m in listed]
    assert len(mine) == (6 if cell == "cornell_box.bdpt" else 3)
    got = {m: res["metrics"][m]["value"] for m in mine}
    assert got["host_issue_ms_per_spp"] > 0
    assert 0 < got["scene_parse_s"] < info["scene_build_s"]
    assert 0 < got["bvh_build_s"] < info["scene_build_s"]
    recs = [r for r in telemetry.records() if not r.traced and r.n > 1]
    assert recs and any(r.traced for r in telemetry.records())
    if cell == "cornell_box.bdpt":
        assert got["host_sync_ms_per_spp"] == 0.0
        assert got["host_syncs_per_spp"] == 0.0
        assert 0 < got["live_lane_share"] <= 1


def test_readers_find_nothing_without_spans():
    """What the parent of this module reads: no record, no value."""
    for m in NEW_METRICS:
        assert cells.reader(m)({}) is None, m


def test_cli_prints_spans(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(tp.REPO))
    r = subprocess.run(
        [sys.executable, "-m", "gpu_pathtracer_tpu_torch.run.cli",
         str(tp.PORT_SCENES["cornell"]), "--device", "cpu", "--size", "8",
         "--spp", "3", "--integrator", "bdpt"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    (line,) = [ln for ln in r.stdout.splitlines()
               if ln.startswith("[spans] ")]
    assert "over 3 spp" in line and "iteration " in line
    assert "bdpt.connect " in line and line.endswith("0 host syncs a spp")


def test_hit_calls_count_their_lanes():
    host = load_scene(str(tp.PORT_SCENES["cornell"]))
    host.width = host.height = 4
    r = Renderer(host, device="cpu", cache=False)
    ro = torch.zeros(10, 3)
    rd = torch.tensor([[0.0, 0.0, -1.0]]).expand(10, 3).contiguous()
    with telemetry.iteration(1) as rec:
        traverse.closest_prim(r.device_scene, r.static, ro, rd, 1e-4,
                              torch.full((10,), 1e30))
        traverse.intersect_any(r.device_scene, r.static, ro[:4], rd[:4],
                               1e-4, torch.full((4,), 1e30))
    assert rec.counts["hit_lanes"] == [10, 4]
