"""The forest configuration (benchmark/configs/forest_1m.json: ten
instances of the 100k-triangle knot in the room, 1,000,012 prims) on the
CPU at 16 x 16, with the 16k-triangle knot standing in for the 100k one
(160,012 prims), so that the benchmark's brute-force reference stays
affordable here.

The port flattens it instanced, as it does on a card (on the CPU its
default is flat), and its all-plain PT estimator (the PyTorch versions
of every kernel over the plain instanced walk, geom/packet.py::
walk_torch) is held to the reference (benchmark/reference/) on a sample
of pixels, and to the port's own flat table on every pixel: the
instanced walk maps each ray into its BLAS frame (geom/tlas.py), where
t equals the world t only up to rounding, and then gives each closest
hit the t of its world record, so the two films are bit-equal. Then the
set-up spans of the two-level build, and the readers of the cell's
three per-layer metrics on a CPU render.
"""

import functools
import json
import os

import pytest
import torch

import torch_parity as tp
from benchmark import cells, check
from benchmark.reference import pt as ref_pt
from benchmark.reference import scene as ref_scene
from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators import pt
from gpu_pathtracer_tpu_torch.run import renderer as renderer_mod
from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
from gpu_pathtracer_tpu_torch.scene.parse import load_scene

SIZE = 16
SEED = 2**31 + 3   # larger than 32 signed bits hold
PIXELS = 64        # of the 256, for the reference (~0.3 s a lane a core)
KNOT_16K = tp.REPO / "scenes" / "knot_port" / "knot_16k.obj"


def _forest_16k(tmp_path) -> str:
    """forest_1m.json with its meshes at absolute paths and knot_16k.obj
    in knot_100k.obj's place."""
    spec = cells.cell("forest_1m.pt")
    doc = json.load(open(spec["config_path"]))
    base = os.path.dirname(spec["config_path"])
    for unit in doc["scene"] + doc["light"]:
        mesh = os.path.normpath(os.path.join(base, unit["mesh"]))
        unit["mesh"] = str(KNOT_16K) if mesh.endswith("knot_100k.obj") \
            else mesh
    path = tmp_path / "forest_16k.json"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.fixture(scope="module")
def forest(tmp_path_factory):
    """(scene file, host scene at SIZE, the port's instanced flatten)."""
    path = _forest_16k(tmp_path_factory.mktemp("forest"))
    host = load_scene(path)
    host.width = host.height = SIZE
    td, ts = flatten_scene(host, "cpu", instancing=True, cache=False)
    return path, host, td, ts


def _film(td, ts, it, pix):
    return pt.wavefront(td, ts, SEED, it, pix % SIZE, pix // SIZE,
                        plain=True)


def test_configuration_is_ten_instances_and_the_room(forest):
    """The configuration's ten knot entries and the static group of 12
    triangles; the port's flatten of the small forest is instanced with
    11 instances (the static group first) and 160,012 prims."""
    doc = json.load(open(cells.cell("forest_1m.pt")["config_path"]))
    knots = [u for u in doc["scene"] if u["mesh"].endswith("knot_100k.obj")]
    assert len(knots) == 10 and len(doc["scene"]) + len(doc["light"]) == 16
    assert (doc["screen_width"], doc["screen_height"], doc["maxDepth"]) \
        == (1024, 1024, 5) and doc["reduced"] == []
    _, _, _, ts = forest
    assert traverse.regime(ts) == "instanced"
    assert ts.bvh8_n_inst == 11 and ts.n_primitives == 160012


@pytest.mark.parametrize("it", [1, 4])
def test_instanced_port_matches_reference(it, forest):
    """The all-plain instanced estimator against the reference at
    iteration `it`, on PIXELS pixels drawn from the seed: no pixel off
    by more than the check's tolerance, the sums within 1e-6."""
    path, _, td, ts = forest
    ref = ref_scene.load(path, "cpu", size=SIZE)
    pix = check.pixels(SEED, SIZE * SIZE, PIXELS).to(torch.int32)
    want = _film(td, ts, it, pix)
    got = ref_pt.radiance(ref, SEED, torch.full((PIXELS,), it), pix)
    assert check.off_share(got, want) == 0.0
    assert check.sum_gap(got, want) < 1e-6


def test_instanced_port_matches_flat_port(forest):
    """The instanced walk, which gives a closest hit its world t, and the
    flat table's walk give the same film, bit for bit, at iterations 1
    and 4 on every pixel."""
    _, host, td, ts = forest
    fd, fs = flatten_scene(host, "cpu", instancing=False, cache=False)
    assert fs.bvh8_n_inst == 0 and traverse.regime(fs) == "bvh8"
    pix = torch.arange(SIZE * SIZE, dtype=torch.int32)
    for it in (1, 4):
        inst, flat = _film(td, ts, it, pix), _film(fd, fs, it, pix)
        assert torch.equal(inst, flat)


def test_tlas_spans_nest_in_bvh_spans(forest, monkeypatch):
    """With instancing, each "scene.bvh" span holds one "scene.tlas" span
    (the plan with its BLAS builds, the instanced table), which
    tlas_build_s sums; bvh_build_s still sums "scene.bvh" alone. A flat
    flatten opens no "scene.tlas"."""
    monkeypatch.setattr(telemetry, "_R", telemetry._Recorder())
    path = forest[0]
    host = load_scene(path)
    flatten_scene(host, "cpu", instancing=True, cache=False)
    spans = telemetry.setup_spans()
    bvh = {s.seq: s for s in spans if s.name == "scene.bvh"}
    tlas = [s for s in spans if s.name == "scene.tlas"]
    assert len(bvh) == 2 and len(tlas) == 2
    assert sorted(s.parent for s in tlas) == sorted(bvh)
    for s in tlas:
        outer = bvh[s.parent]
        assert outer.start <= s.start <= s.end <= outer.end
    read = {m: cells.reader(m) for m in ("tlas_build_s", "bvh_build_s")}
    assert read["tlas_build_s"]({}) == sum(s.ns for s in tlas) / 1e9
    assert read["bvh_build_s"]({}) == sum(s.ns for s in bvh.values()) / 1e9
    load_scene(path)
    flatten_scene(host, "cpu", instancing=False, cache=False)
    assert read["tlas_build_s"]({}) is None
    assert read["bvh_build_s"]({}) > 0


def test_walk_metrics_read_the_spp_counters(forest, monkeypatch):
    """blas_walks_per_ray and instance_walk_share on a CPU render of the
    small forest, flattened instanced as on a card, read the window's
    counters: a ray begins at least one BLAS walk and walks at most the
    instances it enters. On a flat scene they read nothing."""
    monkeypatch.setattr(telemetry, "_R", telemetry._Recorder())
    monkeypatch.setattr(renderer_mod, "flatten_scene", functools.partial(
        flatten_scene, instancing=True))
    host = load_scene(forest[0])
    host.width = host.height = 8
    r = renderer_mod.Renderer(host, seed=SEED, device="cpu", cache=False)
    assert r.static.bvh8_n_inst == 11
    r.render(3)
    read = {m: cells.reader(m) for m in ("blas_walks_per_ray",
                                         "instance_walk_share")}
    recs = [x for x in telemetry.records() if x.n > 1]
    walks = sum(x.total("blas_walks") for x in recs)
    assert read["blas_walks_per_ray"]({}) == walks / sum(
        x.total("rays") for x in recs)
    assert read["instance_walk_share"]({}) == walks / sum(
        x.total("inst_entered") for x in recs)
    assert 1.0 <= read["blas_walks_per_ray"]({}) < 11.0
    assert 0.0 < read["instance_walk_share"]({}) <= 1.0
    telemetry.reset()
    flat = renderer_mod.Renderer(str(tp.write_knot_scene(
        tp.pathlib.Path(forest[0]).parent)), device="cpu", cache=False)
    flat.render(2)
    assert flat.static.bvh8_n_inst == 0
    assert all(read[m]({}) is None for m in read)
