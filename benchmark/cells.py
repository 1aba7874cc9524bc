"""What the benchmark runs, found by name: BENCHMARK.json and the data files.

A cell (an entry of BENCHMARK.json's "workloads") names a configuration
and a traffic mix; each lives in a file of its own, found by its name:

- benchmark/configs/<config>.json: the scene file as it is rendered
  (film size, depth, camera, materials, meshes), with its source, the
  keys `reduced` from the source and the sizes `assumed`;
- benchmark/traffic/<traffic>.json: the integrator and the progressive
  loop the generator (benchmark/loop.py) drives;
- benchmark/workloads/<cell>.json: the CUDA sources the cell's route
  builds, the kernels its window is expected to launch, the spp the
  traced run profiles, and its output check with its limits;
- benchmark/metrics/<metric>.py: one reader a metric, `read(summary)`
  -> a number, or None where the run has nothing for it to read.

A later cell, configuration, traffic mix or metric is a new file and a
new entry of BENCHMARK.json; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return name


def _read(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    """BENCHMARK.json of the checkout at `root`."""
    return _read(root, "BENCHMARK.json")


def cell(name: str, root: str = ROOT) -> dict:
    """Everything one cell needs: its BENCHMARK.json entry ("entry"), its
    configuration's path ("config_path") and contents ("config"), its
    traffic mix ("traffic"), its workload file ("workload"), and the
    metrics that it reports, end-to-end ("end_to_end") and per layer
    ("per_layer"), as BENCHMARK.json lists them."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if _name("workload", name) not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(entries)}")
    entry = entries[name]
    here = os.path.join(root, "benchmark")
    config_path = os.path.join(here, "configs",
                               _name("config", entry["config"]) + ".json")

    def mine(metrics):
        return [m for m in metrics
                if name in m.get("workloads", [name])]

    return dict(
        entry=entry, config_path=config_path, config=_read(config_path),
        traffic=_read(here, "traffic",
                      _name("traffic", entry["traffic"]) + ".json"),
        workload=_read(here, "workloads", name + ".json"),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]))


def reader(metric: str, root: str = ROOT):
    """The `read` function of benchmark/metrics/<metric>.py."""
    path = os.path.join(root, "benchmark", "metrics",
                        _name("metric", metric) + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics(specs: list, summary: dict) -> dict:
    """{name: {"value", "unit"}} of every metric in `specs` whose reader
    finds something in `summary`."""
    out = {}
    for m in specs:
        value = reader(m["name"])(summary)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
