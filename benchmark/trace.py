"""Reading a profiled stretch of spp: device time, kernels, idle gaps.

Copied from the program's bench (gpu_pathtracer_tpu_torch/run/bench.py:
`trace_summary`, `device_shares`, `port_kernels`, `_host_chain`) so that
the yardstick stays put while the program changes; what it adds: the
device ops' count, the time of the ops that are no kernel of the
program's csrc/ (PyTorch's own kernels, copies and sets: the glue), and
the breakdown lists of the result line.
"""

from __future__ import annotations

import glob
import json
import os
import re
import tempfile
import time

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
BUSY_MAX = 1.05   # a busy share above this is flagged
TOP = 10


def port_kernels(csrc: str) -> list:
    """Names of the __global__ functions in the .cu files of `csrc`."""
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu")):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|"
                r"\([^()]*\))*\)\s+)?(\w+)", f.read()))
    return sorted(names)


def _host_chain(host: list, t: float, tid=None) -> str:
    """The host events open at time t, outermost first, the innermost
    three joined by " > " ("python" if none)."""
    open_ = sorted((e for e in host if e["ts"] <= t <= e["ts"] + e["dur"]
                    and (tid is None or e.get("tid") == tid)),
                   key=lambda e: (e["ts"], -e["dur"]))
    return " > ".join(e["name"][:60] for e in open_[-3:]) or "python"


def summary(events: list, wall_s: float, spp: int, kernels: list) -> dict:
    """What `spp` profiled spp that took `wall_s` seconds show, from their
    Chrome trace events: the union of the device's kernel, copy and set
    intervals (busy), the device ops a spp, each kernel of `kernels` (the
    program's csrc/) in ms a spp, the other ops' ms a spp (glue), the TOP
    device ops by time and the TOP longest idle gaps, each with the host
    calls open at its middle and the call that launched the work ending
    it."""
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and str(e.get("cat", "")).lower() in DEVICE_CATS),
                 key=lambda e: e["ts"])
    host = [e for e in events if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in HOST_CATS]
    launches = {e["args"]["correlation"]: e for e in host
                if "correlation" in e.get("args", {})
                and str(e.get("cat", "")).lower() != "cpu_op"}
    merged = []   # [start, end, first event]
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b, e])
    busy_us = sum(b - a for a, b, _ in merged)
    by_name = {}
    for e in dev:
        us, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (us + e["dur"], count + 1)
    mine, glue_us = {}, 0.0
    for name, (us, count) in by_name.items():
        hits = [k for k in kernels if re.search(rf"\b{k}\b", name)]
        if not hits:
            glue_us += us
        for k in hits:
            ms, c = mine.get(k, (0.0, 0))
            mine[k] = (ms + us / 1e3, c + count)
    gaps = sorted(((start - end, end, nxt) for (_, end, _), (start, _, nxt)
                   in zip(merged, merged[1:])), key=lambda g: -g[0])
    idle = []
    for us, end, nxt in gaps[:TOP]:
        launch = launches.get(nxt.get("args", {}).get("correlation"))
        tid = launch.get("tid") if launch else None
        during = _host_chain(host, end + us / 2, tid)
        after = _host_chain(host, launch["ts"], tid) if launch \
            else nxt["name"][:60]
        idle.append([f"{during} | next: {after}"[:200], us / 1e6])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "spp": spp, "busy_s": busy_us / 1e6, "window_s": wall_s,
        "device_ms_per_spp": busy_us / 1e3 / spp,
        "ops_per_spp": len(dev) / spp,
        "glue_ms_per_spp": glue_us / 1e3 / spp,
        "kernels": {k: {"ms_per_spp": ms / spp, "per_spp": c / spp}
                    for k, (ms, c) in mine.items()},
        "device_ops": [[name[:200], us / 1e6] for name, (us, _) in
                       ranked[:TOP]],
        "idle_gaps": idle}


def idle_share(device_ms_per_spp: float, spp_s: float) -> tuple:
    """1 - the traced device ms a spp x the untraced spp/s, unclamped, and
    the flag a busy share over BUSY_MAX raises (None if none)."""
    busy = device_ms_per_spp * spp_s / 1e3
    flag = None if busy <= BUSY_MAX else (
        f"busy share {busy:.4f} > {BUSY_MAX}: the traced spp's device time "
        "exceeds the untraced wall time")
    return 1.0 - busy, flag


def profile(step, n: int, sync, kernels: list) -> dict:
    """`n` calls of `step` under torch.profiler (CPU and CUDA
    activities), synchronised by `sync`, read by `summary`."""
    from torch.profiler import ProfilerActivity, profile as prof_
    sync()
    with prof_(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summary(events, wall, n, kernels)
