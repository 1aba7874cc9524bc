"""The port's bench: one row per main path, at a user's size, on the card.

    python -m gpu_pathtracer_tpu_torch.run.bench            # every row
    python -m gpu_pathtracer_tpu_torch.run.bench --rows cornell,knot
    python -m gpu_pathtracer_tpu_torch.run.bench --device cpu --size 16 \\
        --windows 1 --min-spp 1 --min-seconds 0 --rows cornell,vpt

The counterpart of the JAX package's bench.py. Each row renders a scene
of scenes/ through `Renderer` at --size^2 (1024) and depth 5, seed
--seed (0), on --device (cuda; the CPU is for the tests). A row:
- builds the scene (parse, BVH, tables; no BVH disk cache, so every
  run builds cold) and reports the host build seconds;
- renders one warm-up spp, which also builds and loads the kernels
  (under sharding also NCCL's first all_reduce), and holds it against
  the program run all-plain for the same iteration within PERF.md
  section 2's radiance limits (run/reference.py), giving "correct";
  VPT, LT and BDPT on a 65,536-lane slice: VPT's film and BDPT's
  per-lane radiance as the warm-up spp left them, LT's film and BDPT's
  splats from a separate pass over the kernels on the slice;
- times --windows windows (7), each of whole spp, at least --min-spp
  (2) and until at least --min-seconds (5 s; twice that for cornell,
  PERF.md section 6) have passed, on the host clock around work that
  ends in a device synchronise, tracing off: the median spp/s
  (iterations/s for SPPM and MLT) with the windows' min and max,
  Mrays/s from `Renderer.rays` over the same windows, and the peak
  device memory above what the renderer held before them;
- on CUDA, fails unless the windows launched the row's kernels and no
  other, and no plain version ran on a CUDA tensor;
- profiles one spp after the windows (torch.profiler): device ms/spp,
  the device's busy share (device ms/spp x the windows' median spp/s)
  and idle share (1 - busy; tracing slows the host, so the traced
  spp's own share is reported beside it), the five device operations
  that take the most time, each kernel of csrc/*.cu with its share,
  and the longest idle gaps with the host calls they sat in. Neither
  share is clamped: a busy share above BUSY_MAX (a device time that
  over-counts, or kernels that tracing slowed) flags the row.
`sppm_4card` runs under `torchrun --nproc-per-node 4` with
`Renderer(shard=True)`, one card a rank; with fewer than 4 CUDA devices
it prints -2.0 and says why.

As in bench.py, every row runs in its own subprocess, limited by what
is left of --budget seconds (1500); after each row one JSON line holding
the whole result so far is printed, so the last line is always
complete. A failed row prints -1.0 as its value, a row skipped for the
budget (none left, or its timeout cut to what was left ran out) or for
want of cards -2.0. The bench exits non-zero when a row
failed or was not correct; the last line lists flagged rows apart.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import torch

from gpu_pathtracer_tpu_torch.run import reference

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROW_TIMEOUT_S = 900    # a row's limit, cut to what is left of the budget
MIN_ROW_S = 30         # a row is not started with less budget left
DEPTH = 5              # every row's path depth (PERF.md section 2)
SPPM_PHOTONS = 100_000
BUSY_MAX = 1.05        # a busy share above this flags the row's profile
# the collectives' bootstrap sockets stay on the loopback interface
LOOPBACK = {"NCCL_SOCKET_IFNAME": "lo", "GLOO_SOCKET_IFNAME": "lo"}
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}


@dataclass(frozen=True)
class Row:
    name: str
    scene: str            # under --scenes
    integrator: str
    kernels: tuple        # what its windows launch (reference.kernel_stats)
    stands_for: tuple = ()   # the JAX bench.py rows it stands for
    sliced: bool = False  # held on a 65,536-lane slice
    cards: int = 1
    # windows last window_scale x --min-seconds: cornell, whose two
    # whole runs came within 5% only with 10 s windows (PERF.md
    # section 6)
    window_scale: float = 1.0


ROWS = (
    Row("cornell", "cornell_port/scene.json", "pt", ("pt_fused", "rng"),
        ("cornell", "integ_pt"), window_scale=2.0),
    Row("cornell_wavefront", "cornell_port/many_lights.json", "pt",
        ("dense_hit", "pt_shade", "rng")),
    Row("env", "env_port/scene.json", "pt", ("pt_fused", "rng")),
    Row("knot", "knot_port/scene.json", "pt",
        ("bvh8_walk", "pt_shade", "rng"),
        ("dragon_100k",)),
    Row("forest", "knot_port/forest.json", "pt",
        ("bvh8_walk", "pt_shade", "rng"),
        ("forest_1m",)),
    Row("blocked", "knot_port/blocked.json", "pt",
        ("blocked", "pt_shade", "rng")),
    Row("vpt", "smoke_port/scene.json", "vpt",
        ("dense_hit", "track", "vpt_shade", "vpt_tr_round", "vpt_finish",
         "rng"),
        ("integ_vpt",), sliced=True),
    Row("ao", "cornell_port/scene.json", "ao", ("dense_hit", "rng"),
        ("integ_ao",)),
    Row("lt", "cornell_port/scene.json", "lt", ("dense_hit", "rng"),
        ("integ_lt",), sliced=True),
    Row("bdpt", "cornell_port/scene.json", "bdpt",
        ("dense_hit", "bdpt_start", "bdpt_step", "bdpt_connect",
         "bdpt_finish"),
        ("integ_bdpt",), sliced=True),
    Row("ir", "cornell_port/scene.json", "ir", ("dense_hit", "rng"),
        ("integ_ir",)),
    Row("sppm", "cornell_port/scene.json", "sppm", ("dense_hit", "rng"),
        ("integ_sppm",)),
    Row("mlt", "cornell_port/scene.json", "mlt", ("pt_fused", "rng"),
        ("integ_mlt",)),
    Row("sppm_4card", "cornell_port/scene.json", "sppm", ("dense_hit", "rng"),
        cards=4),
)
ROW_BY_NAME = {row.name: row for row in ROWS}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _agreed(r, flag: bool) -> bool:
    """`flag` of this rank, or of any rank of a sharded render (every
    rank must render the same spp)."""
    if not r.shard.joined:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=r.device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t.item())


def windows(r, n: int, min_spp: int = 2, min_seconds: float = 1.5) -> list:
    """Time `n` windows of renderer `r`'s progressive render, each of
    whole spp, at least `min_spp` and until at least `min_seconds` have
    passed, on the host clock around work that ends in a device
    synchronise: [{"spp", "seconds", "rays"}] (rays from `Renderer.rays`,
    read outside the windows)."""
    out = []
    for _ in range(n):
        _sync(r.device)
        rays0 = int(r.rays)
        t0 = time.perf_counter()
        spp = 0
        while True:
            r.render_iteration()
            spp += 1
            if spp >= min_spp and _agreed(
                    r, time.perf_counter() - t0 >= min_seconds):
                break
        _sync(r.device)
        dt = time.perf_counter() - t0
        out.append({"spp": spp, "seconds": dt, "rays": int(r.rays) - rays0})
    return out


def window_summary(wins: list) -> dict:
    """The median spp/s of the windows with their min and max, each
    window's, the median Mrays/s, and the spp, rays and seconds in all."""
    rates = [w["spp"] / w["seconds"] for w in wins]
    mrays = [w["rays"] / w["seconds"] / 1e6 for w in wins]
    return {"value": statistics.median(rates), "min": min(rates),
            "max": max(rates), "rates": rates,
            "mrays_s": statistics.median(mrays),
            "windows": len(wins), "spp": sum(w["spp"] for w in wins),
            "rays": sum(w["rays"] for w in wins),
            "seconds": sum(w["seconds"] for w in wins)}


def port_kernels() -> list:
    """Names of the __global__ functions in the port's csrc/*.cu."""
    names = set()
    for path in glob.glob(os.path.join(REPO, "gpu_pathtracer_tpu_torch",
                                       "csrc", "*.cu")):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|"
                r"\([^()]*\))*\)\s+)?(\w+)", f.read()))
    return sorted(names)


def _host_chain(host: list, t: float, tid=None) -> str:
    """The host events (cpu_op, CUDA runtime) open at time t, outermost
    first, the innermost three joined by " > " ("python" if none)."""
    open_ = sorted((e for e in host if e["ts"] <= t <= e["ts"] + e["dur"]
                    and (tid is None or e.get("tid") == tid)),
                   key=lambda e: (e["ts"], -e["dur"]))
    return " > ".join(e["name"][:60] for e in open_[-3:]) or "python"


def trace_summary(events: list, wall_s: float, spp: int, kernels: list,
                  top: int = 5, n_gaps: int = 5) -> dict:
    """What one profiled window of `spp` spp that took `wall_s` seconds
    shows, from its Chrome trace events: device ms/spp (the union of the
    device's kernel, copy and set intervals), the idle share of the
    window, the `top` device operations by time, each kernel named in
    `kernels` with its share, and the `n_gaps` longest idle gaps between
    device intervals, each with the host calls open at its middle and
    the host call that launched the work ending it."""
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

    def entry(name, us, count):
        return {"name": name[:100], "ms_per_spp": us / 1e3 / spp,
                "share": us / max(busy_us, 1e-9), "per_spp": count / spp}

    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    mine = []
    for k in kernels:
        hits = [(us, c) for name, (us, c) in by_name.items()
                if re.search(rf"\b{k}\b", name)]
        if hits:
            mine.append(entry(k, sum(u for u, _ in hits),
                              sum(c for _, c in hits)))
    gaps = sorted(((start - end, end, nxt) for (_, end, _), (start, _, nxt)
                   in zip(merged, merged[1:])), key=lambda g: -g[0])
    out_gaps = []
    for us, end, nxt in gaps[:n_gaps]:
        launch = launches.get(nxt.get("args", {}).get("correlation"))
        tid = launch.get("tid") if launch else None
        out_gaps.append({
            "ms": us / 1e3, "during": _host_chain(host, end + us / 2, tid),
            "next": (_host_chain(host, launch["ts"], tid) if launch
                     else nxt["name"][:60])})
    return {"device_ms_per_spp": busy_us / 1e3 / spp,
            "traced_wall_ms_per_spp": wall_s * 1e3 / spp,
            "traced_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "top_ops": [entry(name, us, c) for name, (us, c) in ranked[:top]],
            "port_kernels": mine, "gaps": out_gaps}


def profile_spp(r, spp: int = 1, top: int = 5) -> dict | None:
    """`spp` spp of renderer `r` under torch.profiler (CPU and CUDA
    activities) summarised by `trace_summary` (its `top` device
    operations); every rank of a sharded render renders them, rank 0
    alone profiles and returns the summary."""
    from torch.profiler import ProfilerActivity, profile
    _sync(r.device)
    if r.shard.rank != 0:
        for _ in range(spp):
            r.render_iteration()
        _sync(r.device)
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(spp):
            r.render_iteration()
        _sync(r.device)
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return trace_summary(events, wall, spp, port_kernels(), top)


def device_shares(prof: dict, spp_s: float) -> list:
    """Add to profile summary `prof` the device's busy share of an
    untraced spp (device ms/spp x `spp_s`, the untraced spp/s) and its
    idle share (1 - busy), unclamped; return the flags they raise (a
    busy share above BUSY_MAX)."""
    busy = prof["device_ms_per_spp"] * spp_s / 1e3
    prof["busy_share"], prof["idle_share"] = busy, 1.0 - busy
    if busy <= BUSY_MAX:
        return []
    return [f"busy share {busy:.4f} > {BUSY_MAX}: the traced spp's device "
            "time exceeds the untraced wall time"]


def _renderer(row: Row, opts, device, shard: bool):
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    path = os.path.join(opts.scenes, row.scene)
    if not os.path.exists(path):
        raise FileNotFoundError(f"row {row.name}: no scene {path}")
    t0 = time.perf_counter()
    host = load_scene(path)
    host.width = host.height = opts.size
    r = Renderer(host, seed=opts.seed, device=device, cache=False,
                 integrator=IntegratorType[row.integrator.upper()],
                 max_depth=DEPTH, shard=shard,
                 photons_per_iteration=SPPM_PHOTONS
                 if row.integrator == "sppm" else None)
    _sync(device)
    return r, time.perf_counter() - t0


def run_row(row: Row, opts) -> dict | None:
    """Measure one row in this process (under torchrun, as one rank of
    its sharded render): its result, or None on a rank other than 0.
    Raises when the row cannot run, or on CUDA when its windows launched
    another kernel than its own or a plain version."""
    from gpu_pathtracer_tpu_torch.parallel import dist
    from gpu_pathtracer_tpu_torch.run.renderer import resolve_device
    device = resolve_device(opts.device)
    shard = row.cards > 1
    if shard:   # one card a rank, NCCL (gloo on CPU ranks)
        if device.type == "cuda":
            device = torch.device("cuda", dist.local_rank())
            torch.cuda.set_device(device)
        dist.init("nccl" if device.type == "cuda" else "gloo")
    try:
        return _measure(row, opts, device, shard)
    finally:
        if shard:
            torch.distributed.destroy_process_group()


def _measure(row: Row, opts, device, shard: bool) -> dict | None:
    cuda = device.type == "cuda"
    r, build_s = _renderer(row, opts, device, shard)
    lead = r.shard.rank == 0
    # a hybrid program's per-lane radiance, apart from its splats
    keep = (reference.tile_radiance(r) if row.sliced and r.kind == "hybrid"
            else contextlib.nullcontext())
    t0 = time.perf_counter()
    with keep as tile_li:
        r.render_iteration()
        _sync(device)
    warmup_s = time.perf_counter() - t0

    checks = []
    if lead:
        lanes = (reference.slice_ids(r.width * r.height, device)
                 if row.sliced else None)
        checks = [reference.held(a, b, what) for what, a, b in
                  reference.plain_reference(row.integrator, r, lanes,
                                            tile_li)]
    del tile_li
    finite = bool(torch.isfinite(r.acc).all())
    wrong = _agreed(r, not (finite and all(c["ok"] for c in checks)))
    stats = reference.kernel_stats()
    _sync(device)
    if cuda:
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    reference.reset_counts(*stats.values())
    wins = windows(r, opts.windows, opts.min_spp,
                   opts.min_seconds * row.window_scale)
    launches = {k: st.launches for k, st in stats.items()}
    plain = sum(st.plain_cuda for st in stats.values())
    peak_mb = resident_mb = None
    if cuda:
        peak_mb = (torch.cuda.max_memory_allocated(device) - base) / 2**20
        resident_mb = base / 2**20
        others = {k: n for k, n in launches.items()
                  if n and k not in row.kernels}
        idle = [k for k in row.kernels if launches[k] == 0]
        if idle or others or plain:
            raise RuntimeError(
                f"row {row.name}: launches {launches}, plain-version calls "
                f"on CUDA {plain}; its windows must launch {row.kernels} "
                "and no other kernel or plain version")
    prof = profile_spp(r) if cuda else None
    if not lead:
        return None
    summary = window_summary(wins)
    flags = [] if prof is None else device_shares(prof, summary["value"])
    return {
        **summary,
        "unit": ("iterations/s" if row.integrator in ("sppm", "mlt")
                 else "spp/s"),
        "correct": not wrong, "finite": finite, "checks": checks,
        "scene": row.scene, "integrator": row.integrator,
        "kernels": list(row.kernels), "stands_for": list(row.stands_for),
        "cards": r.shard.world, "size": opts.size,
        "depth": r.static.max_depth, "seed": opts.seed,
        "build_s": build_s, "warmup_s": warmup_s, "flags": flags,
        "launches_per_spp": {k: launches[k] / summary["spp"]
                             for k in row.kernels},
        "peak_mb": peak_mb, "resident_mb": resident_mb,
        "profile": prof, "device": str(device)}


def _options(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(r.name for r in ROWS),
                    help="comma-separated rows (default every row)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--windows", type=int, default=7)
    ap.add_argument("--min-spp", type=int, default=2)
    ap.add_argument("--min-seconds", type=float, default=5.0)
    ap.add_argument("--budget", type=float, default=1500.0,
                    help="seconds for the whole bench")
    ap.add_argument("--scenes", default=os.path.join(REPO, "scenes"),
                    help="the scenes directory the rows' paths are under")
    ap.add_argument("--row", default=None, help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    opts.scenes = os.path.abspath(opts.scenes)
    return opts


def _row_args(opts) -> list:
    return ["--device", opts.device, "--size", str(opts.size),
            "--seed", str(opts.seed), "--windows",
            str(opts.windows), "--min-spp", str(opts.min_spp),
            "--min-seconds", str(opts.min_seconds), "--scenes", opts.scenes]


def _spawn(row: Row, opts, timeout: float) -> dict:
    """Run `row` in a subprocess (under torchrun for more than one card)
    within `timeout` seconds: its result, or -1.0 with the reason. A
    timeout below ROW_TIMEOUT_S is what was left of the budget: the row
    is then skipped (-2.0) when it expires."""
    cmd = [sys.executable]
    if row.cards > 1:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                f"--nproc-per-node={row.cards}"]
    cmd += ["-m", "gpu_pathtracer_tpu_torch.run.bench", "--row", row.name,
            *_row_args(opts)]
    path = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=REPO, start_new_session=True,
                         env=dict(os.environ, PYTHONPATH=path, **LOOPBACK))
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        sys.stderr.write(err[-4000:])
        if timeout < ROW_TIMEOUT_S:
            return {"value": -2.0, "why": f"budget: timed out after the "
                    f"{timeout:.0f} s left"}
        return {"value": -1.0, "why": f"timed out after {timeout:.0f} s"}
    sys.stderr.write(err[-4000:])
    found = [ln[4:] for ln in out.splitlines() if ln.startswith("ROW ")]
    if p.returncode != 0 or not found:
        lines = [ln for ln in err.splitlines() if ln.strip()]
        return {"value": -1.0, "why": f"exit {p.returncode}: "
                + (lines[-1][:300] if lines else "no output")}
    return json.loads(found[-1])


def emit(result: dict) -> None:
    """Print the whole result so far as one JSON line."""
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    opts = _options(argv)
    if opts.row is not None:
        res = run_row(ROW_BY_NAME[opts.row], opts)
        if res is not None:
            print("ROW " + json.dumps(res), flush=True)
        return 0
    t_start = time.time()
    names = [n for n in opts.rows.split(",") if n]
    unknown = [n for n in names if n not in ROW_BY_NAME]
    if unknown:
        sys.exit(f"unknown rows {unknown}: the rows are "
                 f"{[r.name for r in ROWS]}")
    from gpu_pathtracer_tpu_torch.run.renderer import resolve_device
    device = resolve_device(opts.device)
    cuda = device.type == "cuda"
    cards = torch.cuda.device_count() if cuda else 0
    result = {
        "metric": f"spp/s, cornell_port PT {opts.size}x{opts.size} depth "
                  f"{DEPTH} through the path-trace megakernel (K2)",
        "value": -1.0, "unit": "spp/s",
        "card": card_line() if cuda else "cpu",
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cards},
        "size": opts.size, "depth": DEPTH, "seed": opts.seed,
        "windows": opts.windows, "min_spp": opts.min_spp,
        "min_seconds": opts.min_seconds, "budget_s": opts.budget,
        "rows": {}}
    emit(result)
    if cuda:   # every kernel once, one nvcc each at once, before the rows
        from gpu_pathtracer_tpu_torch import kernels
        kernels.build(["dense", "pt_fused", "blocked", "bvh8_walk", "track",
                       "rng", "pt_shade", "vpt_shade", "bdpt"])
    for name in names:
        row = ROW_BY_NAME[name]
        left = opts.budget - (time.time() - t_start)
        if row.cards > 1 and row.cards > cards:
            res = {"value": -2.0, "why": f"needs {row.cards} CUDA devices, "
                   f"this machine has {cards}"}
        elif left < MIN_ROW_S:
            res = {"value": -2.0, "why": f"budget: {left:.0f} s left"}
        else:
            res = _spawn(row, opts, min(ROW_TIMEOUT_S, left))
        result["rows"][name] = res
        if name == "cornell":
            result["value"] = res["value"]
        print(f"# {name}: {res['value']:.4f} "
              f"{res.get('unit', '')} {res.get('why', '')}".rstrip(),
              file=sys.stderr, flush=True)
        emit(result)
    result["total_s"] = time.time() - t_start
    bad = [n for n, res in result["rows"].items()
           if res["value"] == -1.0 or res.get("correct") is False]
    result["failed"] = bad
    result["flagged"] = [n for n, res in result["rows"].items()
                         if res.get("flags")]
    emit(result)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
