"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 -m benchmark.run --workload cornell_box.pt --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout on a machine with the CUDA cards the
cell asks for (BENCHMARK.json). Set-up, counted from the start of the
process: the cell's CUDA sources built or loaded from build/, the scene
parsed and flattened into a Renderer, one warm-up frame. The window
then renders frames of the cell's traffic for --seconds on the host
clock. After it: the kernels launched, the device's peak memory, with
--trace 1 a few frames under torch.profiler, then the check of the
window's output against the reference (benchmark/check.py), once the
program's state is freed. The last line of standard output is the
result, with --trace 0 the cell's end-to-end metrics, with --trace 1
its per-layer metrics, each computed by its reader in
benchmark/metrics/. Each number compared is printed with its limit as
the last lines of standard error and under the result's last key.

Exits non-zero without a result when CUDA or the cell's cards are
missing (no fallback to the CPU), when the program or the benchmark's
files are missing, or when the process has loaded JAX or the JAX
package by the end of the window.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()   # the set-up clock starts with the process

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from benchmark import cells, check, loop, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_pathtracer_tpu")
PORT = "gpu_pathtracer_tpu_torch"


def forbidden_modules() -> list:
    """Top-level names in sys.modules, taken whole, that the benchmark
    must not have loaded."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fix_caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["GPT_TORCH_CACHE_DIR"] = os.path.join(build, "bvh_cache")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unreadable: {e}"


def _gather(x, pix):
    return x[pix.to(x.device)].cpu()


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device="cuda", size=None, root=cells.ROOT, start=T0) -> tuple:
    """One run of cell `name`: (its result line as a dict, the numbers
    compared last, under "checks"; what the run measured besides). `size`
    (tests only) renders size x size on `device`."""
    from benchmark.reference import scene as ref_scene_mod
    spec = cells.cell(name, root)
    work, traffic = spec["workload"], spec["traffic"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    info = {}
    t = time.perf_counter()
    if cuda:
        from gpu_pathtracer_tpu_torch import kernels
        kernels.build(work["sources"])
    info["kernel_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    r = loop.renderer(spec["config_path"], traffic, seed, device, size)
    loop.sync(device)
    info["scene_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loop.frame(r, traffic)
    loop.sync(device)
    info["warmup_spp_s"] = time.perf_counter() - t

    from gpu_pathtracer_tpu_torch.run.reference import (
        kernel_stats, reset_counts,
    )
    chk = work["check"]
    n_pix = r.width * r.height
    iter_pix = check.pixels(seed, n_pix, chk["iteration_pixels"])
    win_pix = check.pixels(seed + 1, n_pix, chk["window_pixels"]) \
        if chk["window_pixels"] else None
    keep = set(check.frames(seed, chk["frames"], chk["first_frames"]))
    stats = kernel_stats()
    reset_counts(*stats.values())
    rays0, it0 = int(r.rays), r.iteration
    acc0 = _gather(r.acc, win_pix) if win_pix is not None else None
    info["setup_s"] = time.perf_counter() - start
    n, elapsed, frame_ms, kept = loop.window(r, traffic, seconds, keep)
    info.update(spp=r.iteration - it0, frames=n, window_s=elapsed,
                frame_ms=frame_ms,
                window_rays_per_spp=(int(r.rays) - rays0)
                / max(r.iteration - it0, 1),
                launches_per_spp={k: st.launches / max(r.iteration - it0, 1)
                                  for k, st in stats.items() if st.launches},
                plain_calls=sum(st.plain_cuda for st in stats.values()),
                forbidden=forbidden_modules(),
                memory_peak_bytes=torch.cuda.max_memory_allocated(device)
                if cuda else 0)
    outputs = {"iters": [(its[0], iter_pix, _gather(after - before, iter_pix))
                         for its, before, after in kept.values()
                         if len(its) == 1]}
    if win_pix is not None:
        its = list(range(it0 + 1, r.iteration + 1))
        pix = check.window_sample(win_pix, len(its), chk["window_lanes"])
        outputs["window"] = (its, pix,
                             _gather(r.acc, pix) - acc0[:pix.shape[0]])
    if traced:
        rays1 = int(r.rays)
        kernels_ = trace.port_kernels(os.path.join(
            os.path.dirname(sys.modules[PORT].__file__), "csrc"))
        info["trace"] = trace.profile(lambda: loop.frame(r, traffic),
                                      work["trace_frames"],
                                      lambda: loop.sync(device), kernels_)
        info["trace"]["rays_per_spp"] = (int(r.rays) - rays1) / (
            work["trace_frames"] * traffic["spp_per_frame"])
    integrator = traffic["integrator"]
    del r, kept, stats
    if cuda:
        torch.cuda.empty_cache()
    ref = ref_scene_mod.load(spec["config_path"], device, size=size)
    numbers, info["reference_s"] = check.compare(outputs, ref, integrator,
                                                 seed, chk)
    numbers.append(("plain_calls", float(info["plain_calls"]), 0.0))
    summary = dict(info, workload=work, traffic=traffic)
    specs = spec["per_layer"] if traced else spec["end_to_end"]
    result = {
        "correct": check.passed(numbers),
        "attempted": info["spp"], "failed": 0,
        "metrics": cells.metrics(specs, summary),
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else device.type,
                   "count": 1,
                   "memory_peak_bytes": info["memory_peak_bytes"]}}
    if traced:
        tr = info["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in numbers}
    return result, info


def _options(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    opts = _options(argv)
    root = os.getcwd()
    fix_caches(root)
    spec = cells.cell(opts.workload, root)
    chips = int(spec["entry"]["chips"])
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this benchmark measures "
              "the CUDA cards and has no CPU fallback", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"cell {opts.workload} needs {chips} CUDA device(s), this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    res, info = run_cell(opts.workload, opts.seed, opts.seconds,
                         bool(opts.trace), root=root)
    found = sorted(set(info["forbidden"]) | set(forbidden_modules()))
    if found:
        print(f"the process loaded {found} (sys.modules, whole top-level "
              "names): no result", file=sys.stderr)
        return 3
    print(f"launches per spp in the window: {info['launches_per_spp']}",
          file=sys.stderr)
    if "trace" in info:
        _, flag = trace.idle_share(info["trace"]["device_ms_per_spp"],
                                   info["spp"] / info["window_s"])
        if flag:
            print(f"flagged: {flag}", file=sys.stderr)
    print("run: " + json.dumps({k: v for k, v in info.items()
                                if k != "frame_ms"}), file=sys.stderr)
    print(f"set-up {info['setup_s']:.4f} s (kernels "
          f"{info['kernel_load_s']:.4f}, scene {info['scene_build_s']:.4f}, "
          "warm-up "
          f"{info['warmup_spp_s']:.4f}); window {info['spp']} spp in "
          f"{info['window_s']:.4f} s; reference {info['reference_s']:.4f} s",
          file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
