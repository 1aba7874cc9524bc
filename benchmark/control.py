"""The check's control: the reference in bfloat16 in the program's place.

    python3 -m benchmark.control --workload cornell_box.pt \\
        --seeds 11,12,13 --spp 7500

For each seed, the outputs a run of the cell compares (its check frames'
film changes, its window's sums over `--spp` iterations after the
warm-up) are rendered by the reference in bfloat16, the precision below
the float32 the configurations state, and held to the float32 reference
by the cell's own numbers and limits (benchmark/check.py). Every number
the control passes is a number that cannot tell a lower precision from
the program. One JSON line a seed. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from benchmark import cells, check
from benchmark.reference import scene as ref_scene_mod


def control_outputs(spec, seed: int, spp: int, device, size=None,
                    dtype=torch.bfloat16) -> dict:
    """The outputs a run at `seed` with `spp` window spp would hand the
    check, rendered by the reference in `dtype`."""
    chk = spec["workload"]["check"]
    integrator = spec["traffic"]["integrator"]
    low = ref_scene_mod.load(spec["config_path"], device, dtype, size)
    n_pix = low.width * low.height
    lanes = chk["reference_lanes"]
    iter_pix = check.pixels(seed, n_pix, chk["iteration_pixels"])
    kept = {"iters": [
        (1 + f, iter_pix, check.reference_film(
            low, integrator, seed, [1 + f], iter_pix, lanes, dtype).cpu()
         .float())
        for f in check.frames(seed, chk["frames"], chk["first_frames"])]}
    if chk["window_pixels"]:
        its = list(range(2, spp + 2))
        win_pix = check.window_sample(
            check.pixels(seed + 1, n_pix, chk["window_pixels"]), len(its),
            chk["window_lanes"])
        kept["window"] = (its, win_pix, check.reference_film(
            low, integrator, seed, its, win_pix, lanes, dtype).cpu().float())
    return kept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--spp", type=int, required=True,
                    help="window spp a run of the cell renders")
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args(argv)
    spec = cells.cell(opts.workload, os.getcwd())
    device = torch.device(opts.device)
    ref = ref_scene_mod.load(spec["config_path"], device)
    for seed in (int(s) for s in opts.seeds.split(",")):
        t0 = time.perf_counter()
        kept = control_outputs(spec, seed, opts.spp, device)
        numbers, ref_s = check.compare(kept, ref, spec["traffic"]
                                       ["integrator"], seed,
                                       spec["workload"]["check"])
        print(json.dumps({
            "workload": opts.workload, "seed": seed, "spp": opts.spp,
            "control_passed": check.passed(numbers),
            "numbers": {k: [v, lim] for k, v, lim in numbers},
            "seconds": time.perf_counter() - t0, "reference_s": ref_s}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
