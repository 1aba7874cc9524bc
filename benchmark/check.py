"""Whether the timed path rendered right: its output against the reference.

Each random site of a render is keyed by (seed, iteration, pixel or
path), so the reference (benchmark/reference/) can render any timed
iteration of any pixel on its own, from the configuration file and the
seed alone. Two kinds of output of the window are compared:

- iteration checks: the film's change across window frames drawn from
  the seed (the harness keeps the film before and after each), at a
  sample of pixels drawn from the seed, or at every pixel where the
  workload says so (BDPT: a pixel's change holds other lanes' splats);
- the window check (PT): the film's change over the whole window at a
  sample of pixels, against the reference's sum over every iteration
  the window rendered.

The numbers compared, each against the workload file's limit:
- `iter_off_share`: the share of compared pixels whose change differs
  from the reference by more than ATOL + RTOL |reference| in a channel;
- `iter_sum_gap`: |sum of the changes / sum of the reference's - 1|;
- `window_sum_gap`: the same over the whole window's sums.
"""

from __future__ import annotations

import random
import time

import torch

ATOL, RTOL = 1e-4, 1e-3


def frames(seed: int, count: int, first: int) -> list:
    """`count` distinct window frames among 1 .. `first`, from the seed."""
    return sorted(random.Random(seed).sample(range(1, first + 1), count))


def pixels(seed: int, n_pix: int, count: int):
    """`count` distinct pixel indices (all when 0) in an order drawn from
    the seed, so that any prefix is a sample too."""
    if count <= 0 or count >= n_pix:
        return torch.arange(n_pix)
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n_pix, generator=g)[:count]


def window_sample(pix, n_its: int, lanes: int):
    """The first pixels of `pix` whose window of `n_its` iterations fits
    in `lanes` (iteration, pixel) pairs, one at least: a window with far
    more iterations than a sound run's costs the reference no more."""
    return pix[:max(1, min(pix.shape[0], lanes // max(n_its, 1)))]


def off_share(a, b) -> float:
    bad = ((a.double() - b.double()).abs()
           > ATOL + RTOL * b.double().abs()).any(-1)
    return bad.double().mean().item()


def sum_gap(a, b) -> float:
    sb = b.double().sum().item()
    return abs(a.double().sum().item() / sb - 1.0) if sb else float("inf")


def reference_film(ref_scene, integrator: str, seed: int, its: list, pix,
                   lanes: int, dtype):
    """The reference's film change [len(pix), 3] (float64) at pixels `pix`
    summed over iterations `its`, rendered `lanes` (iteration, pixel)
    pairs a call. BDPT renders every pixel of each iteration, its splats
    landing anywhere."""
    from benchmark.reference import bdpt, pt
    dev = ref_scene.tri.device
    pix = pix.to(dev)
    out = torch.zeros((pix.shape[0], 3), dtype=torch.float64, device=dev)
    n_pix = ref_scene.width * ref_scene.height
    if integrator == "bdpt":
        every = torch.arange(n_pix, device=dev)
        for it in its:
            film = torch.zeros((n_pix, 3), dtype=torch.float64, device=dev)
            for c in range(0, n_pix, lanes):
                ids = every[c:c + lanes]
                li, splat = bdpt.radiance(ref_scene, seed,
                                          torch.full_like(ids, it), ids,
                                          dtype)
                film[ids] += li.double()
                film += splat.double()
            out += film[pix]
        return out
    it_t = torch.as_tensor(its, dtype=torch.int64, device=dev)
    pairs_it = it_t.repeat_interleave(pix.shape[0])
    pairs_px = pix.repeat(len(its))
    slot = torch.arange(pix.shape[0], device=dev).repeat(len(its))
    for c in range(0, pairs_px.shape[0], lanes):
        li = pt.radiance(ref_scene, seed, pairs_it[c:c + lanes],
                         pairs_px[c:c + lanes], dtype)
        out.index_add_(0, slot[c:c + lanes], li.double())
    return out


def compare(kept: dict, ref_scene, integrator: str, seed: int, check: dict,
            dtype=torch.float32) -> tuple:
    """Every number of `check` ("limits") for the window outputs `kept`
    ({"iters": [(iteration, pix, change)], "window": (iterations, pix,
    change) or None}), against the reference in `dtype`: ([(name, value,
    limit)], seconds the reference took)."""
    t0 = time.perf_counter()
    lanes = check["reference_lanes"]
    got, want = [], []
    for it, pix, change in kept["iters"]:
        got.append(change)
        want.append(reference_film(ref_scene, integrator, seed, [it], pix,
                                   lanes, dtype).cpu())
    # a window that ended before its check frames has checked nothing
    values = {"iter_off_share": float("inf"), "iter_sum_gap": float("inf")}
    if got:
        got, want = torch.cat(got), torch.cat(want)
        values = {"iter_off_share": off_share(got, want),
                  "iter_sum_gap": sum_gap(got, want)}
    if kept.get("window") is not None:
        its, pix, change = kept["window"]
        values["window_sum_gap"] = sum_gap(change, reference_film(
            ref_scene, integrator, seed, its, pix, lanes, dtype).cpu())
    if ref_scene.tri.is_cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    limits = check["limits"]
    return [(k, values[k], limits[k]) for k in limits if k in values], \
        seconds


def passed(numbers: list) -> bool:
    """Every number finite and within its limit."""
    return all(v == v and v <= lim for _, v, lim in numbers)
