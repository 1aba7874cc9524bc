"""The traffic generator: a progressive render driven frame by frame.

A traffic file (benchmark/traffic/<name>.json) gives the integrator, the
loop ("closed": a frame is issued when the last call has returned), the
spp a frame, the tile (lanes a call) and the depth (null: the scene's).
This is the loop of the program's CLI and progressive preview, and of
its bench's `windows` (gpu_pathtracer_tpu_torch/run/bench.py), with the
window taken whole: every spp and every second of it.
"""

from __future__ import annotations

import time

import torch


def renderer(config_path: str, traffic: dict, seed: int, device,
             size: int | None = None):
    """The program's Renderer over the configuration's scene file, set
    up as the traffic says (`size` renders size x size: tests only)."""
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    if traffic["loop"] != "closed":
        raise ValueError(f"no generator for a {traffic['loop']!r} loop")
    host = load_scene(config_path)
    if size is not None:
        host.width = host.height = size
    return Renderer(host, tile_size=traffic["tile"], seed=seed,
                    integrator=IntegratorType[traffic["integrator"].upper()],
                    max_depth=traffic["depth"], device=device, cache=False)


def frame(r, traffic: dict) -> None:
    for _ in range(traffic["spp_per_frame"]):
        r.render_iteration()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Stamp:
    """A point in the device's stream (a CUDA event), or on the host clock
    where there is no device (the CPU tests)."""

    def __init__(self, cuda: bool):
        self.ev = torch.cuda.Event(enable_timing=True) if cuda else None
        if cuda:
            self.ev.record()
        else:
            self.t = time.perf_counter()

    def ms_to(self, later) -> float:
        if self.ev is not None:
            return self.ev.elapsed_time(later.ev)
        return (later.t - self.t) * 1e3


def window(r, traffic: dict, seconds: float, keep: set):
    """Frames of renderer `r` until `seconds` have passed on the host
    clock, which starts before the first frame and stops after the
    final synchronise. Each frame is stamped in the device's stream when
    its calls have been issued; the stamps are read after the window.
    For the frames in `keep` (1-based) the film is copied before and
    after. Returns (frames, seconds, [interval ms between consecutive
    frames' completions], {frame: (iterations, film before, after)})."""
    cuda = r.acc.is_cuda
    kept = {}
    sync(r.device)
    stamps = [_Stamp(cuda)]
    t0 = time.perf_counter()
    n = 0
    while True:
        n += 1
        if n in keep:
            before, it0 = r.acc.clone(), r.iteration
        frame(r, traffic)
        if n in keep:
            kept[n] = (list(range(it0 + 1, r.iteration + 1)), before,
                       r.acc.clone())
        stamps.append(_Stamp(cuda))
        if time.perf_counter() - t0 >= seconds:
            break
    sync(r.device)
    elapsed = time.perf_counter() - t0
    return n, elapsed, [a.ms_to(b) for a, b in zip(stamps, stamps[1:])], kept
