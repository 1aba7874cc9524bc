"""Where the time goes in the port's main path, on one NVIDIA GPU.

    python3 tools/profile_port.py [--spp 4]
        [--integrator ao|pt|vpt|lt|bdpt|ir|sppm|mlt] [scene.json ...]

Renders each scene (default: scenes/cornell_port/scene.json, which takes
the megakernel; scenes/env_port/scene.json, its environment variant;
many_lights.json, whose 72 lights send it through the wavefront over the
dense-hit kernel; the large-mesh scenes of scenes/knot_port, through the
wavefront over the block-culled kernel or the BVH8 walk, sky.json with
textures and the sky; and scenes/smoke_port, whose volumetric path
tracer runs over the dense-hit and media tracking kernels) at its own
resolution
and depth (and integrator, unless --integrator names another) under
torch.profiler
after one warm-up spp, and prints per scene: wall time per spp, device
time per spp summed over kernels, the device's idle share of the window,
the kernels that take the most device time, and then every kernel of
the port's own CUDA sources (the __global__ functions of
gpu_pathtracer_tpu_torch/csrc/*.cu) with its share. A "spp" of SPPM is
one iteration (eye pass, grid, photon pass), of MLT one mutation of
every chain (the bootstrap is made with the renderer, before the
window). Needs a CUDA device; prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def port_kernels() -> list[str]:
    """Names of the __global__ functions in the port's csrc/*.cu."""
    names = set()
    for path in glob.glob(os.path.join(REPO, "gpu_pathtracer_tpu_torch",
                                       "csrc", "*.cu")):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|"
                r"\([^()]*\))*\)\s+)?(\w+)", f.read()))
    return sorted(names)


def _row(us, count, dev_us, spp, key) -> str:
    return (f"    {us / 1e3 / spp:9.3f} ms/spp  "
            f"{100 * us / max(dev_us, 1e-9):5.1f}%  x{count // spp}/spp  "
            f"{key[:90]}")


def profile(renderer, spp: int):
    from torch.profiler import ProfilerActivity, profile as tprofile
    renderer.render_iteration()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(spp):
            renderer.render_iteration()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.key, _device_us(e), e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    return wall, rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--integrator", default=None,
                    choices=["ao", "pt", "vpt", "lt", "bdpt", "ir", "sppm",
                             "mlt"],
                    help="override each scene's integrator")
    ap.add_argument("scenes", nargs="*", default=[
        os.path.join(REPO, "scenes", folder, name)
        for folder, name in (("cornell_port", "scene.json"),
                             ("env_port", "scene.json"),
                             ("cornell_port", "many_lights.json"),
                             ("knot_port", "scene.json"),
                             ("knot_port", "sky.json"),
                             ("knot_port", "forest.json"),
                             ("knot_port", "blocked.json"),
                             ("smoke_port", "scene.json"))])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sys.path.insert(0, REPO)
    from gpu_pathtracer_tpu_torch.geom import traverse
    from gpu_pathtracer_tpu_torch.integrators import pt_fused
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    kernels = port_kernels()
    for path in args.scenes:
        r = Renderer(path, device="cuda", integrator=None
                     if args.integrator is None
                     else IntegratorType[args.integrator.upper()])
        wall, rows = profile(r, args.spp)
        dev_us = sum(us for _, us, _ in rows)
        integ = r.static.integrator
        fused = integ in (IntegratorType.PT, IntegratorType.MLT) \
            and pt_fused.supports(r.static)
        regime = (f"{integ.name} over the megakernel" if fused else
                  f"{integ.name} {r.kind} wavefront, "
                  f"{traverse.regime(r.static)} regime")
        print(f"[{os.path.basename(path)}, {regime}] {r.width}x{r.height} "
              f"depth {r.static.max_depth}: "
              f"wall {1e3 * wall / args.spp:.3f} ms/spp, device "
              f"{dev_us / 1e3 / args.spp:.3f} ms/spp, idle share "
              f"{max(0.0, 1 - dev_us / 1e6 / wall):.3f}")
        for key, us, count in rows[:8]:
            print(_row(us, count, dev_us, args.spp, key))
        for name in kernels:
            for key, us, count in rows:
                if re.search(rf"\b{name}\b", key):
                    print("  port kernel" + _row(us, count, dev_us,
                                                 args.spp, key)[3:])


if __name__ == "__main__":
    main()
