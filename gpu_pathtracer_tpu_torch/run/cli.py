"""Command-line renderer:
`python -m gpu_pathtracer_tpu_torch.run.cli scene.json --spp 8 --out r.png`.

The port of gpu_pathtracer_tpu/run/cli.py for every integrator of the
JAX package (`--integrator ao|pt|vpt|lt|bdpt|sppm|ir|mlt`, SPPM's
`--photons` and `--init-radius`). Renders N progressive samples per
pixel (for MLT: N mutation steps of every chain, after the bootstrap,
which is part of the set-up) on `--device` (default cuda: the command
fails when no CUDA device is present) and writes a PNG, optionally an
EXR of the radiance. Also:
- `--checkpoint PATH`: resume from PATH if it exists (run/checkpoint.py)
  and write it every `--checkpoint-every` spp and at the end;
- `--shard`: split the render over the ranks of a torch.distributed
  group (run/renderer.py, parallel/dist.py). Under
  `torchrun --nproc-per-node N -m gpu_pathtracer_tpu_torch.run.cli ...
  --shard` rank r joins the group (NCCL on cuda:LOCAL_RANK, gloo with
  `--device cpu`); without torchrun it is a world of 1. Rank 0 alone
  prints and writes the images and the checkpoint;
- `--profile DIR`: a torch.profiler trace (CPU and CUDA activities) of
  the render loop, written to DIR as a Chrome trace;
- the `[hbm]` line: the scene tables' device memory by category;
- the `[spans]` line: the median host ms a spp of each span the program
  records (gpu_pathtracer_tpu_torch/telemetry.py: the spp's
  "iteration", its phases, its sync.* host syncs) and the median count
  of host syncs a spp, over the render's spp (the last 256).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch

from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.film.imageio import save_exr, save_png
from gpu_pathtracer_tpu_torch.parallel import dist
from gpu_pathtracer_tpu_torch.run import checkpoint as ckpt
from gpu_pathtracer_tpu_torch.run.renderer import Renderer, resolve_device

HBM_CATEGORIES = ("geometry", "bvh", "materials", "lights", "textures",
                  "env", "media")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _category(name: str) -> str:
    """The [hbm] category of a DeviceScene field."""
    if name.startswith(("node_", "bvh8_", "block_")):
        return "bvh"
    if name.startswith(("m_", "b_")) or name == "mat_attrs":
        return "materials"
    if name.startswith("l_") or name in ("light_attrs", "light_cdf"):
        return "lights"
    if name.startswith("tex_"):
        return "textures"
    if name.startswith("env_"):
        return "env"
    if name.startswith("med_"):
        return "media"
    return "geometry"


def scene_bytes(scene) -> dict:
    """{category: bytes} of a DeviceScene's tensors (the counterpart of
    the reference's per-category VRAM summary, pathtracer.cu:2689-2694)."""
    out = dict.fromkeys(HBM_CATEGORIES, 0)
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if isinstance(v, torch.Tensor):
            out[_category(f.name)] += v.numel() * v.element_size()
    return out


def _join_group(device: torch.device) -> torch.device:
    """Join torchrun's group and return this rank's device; raises if
    the group does not form."""
    if device.type == "cuda":
        device = torch.device("cuda", dist.local_rank())
        torch.cuda.set_device(device)
    dist.init("nccl" if device.type == "cuda" else "gloo")
    return device


def main(argv=None):
    """Run the CLI; returns a dict of what it measured (for scripts)."""
    ap = argparse.ArgumentParser(description="PyTorch/CUDA path tracer")
    ap.add_argument("scene", help="scene JSON (reference-compatible schema)")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--exr", default=None, help="also dump radiance EXR")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tile", type=int, default=1 << 20,
                    help="lanes per launch")
    ap.add_argument("--size", type=int, default=None,
                    help="override the square render resolution")
    ap.add_argument("--depth", type=int, default=None,
                    help="override the scene's maxDepth")
    ap.add_argument("--integrator", default=None,
                    choices=["ao", "pt", "vpt", "lt", "bdpt", "sppm", "ir",
                             "mlt"],
                    help="override the scene's integrator")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    ap.add_argument("--no-cache", action="store_true",
                    help="build the BVH anew, bypassing its disk cache")
    ap.add_argument("--checkpoint", default=None,
                    help="npz render checkpoint: resumed from if it "
                         "exists, written after the render (and every "
                         "--checkpoint-every spp)")
    ap.add_argument("--checkpoint-every", type=int, default=64)
    ap.add_argument("--shard", action="store_true",
                    help="split the render over the ranks of torchrun's "
                         "group (a world of 1 without torchrun)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the "
                         "render loop into DIR")
    ap.add_argument("--photons", type=int, default=None,
                    help="SPPM photons per iteration (default: the scene's)")
    ap.add_argument("--init-radius", type=float, default=None,
                    help="SPPM initial photon radius (default: the scene's)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    joined = False
    if args.shard and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = _join_group(device)
        joined = True
    try:
        return _render(args, device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _render(args, device) -> dict:
    t0 = time.time()
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    scene = load_scene(args.scene)
    if args.size is not None:
        scene.width = scene.height = args.size
    integrator = None
    if args.integrator is not None:
        from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
        integrator = IntegratorType[args.integrator.upper()]
    r = Renderer(scene, tile_size=args.tile, seed=args.seed,
                 integrator=integrator, max_depth=args.depth, device=device,
                 cache=not args.no_cache, photons_per_iteration=args.photons,
                 init_radius=args.init_radius, shard=args.shard)
    build_s = time.time() - t0
    lead = r.shard.rank == 0

    def say(line):
        if lead:
            print(line, flush=True)

    say(f"[scene] {r.static.n_primitives} prims, {r.width}x{r.height}, "
        f"integrator={r.static.integrator.name}, depth "
        f"{r.static.max_depth}, device {device} (built in {build_s:.2f}s)")
    if args.shard:
        say(f"[shard] {r.shard.world} rank(s)")
    mb = {k: v / (1 << 20) for k, v in scene_bytes(r.device_scene).items()}
    say("[hbm] " + ", ".join(f"{k} {v:.2f} MB" for k, v in mb.items()))

    start = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        ckpt.load_checkpoint(r, args.checkpoint)
        start = r.iteration
        say(f"[resume] {args.checkpoint} @ {start} spp")

    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)

    _sync(device)
    rays0 = int(r.rays)   # MLT's bootstrap traced these during the set-up
    t0 = time.time()
    with prof:
        for i in range(start, args.spp):
            r.render_iteration()
            if (i + 1) % 16 == 0:
                _sync(device)
                say(f"[render] {i + 1}/{args.spp} spp, "
                    f"{(i + 1 - start) / (time.time() - t0):.3f} spp/s")
            if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
                ckpt.save_checkpoint(r, args.checkpoint)
        _sync(device)
    dt = max(time.time() - t0, 1e-9)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, f"trace_rank{r.shard.rank}.json")
        prof.export_chrome_trace(trace)
        say(f"[profile] trace in {trace}")
    done = args.spp - start
    rays = int(r.rays) - rays0
    say(f"[render] {done} spp in {dt:.3f}s "
        f"({done / dt:.3f} spp/s, {rays / dt / 1e6:.2f} Mrays/s)")
    recs = telemetry.records()[-done:] if done > 0 else []
    span_ms, syncs = telemetry.summary(recs)
    say(f"[spans] median host ms a spp over {len(recs)} spp: "
        + ", ".join(f"{k} {v:.4f}" for k, v in span_ms.items())
        + f"; {syncs:g} host syncs a spp")
    if args.checkpoint:
        ckpt.save_checkpoint(r, args.checkpoint)
        say(f"[out] checkpoint {args.checkpoint} @ {r.iteration} spp")

    img = r.image()
    rad = r.radiance() if args.exr else None
    if lead:
        save_png(args.out, img)
        print(f"[out] wrote {args.out}")
        if args.exr:
            save_exr(args.exr, rad[::-1])
            print(f"[out] wrote {args.exr}")
    return {"seconds": dt, "build_seconds": build_s, "spp": done,
            "rays": rays, "spp_per_s": done / dt,
            "mrays_per_s": rays / dt / 1e6, "renderer": r}


if __name__ == "__main__":
    main()
