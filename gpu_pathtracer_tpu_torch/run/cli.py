"""Command-line renderer:
`python -m gpu_pathtracer_tpu_torch.run.cli scene.json --spp 8 --out r.png`.

The port of gpu_pathtracer_tpu/run/cli.py for every integrator of the
JAX package (`--integrator ao|pt|vpt|lt|bdpt|sppm|ir|mlt`, SPPM's
`--photons` and `--init-radius`). Renders N progressive samples per
pixel (for MLT: N mutation steps of every chain, after the bootstrap,
which is part of the set-up) on `--device` (default cuda: the command
fails when no CUDA device is present) and writes a PNG, optionally an
EXR of the radiance. Options of the JAX CLI whose machinery is not
ported yet (`--checkpoint`, `--shard`, `--profile`) exit with an error
naming the ROADMAP item.
"""

from __future__ import annotations

import argparse
import time

import torch

from gpu_pathtracer_tpu_torch.film.imageio import save_exr, save_png
from gpu_pathtracer_tpu_torch.run.renderer import Renderer, resolve_device

_NOT_PORTED = {
    "checkpoint": "checkpoints (ROADMAP.md, still to port: item 5)",
    "shard": "multi-GPU rendering (ROADMAP.md, still to port: item 5)",
    "profile": "profiling (ROADMAP.md, still to port: item 5)",
}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    for name in ("checkpoint", "profile"):
        ap.add_argument(f"--{name}", default=None, help="not ported yet")
    ap.add_argument("--shard", action="store_true", help="not ported yet")
    ap.add_argument("--photons", type=int, default=None,
                    help="SPPM photons per iteration (default: the scene's)")
    ap.add_argument("--init-radius", type=float, default=None,
                    help="SPPM initial photon radius (default: the scene's)")
    args = ap.parse_args(argv)

    for name, what in _NOT_PORTED.items():
        if getattr(args, name) not in (None, False):
            ap.error(f"--{name.replace('_', '-')}: {what}")
    device = resolve_device(args.device)

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
                 init_radius=args.init_radius)
    build_s = time.time() - t0
    print(f"[scene] {r.static.n_primitives} prims, {r.width}x{r.height}, "
          f"integrator={r.static.integrator.name}, depth "
          f"{r.static.max_depth}, device {device} "
          f"(built in {build_s:.2f}s)")

    _sync(device)
    rays0 = int(r.rays)   # MLT's bootstrap traced these during the set-up
    t0 = time.time()
    for i in range(args.spp):
        r.render_iteration()
        if (i + 1) % 16 == 0:
            _sync(device)
            print(f"[render] {i + 1}/{args.spp} spp, "
                  f"{(i + 1) / (time.time() - t0):.3f} spp/s")
    _sync(device)
    dt = time.time() - t0
    rays = int(r.rays) - rays0
    print(f"[render] {args.spp} spp in {dt:.3f}s "
          f"({args.spp / dt:.3f} spp/s, {rays / dt / 1e6:.2f} Mrays/s)")

    save_png(args.out, r.image())
    print(f"[out] wrote {args.out}")
    if args.exr:
        save_exr(args.exr, r.radiance()[::-1])
        print(f"[out] wrote {args.exr}")
    return {"seconds": dt, "build_seconds": build_s, "spp": args.spp,
            "rays": rays,
            "spp_per_s": args.spp / dt, "mrays_per_s": rays / dt / 1e6,
            "renderer": r}


if __name__ == "__main__":
    main()
