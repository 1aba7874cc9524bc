"""Where the time goes in the port's main path, on one NVIDIA GPU.

    python3 tools/profile_port.py [--spp 4] [--top 5]
        [--integrator ao|pt|vpt|lt|bdpt|ir|sppm|mlt] [scene.json ...]

Renders each scene (default: scenes/cornell_port/scene.json, which takes
the megakernel; scenes/env_port/scene.json, its environment variant;
many_lights.json, whose 72 lights send it through the wavefront over the
dense-hit kernel; the large-mesh scenes of scenes/knot_port, through the
wavefront over the block-culled kernel or the BVH8 walk, sky.json with
textures and the sky; and scenes/smoke_port, whose volumetric path
tracer runs over the dense-hit and media tracking kernels) at its own
resolution and depth (and integrator, unless --integrator names
another). After one warm-up spp it times one untraced window of --spp
spp and profiles --spp more, with the bench's own measurement
(run/bench.py: `windows`, `profile_spp`, `device_shares`), and prints
per scene: wall ms/spp untraced and traced, device ms/spp (the union
of the device's intervals), the device's busy and idle shares of an
untraced spp, the --top device operations that take the most time,
the launches a spp and time of PyTorch's masked elementwise kernels, of
its row gathers, of torch.cat's copies and of its sorts' radix passes
(all of them, not only the top ones), every
kernel of the port's own CUDA sources (the __global__ functions of
gpu_pathtracer_tpu_torch/csrc/*.cu, BDPT's bdpt_step_kernel,
bdpt_connect_kernel and bdpt_finish_kernel among them) with its share,
and the longest idle gaps. A "spp" of SPPM is one iteration (eye pass, grid, photon
pass), of MLT one mutation of every chain (the bootstrap is made with
the renderer, before the window). Needs a CUDA device; prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# op families by name: PyTorch's row gathers (`index`:
# `vectorized_gather_kernel`, `index_elementwise_kernel`; `index_select`:
# `indexSelect*Index`), its masked elementwise work (where, mul,
# comparisons: the other `elementwise_kernel`s), `torch.cat`'s copies
# (`CatArrayBatchedCopy`) and its sorts' radix passes (cub's
# `DeviceRadixSort*` kernels)
def _gather(name: str) -> bool:
    return ("gather_kernel" in name or "index_elementwise_kernel" in name
            or "indexSelect" in name)


FAMILIES = (("masked elementwise",
             lambda n: "elementwise_kernel" in n and not _gather(n)),
            ("gathers", _gather),
            ("cat", lambda n: "CatArrayBatchedCopy" in n),
            ("radix sorts", lambda n: "RadixSort" in n))


def _op(e) -> str:
    return (f"    {e['ms_per_spp']:9.3f} ms/spp  {100 * e['share']:5.1f}%  "
            f"x{e['per_spp']:g}/spp  {e['name'][:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--top", type=int, default=5,
                    help="device operations to list, by time")
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
    sys.path.insert(0, REPO)
    from gpu_pathtracer_tpu_torch.geom import traverse
    from gpu_pathtracer_tpu_torch.integrators import pt_fused
    from gpu_pathtracer_tpu_torch.run import bench
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    print(bench.card_line())
    for path in args.scenes:
        r = Renderer(path, device="cuda", integrator=None
                     if args.integrator is None
                     else IntegratorType[args.integrator.upper()])
        r.render_iteration()
        spp_s = bench.window_summary(bench.windows(r, 1, args.spp, 0.0))
        prof = bench.profile_spp(r, args.spp, top=1 << 30)
        flags = bench.device_shares(prof, spp_s["value"])
        integ = r.static.integrator
        fused = integ in (IntegratorType.PT, IntegratorType.MLT) \
            and pt_fused.supports(r.static)
        regime = (f"{integ.name} over the megakernel" if fused else
                  f"{integ.name} {r.kind} wavefront, "
                  f"{traverse.regime(r.static)} regime")
        print(f"[{os.path.basename(path)}, {regime}] {r.width}x{r.height} "
              f"depth {r.static.max_depth}: wall {1e3 / spp_s['value']:.3f} "
              f"ms/spp untraced, {prof['traced_wall_ms_per_spp']:.3f} "
              f"traced; device {prof['device_ms_per_spp']:.3f} ms/spp; "
              f"busy {prof['busy_share']:.3f}, idle "
              f"{prof['idle_share']:.3f} (traced "
              f"{prof['traced_idle_share']:.3f}) {' '.join(flags)}".rstrip())
        for e in prof["top_ops"][:args.top]:
            print(_op(e))
        for family, member in FAMILIES:
            ops = [e for e in prof["top_ops"] if member(e["name"])]
            print(f"    {family}: {sum(e['per_spp'] for e in ops):g} launches "
                  f"a spp, {sum(e['ms_per_spp'] for e in ops):.3f} ms/spp, "
                  f"{100 * sum(e['share'] for e in ops):.1f}%")
        for e in prof["port_kernels"]:
            print("  port kernel" + _op(e)[3:])
        for g in prof["gaps"]:
            print(f"    gap {g['ms']:.3f} ms during {g['during']}; "
                  f"then {g['next']}")


if __name__ == "__main__":
    main()
