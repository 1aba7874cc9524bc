"""Progressive renderer: one `render_iteration` adds one sample per pixel.

The port of gpu_pathtracer_tpu/run/renderer.py for three kinds of lane
program (`lane_program`):
- "pixel" (ambient occlusion, path tracing, volumetric path tracing):
  lanes are pixels, each returns its own radiance;
- "film" (light tracing): each iteration traces W*H light paths, in
  tiles of `tile_size` paths, each tile returning a splatted [W*H, 3]
  film; the sum is normalised by the path count;
- "hybrid" (BDPT): lanes are pixels, each returns its own radiance plus
  a film of its s == 1 splats.
The film accumulates in a [W*H, 3] tensor on `device`. Every random
site is keyed by (seed, iteration, pixel or path index), so the image
does not depend on the tile size (a splatted film only within float32
summation order).
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.film import film as film_mod
from gpu_pathtracer_tpu_torch.geom import packet_cuda, traverse
from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
from gpu_pathtracer_tpu_torch.scene.model import HostScene, IntegratorType
from gpu_pathtracer_tpu_torch.scene.parse import load_scene

DEFAULT_TILE = 1 << 20


def lane_program(integrator: IntegratorType):
    """Integrator dispatch (pathtracer.cu:2711-2745): (kind, program).
    "pixel": program(scene, static, seed, it, px, py, with_stats) ->
    (li [N, 3], rays); "film": program(scene, static, seed, it, path_ids,
    with_stats) -> (film [W*H, 3], rays); "hybrid": program(scene,
    static, seed, it, px, py, with_stats) -> (li, film, rays)."""
    from gpu_pathtracer_tpu_torch.integrators import ao, bdpt, lt, pt, vpt
    if integrator == IntegratorType.AO:
        return "pixel", ao.render_lanes
    if integrator == IntegratorType.PT:
        return "pixel", pt.render_lanes
    if integrator == IntegratorType.VPT:
        return "pixel", vpt.render_lanes
    if integrator == IntegratorType.LT:
        return "film", lt.render_film
    if integrator == IntegratorType.BDPT:
        return "hybrid", bdpt.render_lanes
    raise NotImplementedError(
        f"integrator {integrator.name} is not ported yet (ROADMAP.md, "
        f"still to port: item 4)")


def resolve_device(device) -> torch.device:
    """The device to render on; a CUDA device that is absent raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda."
                           "is_available() is false")
    return device


class Renderer:
    def __init__(self, scene: HostScene | str, tile_size: int = DEFAULT_TILE,
                 seed: int = 0, integrator: IntegratorType | None = None,
                 max_depth: int | None = None, device="cuda",
                 cache: bool = True):
        if isinstance(scene, str):
            scene = load_scene(scene)
        self.device = resolve_device(device)
        self.host = scene
        self.device_scene, self.static = flatten_scene(scene, self.device,
                                                       cache=cache)
        import dataclasses
        repl = {}
        if integrator is not None:
            repl["integrator"] = integrator
        if max_depth is not None:
            repl["max_depth"] = max_depth
        if repl:
            self.static = dataclasses.replace(self.static, **repl)
        self.width = self.static.width
        self.height = self.static.height
        self.seed = seed
        self.kind, self._program = lane_program(self.static.integrator)
        # the BVH8 walk's stack overflows are read once per spp
        self._walks = traverse.regime(self.static) in ("instanced", "bvh8")
        n = self.width * self.height
        self.tile_size = min(tile_size, n)
        ids = torch.arange(n, device=self.device, dtype=torch.int32)
        # y = 0 is the bottom row, like the reference's GL-oriented film
        self._ids = ids
        self._px = ids % self.width
        self._py = ids // self.width
        self.acc = torch.zeros((n, 3), dtype=torch.float32,
                               device=self.device)
        self.rays = torch.zeros((), dtype=torch.int64, device=self.device)
        self.iteration = 0

    def render_iteration(self) -> None:
        """Add one sample per pixel to the film. The host synchronises
        only for a scene that the BVH8 walk serves, once, to read its
        stack-overflow flag (geom/packet_cuda.check_overflow)."""
        self.iteration += 1
        n = self.acc.shape[0]
        args = (self.device_scene, self.static, self.seed, self.iteration)
        for t0 in range(0, n, self.tile_size):
            t1 = min(t0 + self.tile_size, n)
            if self.kind == "film":
                # paths t0 .. t1 - 1 of the W*H an iteration traces, as
                # the reference; normalising by the path count (pixels /
                # paths = 1) leaves the sum of the tiles' splats
                film, rays = self._program(*args, self._ids[t0:t1],
                                           with_stats=True)
                self.acc += film
            elif self.kind == "hybrid":
                li, film, rays = self._program(
                    *args, self._px[t0:t1], self._py[t0:t1], with_stats=True)
                self.acc[t0:t1] += li
                self.acc += film
            else:
                li, rays = self._program(
                    *args, self._px[t0:t1], self._py[t0:t1], with_stats=True)
                self.acc[t0:t1] += li
            self.rays += rays
        if self._walks:
            packet_cuda.check_overflow(self.device)

    def render(self, spp: int):
        for _ in range(spp):
            self.render_iteration()
        return self.image()

    def radiance(self):
        """Mean radiance film [H, W, 3] numpy (row 0 = bottom)."""
        acc = (self.acc / max(self.iteration, 1)).cpu().numpy()
        return acc.reshape(self.height, self.width, 3)

    def image(self):
        """Tonemapped display image [H, W, 3] numpy (row 0 = bottom)."""
        img = film_mod.tonemap(self.acc, self.iteration, self.static.filmic)
        return img.cpu().numpy().reshape(self.height, self.width, 3)
