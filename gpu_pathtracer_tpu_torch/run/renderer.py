"""Progressive renderer: one `render_iteration` adds one sample per pixel.

The port of gpu_pathtracer_tpu/run/renderer.py. Kinds of lane program
(`lane_program`):
- "pixel" (ambient occlusion, path tracing, volumetric path tracing):
  lanes are pixels, each returns its own radiance;
- "film" (light tracing): each iteration traces W*H light paths, in
  tiles of `tile_size` paths, each tile returning a splatted [W*H, 3]
  film; the sum is normalised by the path count;
- "hybrid" (BDPT): lanes are pixels, each returns its own radiance plus
  a film of its s == 1 splats;
- "ir" (instant radiosity): a pixel program gathering one row of a VPL
  store that is regenerated every IR_MAX_VPLS iterations (the
  iteration it - 1 = 0 mod 32 regenerates it; iteration it gathers row
  (it - 1) mod 32, pathtracer.cu:2739-2744);
- "sppm" and "mlt": programs that couple all pixels (the photon grid,
  the Markov chains), run untiled on state kept on `device` between
  iterations; their film is absolute, not a sum over iterations. MLT's
  chains are bootstrapped when the renderer is made (and on `reset`).
The film accumulates in a [W*H, 3] tensor on `device`. Every random
site is keyed by (seed, iteration, pixel or path index), so the image
does not depend on the tile size (a splatted film only within float32
summation order).

`shard=True` splits the work over the ranks of the initialised
torch.distributed group (parallel/dist.py; without one, a world of 1),
each rank a process on its own device with the whole scene. Rank r
takes lanes `lane_range(W*H, r, world)`: pixels ("pixel", "ir",
"hybrid", SPPM's eye pass), light paths ("film") or chains ("mlt");
SPPM also splits its photons and MLT its chains' draws by the same
rule (integrators/sppm.py, mlt.py). What every rank holds:
- "pixel", "ir": its pixels' sums; the film is gathered bit for bit
  when read, so it equals one rank's (IR's VPL store, keyed by seed and
  iteration alone, is made whole on every rank);
- "film", "hybrid": its paths' splats (and its pixels' radiance); the
  films are summed when read: one rank's within float32 summation order;
- "sppm", "mlt": the whole film, made from the ranks' sums every
  iteration; SPPM's visible points whole, MLT's chains the rank's own.
Reading the film (`film`, `radiance`, `image`), the rays (`rays`) or a
checkpoint is a collective there: every rank makes the same calls.
"""

from __future__ import annotations

import os

import torch

from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.film import film as film_mod
from gpu_pathtracer_tpu_torch.geom import packet_cuda, traverse
from gpu_pathtracer_tpu_torch.parallel import dist
from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
from gpu_pathtracer_tpu_torch.scene.model import HostScene, IntegratorType
from gpu_pathtracer_tpu_torch.scene.parse import load_scene

DEFAULT_TILE = 1 << 20


def lane_program(integrator: IntegratorType):
    """Integrator dispatch (pathtracer.cu:2711-2745): (kind, program).
    "pixel": program(scene, static, seed, it, px, py, with_stats) ->
    (li [N, 3], rays); "film": program(scene, static, seed, it, path_ids,
    with_stats) -> (film [W*H, 3], rays); "hybrid": program(scene,
    static, seed, it, px, py, with_stats) -> (li, film, rays); "ir":
    program(scene, static, seed, it, px, py, vpls, row, with_stats) ->
    (li, rays); "sppm": program(scene, static, seed, it, state, px, py,
    with_stats) -> (state, film, rays); "mlt": program(scene, static,
    seed, it, state, with_stats) -> (state, film, rays). Each takes
    `plain=True` to run over the plain intersection on any device."""
    from gpu_pathtracer_tpu_torch.integrators import (
        ao, bdpt, ir, lt, mlt, pt, sppm, vpt,
    )
    return {
        IntegratorType.AO: ("pixel", ao.render_lanes),
        IntegratorType.PT: ("pixel", pt.render_lanes),
        IntegratorType.VPT: ("pixel", vpt.render_lanes),
        IntegratorType.LT: ("film", lt.render_film),
        IntegratorType.BDPT: ("hybrid", bdpt.render_lanes),
        IntegratorType.IR: ("ir", ir.render_lanes),
        IntegratorType.SPPM: ("sppm", sppm.render_iteration),
        IntegratorType.MLT: ("mlt", mlt.render_iteration),
    }[integrator]


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
                 cache: bool = True, photons_per_iteration: int | None = None,
                 init_radius: float | None = None, shard: bool = False):
        if isinstance(scene, str):
            scene = load_scene(scene)
        self.device = resolve_device(device)
        self.shard = dist.Shard()
        if shard:
            self.shard = dist.Shard.current()
            if not self.shard.joined and \
                    int(os.environ.get("WORLD_SIZE", "1")) > 1:
                raise RuntimeError(
                    "shard=True under WORLD_SIZE > 1 needs the process "
                    "group initialised first (parallel/dist.init)")
        self.host = scene
        self.device_scene, self.static = flatten_scene(scene, self.device,
                                                       cache=cache)
        import dataclasses
        repl = {}
        if integrator is not None:
            repl["integrator"] = integrator
        if max_depth is not None:
            repl["max_depth"] = max_depth
        if photons_per_iteration is not None:
            repl["photons_per_iteration"] = photons_per_iteration
        if init_radius is not None:
            repl["init_radius"] = init_radius
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
        # this rank's pixels, light paths or chains
        self._lo, self._hi = self.shard.range(n)
        ids = torch.arange(n, device=self.device, dtype=torch.int32)
        # y = 0 is the bottom row, like the reference's GL-oriented film
        self._ids = ids
        self._px = ids % self.width
        self._py = ids // self.width
        self._rays = torch.zeros((), dtype=torch.int64, device=self.device)
        self.reset()

    def reset(self) -> None:
        """Restart the film (the camera moved, pathtracer.cu:2521): the
        iteration count, SPPM's visible points, IR's VPL store and MLT's
        chains (bootstrapped again here) start anew."""
        n = self.width * self.height
        self.acc = torch.zeros((n, 3), dtype=torch.float32,
                               device=self.device)
        self.iteration = 0
        self._vpls = None
        if self.kind == "sppm":
            from gpu_pathtracer_tpu_torch.integrators import sppm
            self._sppm_state = sppm.init_state(n, self.static.init_radius,
                                               self.device)
        if self.kind == "mlt":
            from gpu_pathtracer_tpu_torch.integrators import mlt
            self._mlt_state, rays = mlt.bootstrap(
                self.device_scene, self.static, self.seed, n,
                shard=self.shard)
            self._rays += rays

    def render_iteration(self) -> None:
        """Add one sample per pixel to the film (SPPM, MLT: replace the
        absolute film). The host synchronises for a scene that the BVH8
        walk serves, once, to read its stack-overflow flag
        (geom/packet_cuda.check_overflow), and where a program compacts
        lanes (IR's gather, SPPM's deposits). The spp is one record of
        `telemetry` (its "iteration" span and what the program records
        inside)."""
        self.iteration += 1
        with telemetry.iteration(self.iteration):
            args = (self.device_scene, self.static, self.seed,
                    self.iteration)
            if self.kind == "sppm":
                self._sppm_state, self.acc, rays = self._program(
                    *args, self._sppm_state, self._px, self._py,
                    with_stats=True, shard=self.shard)
                self._add_rays(rays)
            elif self.kind == "mlt":
                self._mlt_state, self.acc, rays = self._program(
                    *args, self._mlt_state, with_stats=True,
                    shard=self.shard)
                self._add_rays(rays)
            else:
                self._render_tiles(args)
            if self._walks:
                packet_cuda.check_overflow(self.device)

    def _add_rays(self, rays) -> None:
        """Count the rays a program returned (0-d int64 on `device`), in
        `rays` and in the spp's "rays" counter."""
        telemetry.count("rays", rays)
        self._rays += rays

    def _render_tiles(self, args) -> None:
        extra = ()
        if self.kind == "ir":
            from gpu_pathtracer_tpu_torch.integrators import ir
            row = (self.iteration - 1) % ir.IR_MAX_VPLS
            if row == 0 or self._vpls is None:
                # every rank makes the whole store; rank 0 counts its rays
                self._vpls, rays = ir.generate_vpls(*args, with_stats=True)
                if self.shard.rank == 0:
                    self._add_rays(rays)
            extra = (self._vpls, row)
        for t0 in range(self._lo, self._hi, self.tile_size):
            t1 = min(t0 + self.tile_size, self._hi)
            li = film = None
            if self.kind == "film":
                # paths t0 .. t1 - 1 of the W*H an iteration traces, as
                # the reference; normalising by the path count (pixels /
                # paths = 1) leaves the sum of the tiles' splats
                film, rays = self._program(*args, self._ids[t0:t1],
                                           with_stats=True)
            elif self.kind == "hybrid":
                li, film, rays = self._program(
                    *args, self._px[t0:t1], self._py[t0:t1], with_stats=True)
            else:
                li, rays = self._program(
                    *args, self._px[t0:t1], self._py[t0:t1], *extra,
                    with_stats=True)
            with telemetry.span("film.add"):
                if li is not None:
                    self.acc[t0:t1] += li
                if film is not None:
                    self.acc += film
                self._add_rays(rays)

    def render(self, spp: int):
        for _ in range(spp):
            self.render_iteration()
        return self.image()

    def _divisor(self) -> int:
        """What the film is divided by: the iteration count, or 1 for the
        absolute films of SPPM and MLT."""
        return 1 if self.kind in ("sppm", "mlt") else max(self.iteration, 1)

    @property
    def rays(self) -> torch.Tensor:
        """Rays traced since the renderer was made (0-d int64; summed
        over the ranks of a sharded render)."""
        return self.shard.reduce(self._rays)

    def film(self) -> torch.Tensor:
        """The whole accumulated film [W*H, 3] on `device` (`acc` of a
        world of 1; of a sharded render, gathered or summed over the
        ranks, by kind)."""
        if not self.shard.joined or self.kind in ("sppm", "mlt"):
            return self.acc
        if self.kind in ("pixel", "ir"):
            return self.shard.gather(self.acc[self._lo:self._hi],
                                     self.acc.shape[0])
        return self.shard.reduce(self.acc)

    def place_film(self, whole: torch.Tensor) -> None:
        """Set the film to `whole` [W*H, 3] (a checkpoint's): on a rank
        of a sharded render "film" and "hybrid" keep it on rank 0 only,
        so that their sum over the ranks is `whole` again."""
        self.acc = whole.to(self.device, torch.float32)
        if self.shard.rank > 0 and self.kind in ("film", "hybrid"):
            self.acc = torch.zeros_like(self.acc)

    def radiance(self):
        """Mean radiance film [H, W, 3] numpy (row 0 = bottom)."""
        acc = (self.film() / self._divisor()).cpu().numpy()
        return acc.reshape(self.height, self.width, 3)

    def image(self):
        """Tonemapped display image [H, W, 3] numpy (row 0 = bottom)."""
        img = film_mod.tonemap(self.film(), self._divisor(),
                               self.static.filmic)
        return img.cpu().numpy().reshape(self.height, self.width, 3)
