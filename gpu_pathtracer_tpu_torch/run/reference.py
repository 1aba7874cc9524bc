"""The all-plain reference of a render and the limits it is held to.

A render's first iteration over the CUDA kernels is held against the
same program run all-plain (`plain=True`: every kernel's plain PyTorch
version) at the same seed and iteration, within PERF.md section 2's
radiance limits: |a - b| <= 1e-4 + 1e-3 |b| in every channel on at
least 99% of the rows (of a splatted film: of the pixels either run
touched), and means within 0.1%. The bench (run/bench.py) and
chip_smoke.py hold their renders through this module, and read the
kernels' launch counters through `kernel_stats`. `plain_image` renders
a whole image all-plain: chip_smoke.py's phase G writes its stand-in
goldens with it.
"""

from __future__ import annotations

import contextlib

import torch

ATOL, RTOL = 1e-4, 1e-3    # a row agrees within atol + rtol |b|
AGREE_MIN = 0.99           # share of the rows that must agree
MEAN_RTOL = 1e-3           # the sums' ratio may differ from 1 by this
SLICE_LANES = 65536        # lanes of a sliced reference


def kernel_stats() -> dict:
    """{kernel name: its wrapper's KernelStats}: K1 "dense_hit", K2
    "pt_fused", K3 "blocked", K4 "bvh8_walk", "track" (K5's), "rng"
    (the Philox draws, csrc/rng.cu), "pt_shade" (the PT wavefront's
    shading, csrc/pt_shade.cu), and "vpt_shade" (the VPT step's
    shading), "vpt_tr_round" (its Tr walk's rounds) and "vpt_finish"
    (the last credit and the NaN guard), all three in csrc/vpt_shade.cu,
    and BDPT's "bdpt_start" (vertex 0 and the first ray of both
    subpaths), "bdpt_step" (a subpath step), "bdpt_connect" (the
    connection rounds) and "bdpt_finish" (the queued credits), all four
    in csrc/bdpt.cu."""
    from gpu_pathtracer_tpu_torch.core import rng_cuda
    from gpu_pathtracer_tpu_torch.geom import (
        blocked_cuda, dense_cuda, packet_cuda,
    )
    from gpu_pathtracer_tpu_torch.integrators import (
        bdpt_shade, pt_fused, pt_shade, vpt_shade,
    )
    from gpu_pathtracer_tpu_torch.shade import media_cuda
    return {"dense_hit": dense_cuda.STATS, "pt_fused": pt_fused.STATS,
            "blocked": blocked_cuda.STATS, "bvh8_walk": packet_cuda.STATS,
            "track": media_cuda.STATS, "rng": rng_cuda.STATS,
            "pt_shade": pt_shade.STATS, "vpt_shade": vpt_shade.STATS,
            "vpt_tr_round": vpt_shade.TR_STATS,
            "vpt_finish": vpt_shade.FINISH_STATS,
            "bdpt_start": bdpt_shade.START_STATS,
            "bdpt_step": bdpt_shade.STATS,
            "bdpt_connect": bdpt_shade.CONNECT_STATS,
            "bdpt_finish": bdpt_shade.FINISH_STATS}


def reset_counts(*stats) -> None:
    for st in stats:
        st.launches = st.plain_cuda = 0


def close_frac(a, b) -> float:
    """Share of rows with |a - b| <= ATOL + RTOL |b| in all channels."""
    return ((a - b).abs() <= ATOL + RTOL * b.abs()).all(1) \
        .float().mean().item()


def held(a, b, what: str = "radiance") -> dict:
    """a [N, C] against b, the plain version, within the radiance limits
    (a "film" on the rows either one touched): the rows compared, the
    share that agree and that are bit-equal, the largest difference, the
    ratio of the sums, and whether a is finite and within the limits
    (never for no rows: an empty comparison holds nothing)."""
    if what == "film":
        touched = (a != 0).any(1) | (b != 0).any(1)
        a, b = a[touched], b[touched]
    rows = int(a.shape[0])
    if not rows:
        return {"what": what, "rows": 0, "ok": False}
    frac = close_frac(a, b)
    ratio = a.double().sum().item() / max(b.double().sum().item(), 1e-30)
    return {"what": what, "rows": rows, "agree": frac,
            "bit_equal": (a == b).all(1).float().mean().item(),
            "max_abs_err": (a - b).abs().max().item(), "mean_ratio": ratio,
            "ok": bool(torch.isfinite(a).all()) and frac >= AGREE_MIN
            and abs(ratio - 1.0) <= MEAN_RTOL}


def run_program(integ, scene, static, ids, seed, plain=False, it=1):
    """One sample of program `integ` ("ao", "pt", "vpt", "lt", "bdpt")
    on the lanes (pixel or path indices) `ids` at iteration `it`:
    (per-lane radiance or None, splat film or None, rays traced). `plain`
    runs it all-plain (for "pt", the plain wavefront)."""
    from gpu_pathtracer_tpu_torch.integrators import ao, bdpt, lt, pt, vpt
    px, py = ids % static.width, ids // static.width
    if integ in ("ao", "vpt"):
        program = ao if integ == "ao" else vpt
        li, rays = program.render_lanes(scene, static, seed, it, px, py,
                                        True, plain=plain)
        return li, None, rays
    if integ == "pt":
        if plain:
            li, rays = pt.wavefront(scene, static, seed, it, px, py, True,
                                    plain=True)
        else:
            li, rays = pt.render_lanes(scene, static, seed, it, px, py, True)
        return li, None, rays
    if integ == "lt":
        film, rays = lt.render_film(scene, static, seed, it, ids, True,
                                    plain=plain)
        return None, film, rays
    return bdpt.render_lanes(scene, static, seed, it, px, py, True,
                             plain=plain)


def plain_image(integ, scene, static, seed, spp, factor=1):
    """The tonemapped image (row 0 = bottom) of `spp` iterations of
    program `integ` ("ao", "pt", "vpt", "lt", "bdpt") run all-plain on
    every lane at `seed`: with `factor` 1, [H, W, 3] numpy, what a
    `Renderer` over the kernels shows after `spp` iterations, within the
    radiance limits. With `factor` f > 1, [H / f, W / f, 3]: the film
    averaged over f x f pixel blocks before the tonemap, f^2 x spp
    stratified samples a pixel."""
    from gpu_pathtracer_tpu_torch.film import film as film_mod
    w, h = static.width, static.height
    ids = torch.arange(w * h, device=scene.device, dtype=torch.int32)
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=scene.device)
    for it in range(1, spp + 1):
        li, film, _ = run_program(integ, scene, static, ids, seed,
                                  plain=True, it=it)
        acc += (li if li is not None else 0.0) \
            + (film if film is not None else 0.0)
    h, w = h // factor, w // factor
    acc = acc.reshape(h, factor, w, factor, 3).mean((1, 3)).reshape(-1, 3)
    img = film_mod.tonemap(acc, spp, static.filmic)
    return img.cpu().numpy().reshape(h, w, 3)


def slice_ids(n_pix: int, device, n_lanes: int = SLICE_LANES):
    """`n_lanes` lanes spread evenly over n_pix (all of them when fewer)."""
    return torch.arange(0, n_pix, max(n_pix // n_lanes, 1), device=device,
                        dtype=torch.int32)[:n_lanes]


@contextlib.contextmanager
def tile_radiance(r):
    """While the block runs, keep the per-lane radiance that renderer
    `r`'s tiles return (its "pixel" and "hybrid" programs, whose film
    adds it): yields a [W*H, 3] tensor that the block's iterations add
    their lanes' radiance into, apart from any splatted film."""
    kept = torch.zeros_like(r.acc)
    program = r._program

    def keeping(scene, static, seed, it, px, py, *rest, **kw):
        out = program(scene, static, seed, it, px, py, *rest, **kw)
        kept[(py * r.width + px).long()] += out[0]
        return out

    r._program = keeping
    try:
        yield kept
    finally:
        r._program = program


def plain_reference(integ, r, lanes=None, tile_li=None) -> list:
    """What renderer `r` (its first iteration rendered, not sharded or
    an SPPM or MLT renderer, whose film is whole on every rank) is held
    against: a list of (what, over the kernels, all-plain), each a pair
    of [N, C] tensors for `held`.

    Without `lanes`: r's film against program `integ` all-plain at
    iteration 1 on every lane (per-lane radiance plus splat film, IR's
    camera pass over its own VPL store, SPPM's absolute film, MLT's
    image after one step from the kernels' bootstrap, whose candidates
    are held against their plain evaluation too). With `lanes` (ids of
    pixels or light paths), for programs whose all-plain run on every
    lane would take minutes, against the program all-plain on those
    lanes only: "ao", "pt", "vpt": r's film on those pixels; "bdpt":
    r's per-lane radiance on them (`tile_li`, kept by `tile_radiance`
    around its first iteration), and its splat film from a separate
    pass over the kernels on those lanes; "lt": a separate pass over the
    kernels on those light paths (a path's splats land anywhere, so r's
    film holds every path's)."""
    from gpu_pathtracer_tpu_torch.integrators import ir, mlt, sppm
    scene, static, seed = r.device_scene, r.static, r.seed
    if lanes is not None:
        li_p, film_p, _ = run_program(integ, scene, static, lanes, seed,
                                      plain=True)
        if integ in ("ao", "pt", "vpt"):
            return [("radiance", r.acc[lanes.long()], li_p)]
        _, film_k, _ = run_program(integ, scene, static, lanes, seed)
        if integ == "lt":
            return [("film", film_k, film_p)]
        return [("radiance", tile_li[lanes.long()], li_p),
                ("film", film_k, film_p)]
    n = r.width * r.height
    if integ == "ir":
        vpls = ir.generate_vpls(scene, static, seed, 1, plain=True)
        return [("radiance", r.acc, ir.render_lanes(
            scene, static, seed, 1, r._px, r._py, vpls, 0, plain=True))]
    if integ == "sppm":
        state = sppm.init_state(n, static.init_radius, r.acc.device)
        return [("radiance", r.acc, sppm.render_iteration(
            scene, static, seed, 1, state, r._px, r._py, plain=True)[1])]
    if integ == "mlt":
        cands = mlt.candidates(scene, static, seed, n)
        cands_p = mlt.candidates(scene, static, seed, n, plain=True)
        return [("bootstrap candidates' radiance", cands[1], cands_p[1]),
                ("film", r.acc, mlt.render_iteration(
                    scene, static, seed, 1, mlt.resample(static, cands),
                    plain=True)[1])]
    ids = torch.arange(n, device=r.acc.device, dtype=torch.int32)
    li_p, film_p, _ = run_program(integ, scene, static, ids, seed,
                                  plain=True)
    ref = (li_p if li_p is not None else 0.0) \
        + (film_p if film_p is not None else 0.0)
    return [("film" if integ == "lt" else "radiance", r.acc, ref)]
