"""Bidirectional path tracing.

The port of gpu_pathtracer_tpu/integrators/bdpt.py (the reference BDPT,
pathtracer.cu:1393-1970). Each lane traces one camera subpath and one
light subpath into vertex tables (`Vertices`, K = max_depth + 1
vertices a subpath), then connects them strategy by strategy. A
connection round covers one case over the lane's (lane, strategy)
items, G = K - 1 of them, the strategy's free index being the column:

- s1: light vertex t - 1 to the camera, splatted at its raster pixel
  (t = column + 2);
- t0: camera vertex s - 1 on a light, no shadow ray (s = column + 2);
- t1: camera vertex s - 1 to a new light sample (s = column + 2);
- general: for each s = 2 .. K, camera vertex s - 1 to light vertex
  t - 1 (t = column + 2).

The MIS weight (pathtracer.cu:1690-1718, with the delta remap) runs on
per-iteration suffix tables of each subpath (`_mis_tables`) and the
round's overriding reverse pdfs (`_mis_weight`). Per-lane strategies
(t0, t1, general) add to the lane's own pixel; the s1 strategies splat
into a [W*H, 3] film (the reference's atomicAdd): the "hybrid" kind of
run/renderer.py.

Semantics kept from the JAX package: ConvertPdf's area pdfs; the four
Connect cases with their temporary pdf overrides; no depth of field
(pathtracer.cu:1420-1422); medium vertices scatter by the phase
function and interface crossings (matIdx == -1) consume no bounce, with
INTERFACE_BUDGET extra steps; infinite lights are not connected; the
path capacity is max_depth (the reference walks to 65 vertices).

Shadow connections (t1, s1, general) are thinned by an unbiased Russian
roulette (bdpt_shade.CONNECT_RR, bdpt.py:66-75): a connection whose
unoccluded luminance is below CONNECT_RR x the mean of the valid
connections is
traced with probability q = luminance / (CONNECT_RR x mean) and
weighted 1 / q. Deviation: the mean is the lane's own (over the lane's valid
items of the round), not the round's over all lanes, so a lane's
radiance does not depend on the other lanes of its tile. The surviving
connections wait in a queue of fixed slots a lane (bdpt_shade.Queue); in
a scene without media their shadow rays are one any-hit query over the
whole queue (empty slots have an empty interval, which the hit kernels
skip; the JAX package walks interfaces there too, which only differs
where a material-less prim would be crossed), with media the
interface-walking transmittance of shade/media.py (csrc/track.cu on the
card) over the live slots, one walk for every round.

The work (integrators/bdpt_shade.py): `start` (vertex 0 and the first
ray of both subpaths), per step the closest hit of both subpaths' rays
as 2N rows of one call (K1, K3 or K4 by the scene's regime), their
sample walk (heterogeneous media: shade/media.py::track) and `step`;
then `connect`, the queue's shadow rays and `finish`. On CUDA tensors
`start`, `step`, `connect` and `finish` launch csrc/bdpt.cu, no masked
PyTorch op runs between the kernels (the hit wrappers' own apart), every
step runs (finished rows get an empty interval) and no round syncs with
the host (with media, one read of the queue's live slots a sample); on
CPU tensors, or with `plain`, the plain versions run and the steps stop
once no row is alive, which changes no result.

Not ported, as TPU workarounds: COLUMN_BLOCKS (a knob measured
perf-neutral), KNOCK (test-only), and the lane-compaction ladder and Tr
work-queue chunks of `media_mod._compact_partition`.

Random numbers (core/rng.py): the lane id is the pixel index, for the
camera subpath and for the light subpath alike (one light path per
lane), so an image does not depend on tiling.
- Camera subpath, tag 0: sites 0-1 the pixel jitter; step s reads
  EMIT_DIMS + STEP_DIMS s + k: k = 0-2 the BSDF's u1-u3, 3 Russian
  roulette, 4-5 the phase sample, 6 the homogeneous distance sample.
- Light subpath, tag BDPT_LIGHT_TAG: sites 0-4 the emission (light
  pick, triangle u, v, direction u1, u2); steps as the camera's.
- Connection round p (s1 1, t0 2, t1 3, general 4 + s - 2), tag
  BDPT_CONNECT_TAG, item (lane, column g) keyed 32 lane + g: sites
  4 p + k. The t1 round reads k = 0-2 (the light sample's pick, u, v)
  and its roulette at k = 3; the s1 and general rounds read their
  roulette at k = 0; t0 reads none.
- Tracking walks: track_tag(s + 1, TRACK_SAMPLE) on the camera subpath
  and track_tag(s + 1, TRACK_LIGHT_PATH) on the light subpath, keyed by
  the lane; connection round p's transmittance at track_tag(p,
  TRACK_CAMERA) (s1) or track_tag(p, TRACK_CONNECT), keyed by the item.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.core.rng import (
    TRACK_CAMERA, TRACK_CONNECT, TRACK_LIGHT_PATH, TRACK_SAMPLE, track_tag,
)
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators import bdpt_shade
# the MIS helpers and the tables, under the names the tests compare with
# the JAX package's
from gpu_pathtracer_tpu_torch.integrators.bdpt_shade import (  # noqa: F401
    ITEM_LANES, _convert_pdf, _mis_tables, _mis_weight, empty_vertices,
)
from gpu_pathtracer_tpu_torch.integrators.common import shadow_transmittance
from gpu_pathtracer_tpu_torch.integrators.pt import lane_ids_of
from gpu_pathtracer_tpu_torch.shade import media as media_mod
from gpu_pathtracer_tpu_torch.shade.media import TrackKey

INTERFACE_BUDGET = 8
PLAIN_SHADOW_RAYS = 1 << 20   # the plain route's shadow rays a call
# a call's queue slots at most (35 a lane at depth 5, 323 at depth 17):
# more lanes run in chunks, each lane's result the same
QUEUE_SLOTS = 1 << 26


def walk_sites(n: int, device):
    """The sample walk's call site of each of the 2N subpath rows
    (TrackKey.sites): TRACK_SAMPLE on the camera rows, TRACK_LIGHT_PATH
    on the light rows."""
    return torch.cat([torch.full((n,), TRACK_SAMPLE, dtype=torch.int32,
                                 device=device),
                      torch.full((n,), TRACK_LIGHT_PATH, dtype=torch.int32,
                                 device=device)])


def slot_keys(lanes, g: int, sel):
    """The Tr walk's key fields of queue slots `sel` (flat indices into
    [S, N]): (items 32 lane + column, int64; sites, int32: the round's
    step and call site, so that TrackKey(.., tag=0, sites) draws each
    slot at track_tag(p, site) of its round p)."""
    n = lanes.shape[0]
    j, i = sel // n, sel % n
    gen = j >= 2 * g
    col = torch.where(gen, (j - 2 * g) % g, j % g)
    p = torch.where(j < g, 1, torch.where(gen, 4 + (j - 2 * g) // g, 3))
    site = torch.where(j < g, TRACK_CAMERA, TRACK_CONNECT)
    items = lanes.long()[i] * ITEM_LANES + col
    return items, (((p + 1) << 4) | site).to(torch.int32)


def shadow(scene, static, seed, iteration, lanes, q: bdpt_shade.Queue, rays,
           plain=False):
    """The queue's shadow rays: without media the any-hit verdicts
    (occluded bool [S * N]), with media the interface-walking
    transmittance of the live slots (tr [S * N, 3], 1 elsewhere; each slot
    draws at its round's tag). On CUDA tensors without media one any-hit
    call covers every slot (empty slots have tmax 0, so no host sync),
    with media one nonzero and one walk; the plain route traces the live
    slots alone, PLAIN_SHADOW_RAYS at a time (its hit test's temporaries
    grow with rays x prims). `rays` gets the walk's segment rays."""
    s, n = q.live.shape
    o, d = q.o.reshape(-1, 3), q.d.reshape(-1, 3)
    tmax, live = q.tmax.reshape(-1), q.live.reshape(-1)
    on_card = o.is_cuda and not plain
    if on_card and not static.has_media:
        return traverse.intersect_any(scene, static, o, d, scene.epsilon,
                                      tmax)
    sel = live.nonzero()[:, 0]
    step = max(sel.shape[0], 1) if on_card else PLAIN_SHADOW_RAYS
    out = torch.ones((s * n, 3), device=o.device) if static.has_media \
        else torch.zeros_like(live)
    for c in range(0, sel.shape[0], step):
        sl = sel[c:c + step]
        if not static.has_media:
            out[sl] = traverse.intersect_any(scene, static, o[sl], d[sl],
                                             scene.epsilon, tmax[sl], plain)
            continue
        items, sites = slot_keys(lanes, q.pix.shape[0], sl)
        out[sl], r = shadow_transmittance(
            scene, static, q.med.reshape(-1)[sl], o[sl], d[sl], tmax[sl],
            TrackKey(seed, iteration, items, 0, sites),
            torch.ones(sl.shape[0], dtype=torch.bool, device=o.device),
            plain)
        rays += r
    return out


def render_lanes(scene, static, seed: int, iteration: int, pixel_x, pixel_y,
                 with_stats: bool = False, plain: bool = False):
    """One BDPT sample per lane. Returns (li [N, 3], film [W*H, 3]): li
    holds the s >= 2 strategies for the lane's own pixel, the film the
    s == 1 splats (the Bdpt kernel, pathtracer.cu:1933-1970); with_stats
    also the rays traced (the subpaths' closest hits and Tr segments and
    the connections' shadow rays), 0-d int64. `plain` runs the plain
    intersection, tracking and per-lane work on any device. Lanes whose
    queue would pass QUEUE_SLOTS run in chunks (their films added)."""
    n_verts = static.max_depth + 1
    if n_verts - 1 >= ITEM_LANES:
        raise ValueError(f"BDPT takes max_depth < {ITEM_LANES}")
    chunk = max(QUEUE_SLOTS // bdpt_shade.n_slots(n_verts - 1), 1)
    parts = [_render_chunk(scene, static, seed, iteration,
                           pixel_x[c:c + chunk], pixel_y[c:c + chunk],
                           n_verts, plain)
             for c in range(0, max(pixel_x.shape[0], 1), chunk)]
    li = torch.cat([x[0] for x in parts])
    film, rays = parts[0][1], parts[0][2]
    for _, f, r in parts[1:]:
        film += f
        rays += r
    if with_stats:
        return li, film, rays
    return li, film


def _render_chunk(scene, static, seed, iteration, pixel_x, pixel_y, n_verts,
                  plain):
    """`render_lanes` on lanes whose queue fits: (li, film, rays). Spans
    (telemetry): "bdpt.start", per step "bdpt.hit" (the closest hit and
    the sample walk) and "bdpt.step", then "bdpt.connect",
    "bdpt.shadow" and "bdpt.finish"."""
    with telemetry.span("bdpt.start"):
        lanes = lane_ids_of(static, pixel_x, pixel_y)
        n = lanes.shape[0]
        dev = lanes.device
        gate = plain or not lanes.is_cuda
        v, w = bdpt_shade.start(scene, static, seed, iteration, lanes,
                                pixel_x, pixel_y, n_verts, plain)
        rays = torch.zeros((), dtype=torch.int64, device=dev)
        if static.has_hetero:
            lanes2, sites2 = torch.cat([lanes, lanes]), walk_sites(n, dev)
    n_steps = (n_verts - 1) + (INTERFACE_BUDGET if static.has_media else 0)
    for step in range(n_steps):
        if gate and not bool(w.alive.any()):
            break
        # finished rows get an empty interval (tmax 0): the hit kernels
        # leave them at once
        with telemetry.span("bdpt.hit", step):
            t, prim, _ = traverse.closest_prim(scene, static, w.ro, w.rd,
                                               scene.epsilon, w.tmax, plain)
            found_t = None
            if static.has_hetero:   # delta tracking's first collision
                found_t, _ = media_mod.track(
                    scene, static, media_mod.MODE_SAMPLE, w.med_sample,
                    w.ro, w.rd, t, TrackKey(seed, iteration, lanes2,
                                            track_tag(step + 1, 0), sites2),
                    plain)
        with telemetry.span("bdpt.step", step):
            bdpt_shade.step(scene, static, step, seed, iteration, lanes, t,
                            prim, found_t, v, w, rays, plain)
    with telemetry.span("bdpt.connect"):
        if static.n_lights == 0:   # no light subpath without an area light
            v.count[n:] = 0
        li, q = bdpt_shade.connect(scene, static, seed, iteration, lanes, v,
                                   rays, plain)
    with telemetry.span("bdpt.shadow"):
        occ = shadow(scene, static, seed, iteration, lanes, q, rays, plain)
    with telemetry.span("bdpt.finish"):
        li, film = bdpt_shade.finish(li, q, occ,
                                     static.width * static.height, plain)
    return li, film, rays
