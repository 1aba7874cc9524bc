"""BDPT's per-lane work, as CUDA kernels around the hit kernels.

integrators/bdpt.py::render_lanes walks the camera subpath and the light
subpath of every lane together, as the 2N rows of one walk: row i < N is
lane i's camera subpath (radiance transport, its draws at tag 0), row
N + i its light subpath (importance transport, tag BDPT_LIGHT_TAG). The
vertex tables (`Vertices`, [2N, K]) hold both; `Walker` holds the rows'
state between steps.

- `start`: vertex 0 and the first ray of both subpaths (the camera's
  jittered primary ray, the light's emitted point and direction), every
  slot of the tables written.
- `step`: one step of the walk (bdpt.py's `_generate_subpath` loop body,
  pathtracer.cu:1415-1690), after the step's closest hit of the 2N rays
  and, with heterogeneous media, their sample walk: the medium sample's
  weight, a scatter vertex and its phase sample, the interface crossing,
  a surface vertex and its BSDF sample, the previous vertex's reverse
  pdf, the next medium, the vertex count and the roulette. It writes
  each row's vertex into the tables in place.
- `connect`: every connection round of a lane (s1, t0, t1 and the
  general rounds s = 2 .. K, pathtracer.cu:1690-1927): the MIS suffix
  tables, the four cases with their pdf overrides, the MIS weight and the
  roulette against the lane's mean. t0 is credited at once; each other
  connection that survives its roulette waits in a `Queue` slot with its
  shadow ray and its credit L.
- `finish`: after the queue's shadow rays, L x tr into the lane's
  radiance round by round (each round's columns summed in order, then
  added), the s1 credits splatted into the [W*H, 3] film at their raster
  pixel, then the NaN guard. The kernel walks the slots in that order, a
  thread for four neighbouring lanes, each slot's flags, credits,
  verdicts and pixels of the four loaded as vectors.

On CUDA tensors `start`, `step`, `connect` and `finish` launch
csrc/bdpt.cu and count the launch in `START_STATS` (bdpt_start), `STATS`
(bdpt_step), `CONNECT_STATS` (bdpt_connect) or `FINISH_STATS`
(bdpt_finish); they raise on what the kernel does not take and have no
fallback. `start_torch`, `step_torch`, `connect_torch` and
`finish_torch`, their plain versions (bdpt.py's masked PyTorch,
regrouped but not rewritten), run for CPU tensors and under
`plain=True`, and count their calls on CUDA tensors in `plain_cuda`.

Fixed summation order: a round's columns add in column order (the
plain version's `.sum(1)` before), as do the values of the roulette's
lane mean, so the kernel's per-lane radiance is the plain version's bit
for bit. The film's adds are atomic on the card (an accumulating
`index_put_` in the plain version), equal within float32 summation
order.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from gpu_pathtracer_tpu_torch import kernels
from gpu_pathtracer_tpu_torch.core.rng import (
    BDPT_CONNECT_TAG, BDPT_LIGHT_TAG, MASK32, PhiloxStream, philox_uniform,
)
from gpu_pathtracer_tpu_torch.core.vecmath import (
    dot, is_black, luminance, normalize,
)
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.geom.dense import kinds_of
from gpu_pathtracer_tpu_torch.kernels import (
    KernelStats, check_cuda_f32, check_launch, load_library,
)
from gpu_pathtracer_tpu_torch.scene.flatten import MED_COLS
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import camera as camera_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod
from gpu_pathtracer_tpu_torch.shade import media as media_mod
from gpu_pathtracer_tpu_torch.shade.lights import n_light_rows

START_STATS = KernelStats()     # bdpt_start
STATS = KernelStats()           # bdpt_step
CONNECT_STATS = KernelStats()   # bdpt_connect
FINISH_STATS = KernelStats()    # bdpt_finish

CONNECT_RR = 1.0    # shadow-connection roulette threshold (0 disables)
EMIT_DIMS = 8       # sites before a subpath's first step
STEP_DIMS = 8       # sites per subpath step (7 read)
ITEM_LANES = 32     # item id = 32 lane + column: columns < 32
CONNECT_DIMS = 4    # sites per item per connection round


@dataclass
class Vertices:
    """SoA subpath vertex storage (BdptVertex, pathtracer.cu:1395-1402).
    Each table is an [R, K, ...] view of vertex-major storage, a
    contiguous [K, R, ...] tensor (`empty_vertices`): the kernels address
    vertex m of row r as slot m R + r. A step writes vertex `count`
    whole, every field, so the slots below a row's count never depend on
    what the tables held before; the slots at or above it are read by no
    result, and the kernels leave them unwritten."""
    pos: torch.Tensor        # [R, K, 3]
    nor: torch.Tensor        # [R, K, 3] zero for medium vertices
    uv: torch.Tensor         # [R, K, 2]
    dpdu: torch.Tensor       # [R, K, 3]
    beta: torch.Tensor       # [R, K, 3]
    fwd: torch.Tensor        # [R, K] forward area pdf
    rev: torch.Tensor        # [R, K] reverse area pdf
    delta: torch.Tensor      # [R, K] bool
    mat_idx: torch.Tensor    # [R, K] i32 (-1: medium vertex)
    light_idx: torch.Tensor  # [R, K] i32
    medium: torch.Tensor     # [R, K] i32 the medium the vertex sits in
    count: torch.Tensor      # [R] i32 valid vertices


def empty_vertices(n: int, k: int, device) -> Vertices:
    """n rows of k empty vertices (count 0), vertex-major."""
    def z(*shape, dtype=torch.float32, fill=0):
        return torch.full((k, n) + shape, fill, dtype=dtype,
                          device=device).transpose(0, 1)
    return Vertices(
        pos=z(3), nor=z(3), uv=z(2), dpdu=z(3), beta=z(3), fwd=z(), rev=z(),
        delta=z(dtype=torch.bool), mat_idx=z(dtype=torch.int32, fill=-1),
        light_idx=z(dtype=torch.int32, fill=-1),
        medium=z(dtype=torch.int32, fill=-1),
        count=torch.zeros(n, dtype=torch.int32, device=device))


def rows(v: Vertices, lo: int, hi: int) -> Vertices:
    """The tables of rows lo .. hi - 1 (views)."""
    return Vertices(*(getattr(v, f)[lo:hi] for f in Vertices.__annotations__))


@dataclass
class Walker:
    """The 2N subpath rows' state between steps."""
    ro: torch.Tensor          # [2N, 3] the next ray
    rd: torch.Tensor          # [2N, 3]
    beta: torch.Tensor        # [2N, 3] the path throughput
    forward: torch.Tensor     # [2N] the next ray's solid-angle pdf
    med: torch.Tensor         # [2N] int32 the medium it starts in
    alive: torch.Tensor       # [2N] bool: the row steps again
    tmax: torch.Tensor        # [2N] the next closest hit's: inf alive, else 0
    med_sample: torch.Tensor | None   # [2N] int32 the next sample walk's
    #                                   medium, -1 none; None without
    #                                   heterogeneous media


@dataclass
class Queue:
    """The connections that wait for a shadow ray: slot j of lane i at
    [j, i]. Slots 0 .. G - 1 are the s1 round's columns, G .. 2G - 1
    t1's, then G for each general round s = 2 .. K (`slot0`)."""
    live: torch.Tensor        # [S, N] bool: survived its roulette
    o: torch.Tensor           # [S, N, 3] the shadow ray (live slots)
    d: torch.Tensor           # [S, N, 3]
    tmax: torch.Tensor        # [S, N]: 0 where not live
    L: torch.Tensor           # [S, N, 3] the credit (live slots)
    med: torch.Tensor | None  # [S, N] i32 the medium at o; None without
    pix: torch.Tensor         # [G, N] i32 the s1 slots' raster pixel


def n_slots(g: int) -> int:
    """Queue slots a lane: s1 and t1 G each, G general rounds of G."""
    return g * (g + 2)


def slot0(case: str, g: int, s: int = 2) -> int:
    """The first slot of round `case` ("s1", "t1" or general round s)."""
    return {"s1": 0, "t1": g}.get(case, 2 * g + (s - 2) * g)


def _lane_set(arr, mask, idx, val):
    """arr[lane, idx[lane]] = val[lane] where mask[lane], in place."""
    lanes = torch.arange(arr.shape[0], device=arr.device)
    idx = torch.clamp(idx, 0, arr.shape[1] - 1).long()
    cur = arr[lanes, idx]
    m = mask.reshape(mask.shape + (1,) * (val.dim() - mask.dim()))
    arr[lanes, idx] = torch.where(m, val, cur)


def _lane_get(arr, idx):
    """arr[lane, idx[lane]], idx clipped into range."""
    lanes = torch.arange(arr.shape[0], device=arr.device)
    return arr[lanes, torch.clamp(idx, 0, arr.shape[1] - 1).long()]


def _set_vertex(v: Vertices, mask, **vals):
    """Write the fields `vals` of vertex v.count on the rows of mask."""
    for name, val in vals.items():
        _lane_set(getattr(v, name), mask, v.count, val)


def _convert_pdf(pdf, from_pos, to_pos, to_nor):
    """ConvertPdf (pathtracer.cu:1405-1414): a solid-angle pdf at `from`
    as an area pdf at `to` (no cosine at a medium vertex: zero normal)."""
    d = from_pos - to_pos
    d2 = torch.clamp_min(dot(d, d), 1e-30)
    ret = pdf / d2
    cos = torch.abs(dot(d / torch.sqrt(d2)[..., None], to_nor))
    return torch.where(dot(to_nor, to_nor) > 0.0, ret * cos, ret)


def _remap(x):
    """Delta pdfs are stored as 0; MIS remaps them to 1
    (pathtracer.cu:1695-1697)."""
    return torch.where(x == 0.0, 1.0, x)


def _mis_tables(v: Vertices, lo: int):
    """The override-free MIS suffix tables of one subpath, once per
    iteration (bdpt.py:379-407): with r_j = remap(rev_j) / remap(fwd_j)
    and ok_i = not delta_i and not delta_(i-1),
        A[m] = r_m (ok_m + A[m - 1]),
    so a round's sum over a subpath is rebuilt from its last two
    (overridden) terms and A. lo = 1 drops vertex 0 (the camera).
    Returns (ok [N, K] float 0/1, A [N, K])."""
    r = _remap(v.rev) / _remap(v.fwd)
    dprev = torch.cat([v.delta[:, :1], v.delta[:, :-1]], 1)
    ok = (~v.delta & ~dprev).float()
    if lo == 1:
        ok[:, 0] = 0.0
    acc = torch.zeros(r.shape[0], device=r.device)
    cols = []
    for m in range(r.shape[1]):
        acc = r[:, m] * (ok[:, m] + acc)
        cols.append(acc)
    return ok, torch.stack(cols, 1)


def _colv(arr, i):
    """Columns i of a [N, K] table, clipped into range: [N, 1] for an
    int, [N, G] for an index tensor [1, G]."""
    k = arr.shape[1]
    if isinstance(i, int):
        c = min(max(i, 0), k - 1)
        return arr[:, c:c + 1]
    return arr[:, torch.clamp(i.reshape(-1), 0, k - 1)]


def _where(cond, a, b):
    """torch.where with a Python bool or a bool tensor condition."""
    if isinstance(cond, bool):
        return a if cond else torch.as_tensor(b, device=a.device).expand_as(a)
    return torch.where(cond, a, b)


def _mis_weight(cam_fwd, cam_ok, cam_A, light_fwd, light_ok, light_A,
                s, t, c1_rev, c2_rev, l1_rev, l2_rev, l0_fwd):
    """The MIS weight (pathtracer.cu:1690-1718) from the suffix tables
    of `_mis_tables` and a round's overriding pdfs: c1 / c2 replace the
    camera side's rev at s - 1 / s - 2, l1 / l2 the light side's at
    t - 1 / t - 2, l0_fwd the light side's fwd[0] when t == 1 (NaN: no
    override; every NaN slot is masked by an index guard). s / t are
    ints or index tensors [1, G]; the overrides are [N, G]. Returns
    [N, G]."""
    def pick(arr, i, lo):
        return _where(i >= lo, _colv(arr, i), 0.0)

    # the camera side: terms exist for i in [1, s - 1]
    r_e = _where(s - 1 >= 1, _remap(c1_rev) / _remap(_colv(cam_fwd, s - 1)),
                 0.0)
    r_e1 = _where(s - 2 >= 1,
                  _remap(c2_rev) / _remap(_colv(cam_fwd, s - 2)), 0.0)
    sum_w = r_e * (pick(cam_ok, s - 1, 1)
                   + r_e1 * (pick(cam_ok, s - 2, 1) + pick(cam_A, s - 3, 1)))

    # the light side: terms exist for i in [0, t - 1]
    f_e = _colv(light_fwd, t - 1)
    if isinstance(t, int) and t == 1:
        f_e = l0_fwd
    r_le = _where(t - 1 >= 0, _remap(l1_rev) / _remap(f_e), 0.0)
    r_le1 = _where(t - 2 >= 0,
                   _remap(l2_rev) / _remap(_colv(light_fwd, t - 2)), 0.0)
    sum_w = sum_w + r_le * (pick(light_ok, t - 1, 0)
                            + r_le1 * (pick(light_ok, t - 2, 0)
                                       + pick(light_A, t - 3, 0)))
    w = 1.0 / (1.0 + sum_w)
    return _where(s + t == 2, torch.ones_like(w), w)


def _cols_sum(x):
    """x [N, G, ...] summed over its columns in column order."""
    acc = x[:, 0]
    for g in range(1, x.shape[1]):
        acc = acc + x[:, g]
    return acc


def _on_card(x) -> bool:
    """Whether `x` lies on a CUDA device (the wrappers' route)."""
    return x.device.type == "cuda"


# ---------------------------------------------------------------------------
# the start: vertex 0 and the first ray of both subpaths
# ---------------------------------------------------------------------------
def start(scene, static, seed, iteration, lanes, pixel_x, pixel_y, n_verts,
          plain=False):
    """GenerateCameraPath's and GenerateLightPath's vertex 0 and first
    ray (pathtracer.cu:1415-1440, 1553-1580; no depth of field), as rows
    0 .. N - 1 and N .. 2N - 1. Returns (Vertices [2N, n_verts],
    Walker). The kernel on CUDA tensors, else (or under `plain`)
    `start_torch`."""
    if plain or not _on_card(lanes):
        return start_torch(scene, static, seed, iteration, lanes, pixel_x,
                           pixel_y, n_verts, plain)
    return start_cuda(scene, static, seed, iteration, lanes, pixel_x,
                      pixel_y, n_verts)


def start_torch(scene, static, seed, iteration, lanes, pixel_x, pixel_y,
                n_verts, plain=True):
    """The plain version of `start`: camera_subpath's and light_subpath's
    vertex 0 and first ray, written into the rows of one table."""
    if lanes.is_cuda:
        START_STATS.plain_cuda += 1
    n = lanes.shape[0]
    dev = lanes.device
    eps = scene.epsilon
    cam = scene.camera
    rng = PhiloxStream(seed, iteration, lanes, 0, EMIT_DIMS, plain=plain)
    ox = rng.uniform() - 0.5
    oy = rng.uniform() - 0.5
    cam_ro, cam_rd = camera_mod.generate_primary_ray(
        cam, pixel_x.float() + ox, pixel_y.float() + oy,
        torch.zeros((n, 2), device=dev), static.environment_camera)
    _, cam_fwd = camera_mod.pdf_camera(cam, cam_rd)
    cam_med = torch.full((n,), static.camera_medium, dtype=torch.int32,
                         device=dev)

    rng = PhiloxStream(seed, iteration, lanes, 0, EMIT_DIMS, BDPT_LIGHT_TAG,
                       plain)
    light_idx, choice_pdf = lights_mod.pick_light(scene, rng.uniform())
    light_idx = torch.clamp_max(light_idx, max(static.n_lights - 1, 0))
    u1, u2, u3 = rng.uniform3()
    u4 = rng.uniform()
    l_ro, l_rd, l_nor, radiance, pdf_a, pdf_w = \
        lights_mod.sample_area_light_emission(scene, light_idx, u1, u2, u3,
                                              u4, eps)
    l_med = scene.l_medium[light_idx.long()] if static.has_media else \
        torch.full((n,), -1, dtype=torch.int32, device=dev)
    denom = torch.clamp_min(pdf_a * pdf_w * choice_pdf, 1e-30)
    l_beta = radiance * (torch.abs(dot(l_rd, l_nor)) / denom)[:, None]

    v = empty_vertices(2 * n, n_verts, dev)
    v.pos[:n, 0] = cam.position
    v.nor[:n, 0] = -cam.w
    v.beta[:n, 0] = 1.0
    v.fwd[:n, 0] = 1.0
    v.medium[:n, 0] = cam_med
    v.pos[n:, 0] = l_ro
    v.nor[n:, 0] = l_nor
    v.beta[n:, 0] = radiance
    v.fwd[n:, 0] = pdf_a * choice_pdf
    v.light_idx[n:, 0] = light_idx
    v.medium[n:, 0] = l_med
    v.count += 1
    med = torch.cat([cam_med, l_med])
    med_sample = None
    if static.has_hetero:
        m = media_mod.gather_medium(scene, med)
        med_sample = torch.where(
            (med >= 0) & (m["type"] == media_mod.HETEROGENEOUS), med, -1)
    return v, Walker(
        torch.cat([cam_ro, l_ro]), torch.cat([cam_rd, l_rd]),
        torch.cat([torch.ones((n, 3), device=dev), l_beta]),
        torch.cat([cam_fwd, pdf_w]), med,
        torch.ones(2 * n, dtype=torch.bool, device=dev),
        torch.full((2 * n,), torch.inf, device=dev), med_sample)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------
def step(scene, static, step_, seed, iteration, lanes, t, prim, found_t,
         v: Vertices, w: Walker, rays=None, plain=False):
    """Step `step_` of the 2N subpath rows after their closest hit (t,
    prim; prim -1 on a miss) and, with heterogeneous media, their sample
    walk's first collision `found_t`; writes the tables `v` and the rows'
    state `w` in place and adds the rows alive at the step's start to
    `rays` (0-d int64). The kernel on CUDA tensors, else (or under
    `plain`) `step_torch`."""
    if plain or not _on_card(w.ro):
        return step_torch(scene, static, step_, seed, iteration, lanes, t,
                          prim, found_t, v, w, rays, plain)
    return step_cuda(scene, static, step_, seed, iteration, lanes, t, prim,
                     found_t, v, w, rays)


def connect(scene, static, seed, iteration, lanes, v: Vertices, rays=None,
            plain=False):
    """Every connection round of each lane over the tables `v` ([2N, K]).
    Returns (li [N, 3]: the t0 strategies, Queue); without media `rays`
    gets the queued shadow rays."""
    if plain or not _on_card(v.pos):
        return connect_torch(scene, static, seed, iteration, lanes, v, rays,
                             plain)
    return connect_cuda(scene, static, seed, iteration, lanes, v, rays)


def finish(li, q: Queue, shadow, n_pix: int, plain=False):
    """The queued credits after their shadow rays (`shadow`: occluded
    bool [S * N] without media, tr [S * N, 3] with): (li [N, 3] after the
    NaN guard, film [n_pix, 3] of the s1 splats)."""
    if plain or not _on_card(li):
        return finish_torch(li, q, shadow, n_pix)
    return finish_cuda(li, q, shadow, n_pix)


def _step_draws(seed, iteration, lanes, step_, plain):
    """The step's 8 sites of both subpaths, [8, 2N]: rows 0-2 the BSDF's
    u1-u3, 3 the roulette, 4-5 the phase sample, 6 the homogeneous
    distance sample (7 unread)."""
    lanes = lanes.to(torch.int64) & MASK32
    blk = (EMIT_DIMS + step_ * STEP_DIMS) >> 2
    return torch.cat([philox_uniform(lanes, blk, 2, tag, seed, iteration,
                                     plain)
                      for tag in (0, BDPT_LIGHT_TAG)], 1)


def step_torch(scene, static, step_, seed, iteration, lanes, t, prim,
               found_t, v: Vertices, w: Walker, rays=None, plain=True):
    """The plain version of `step`: the loop body of bdpt.py's
    `_generate_subpath` over both subpaths' rows."""
    if w.ro.is_cuda:
        STATS.plain_cuda += 1
    n2 = w.ro.shape[0]
    dev = w.ro.device
    u = _step_draws(seed, iteration, lanes, step_, plain)
    u_bsdf, u_rr = (u[0], u[1], u[2]), u[3]
    light_row = torch.arange(n2, device=dev) >= n2 // 2
    ro, rd, beta, forward, med = w.ro, w.rd, w.beta, w.forward, w.med
    alive = w.alive
    if rays is not None:
        rays += alive.sum()
    hit = traverse._hit_attributes(scene, static, ro, rd, t, prim, prim >= 0)
    alive = alive & hit.valid
    zeros3 = torch.zeros((n2, 3), device=dev)
    neg1 = torch.full((n2,), -1, dtype=torch.int32, device=dev)

    prev_idx = v.count - 1
    prev_pos = _lane_get(v.pos, prev_idx)
    prev_nor = _lane_get(v.nor, prev_idx)

    # ---- medium scattering vertex (pathtracer.cu:1603-1630) ------------
    if static.has_media:
        pu1, pu2, u0 = u[4], u[5], u[6]
        weight, t_med, sampled = media_mod.sample_weight(
            scene, static, med, hit.t, u0, found_t, alive)
        beta = torch.where(alive[:, None], beta * weight, beta)
        alive = alive & ~is_black(beta)
        in_scatter = alive & sampled
        sample_pos = ro + rd * t_med[:, None]
        new_dir, ph = media_mod.sample_phase(scene, med, -rd, pu1, pu2)
        fwd_m = _convert_pdf(forward, prev_pos, sample_pos, zeros3)
        _set_vertex(v, in_scatter, pos=sample_pos, nor=zeros3,
                    uv=zeros3[:, :2], dpdu=zeros3, beta=beta, fwd=fwd_m,
                    rev=zeros3[:, 0], delta=torch.zeros_like(in_scatter),
                    mat_idx=neg1, light_idx=neg1, medium=med)
        rev_m = _convert_pdf(ph, sample_pos, prev_pos, prev_nor)
        _lane_set(v.rev, in_scatter, prev_idx, rev_m)
        forward = torch.where(in_scatter, ph, forward)
        ro = torch.where(in_scatter[:, None], sample_pos, ro)
        rd = torch.where(in_scatter[:, None], new_dir, rd)
    else:
        in_scatter = torch.zeros_like(alive)

    # ---- interface crossing: no bounce (pathtracer.cu:1632-1639) -------
    on_surface = alive & ~in_scatter
    interface = on_surface & (hit.mat_idx == -1)
    going_out = dot(rd, hit.nor) > 0.0
    med = torch.where(interface, torch.where(
        going_out, hit.medium_outside, hit.medium_inside), med)
    ro = torch.where(interface[:, None], hit.pos, ro)
    surf = on_surface & ~interface

    # ---- surface vertex (pathtracer.cu:1641-1676) ----------------------
    mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
    delta = bsdf_mod.is_delta(mat.type)
    fwd_s = _convert_pdf(forward, prev_pos, hit.pos, hit.nor)
    _set_vertex(v, surf, pos=hit.pos, nor=hit.nor, uv=hit.uv, dpdu=hit.dpdu,
                beta=beta, fwd=fwd_s, rev=zeros3[:, 0], delta=delta,
                mat_idx=hit.mat_idx, light_idx=hit.light_idx, medium=med)

    # camera rows sample in radiance mode, light rows in importance mode
    wo, fr, pdf = bsdf_mod.sample_bsdf(
        mat, -rd, hit.nor, hit.dpdu, *u_bsdf, static.material_types,
        bsdf_mod.RADIANCE)
    wo_i, fr_i, pdf_i = bsdf_mod.sample_bsdf(
        mat, -rd, hit.nor, hit.dpdu, *u_bsdf, static.material_types,
        bsdf_mod.IMPORTANCE)
    wo = torch.where(light_row[:, None], wo_i, wo)
    fr = torch.where(light_row[:, None], fr_i, fr)
    pdf = torch.where(light_row, pdf_i, pdf)
    dead = surf & (is_black(fr) | (pdf <= 0.0))
    alive = alive & ~dead
    surf_go = surf & ~dead
    beta_next = beta * fr * torch.abs(dot(wo, hit.nor))[:, None] \
        / torch.clamp_min(pdf, 1e-30)[:, None]
    beta = torch.where(surf_go[:, None], beta_next, beta)
    forward = torch.where(surf_go, torch.where(delta, 0.0, pdf), forward)

    # the reverse pdf of the previous vertex (pathtracer.cu:1666-1671)
    _, pdf_r = bsdf_mod.eval_bsdf(mat, wo, -rd, hit.nor, hit.dpdu,
                                  static.material_types)
    rev_s = _convert_pdf(pdf_r, hit.pos, prev_pos, prev_nor)
    _lane_set(v.rev, surf_go, prev_idx, rev_s)

    out_side = torch.where(dot(wo, hit.nor) > 0.0, hit.medium_outside,
                           hit.medium_inside)
    same_side = dot(-rd, hit.nor) * dot(wo, hit.nor) > 0.0
    med = torch.where(surf_go, torch.where(same_side, med, out_side), med)
    ro = torch.where(surf_go[:, None], hit.pos, ro)
    rd = torch.where(surf_go[:, None], wo, rd)

    consumed = in_scatter | surf
    v.count = torch.where(consumed, v.count + 1, v.count)

    # Russian roulette (pathtracer.cu:1679-1686); the bounces so far are
    # the vertices after vertex 0
    rr_pdf = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
    do_rr = alive & (in_scatter | surf_go) & (v.count - 1 > 4)
    alive = alive & ~(do_rr & (u_rr < rr_pdf))
    scale = 1.0 / torch.clamp_min(1.0 - rr_pdf, 1e-30)
    beta = torch.where((do_rr & alive)[:, None], beta * scale[:, None], beta)

    # the next step's rows: alive with room for a vertex
    alive = alive & (v.count < v.pos.shape[1])
    w.ro, w.rd, w.beta, w.forward, w.med, w.alive = (ro, rd, beta, forward,
                                                     med, alive)
    w.tmax = torch.where(alive, torch.inf, 0.0)
    if static.has_hetero:
        m = media_mod.gather_medium(scene, med)
        w.med_sample = torch.where(
            alive & (med >= 0) & (m["type"] == media_mod.HETEROGENEOUS), med,
            -1)


class _Round:
    """The state shared by a sample's connection rounds (bdpt.py's
    connection code before the regrouping)."""

    def __init__(self, scene, static, seed, iteration, lanes, cam_v, light_v,
                 plain):
        self.scene, self.static = scene, static
        self.seed, self.iteration = seed, iteration
        self.cam_v, self.light_v = cam_v, light_v
        self.plain = plain
        self.n = lanes.shape[0]
        self.dev = lanes.device
        self.G = cam_v.pos.shape[1] - 1
        self.items = (lanes.long()[:, None] * ITEM_LANES + torch.arange(
            self.G, device=self.dev)).reshape(-1)
        self.mis6 = (cam_v.fwd, *_mis_tables(cam_v, 1),
                     light_v.fwd, *_mis_tables(light_v, 0))

    def surf_or_phase(self, is_med, med_idx, mat, nor, dpdu, w_in, w_out):
        """fr and the forward pdf at a vertex: its BSDF, or the phase
        function at a medium vertex (pathtracer.cu:1775-1786, 1829-1836,
        1888-1898)."""
        scene, static = self.scene, self.static
        fr, pdf = bsdf_mod.eval_bsdf(mat, w_in, w_out, nor, dpdu,
                                     static.material_types)
        if static.has_media:
            ph = media_mod.phase(scene, med_idx, w_in, w_out)
            fr = torch.where(is_med[:, None], ph[:, None], fr)
            pdf = torch.where(is_med, ph, pdf)
        return fr, pdf

    def run(self, case, p, s, t, c1, c2, l1, l2, valid2):
        """One connection round of `case` ("s1", "t0", "t1" or "gen")
        over the [N, G] item grid; valid2 [N, G] marks the items whose
        vertices exist. c1 / c2 (camera vertices s - 1 / s - 2) and
        l1 / l2 (light vertices t - 1 / t - 2) are flat record dicts.
        Returns (L [N * G, 3] after the roulette, ok [N * G], the shadow
        ray (o, d, tmax, medium) and the s1 raster pixel, or None)."""
        scene, static = self.scene, self.static
        eps = scene.epsilon
        n, G = valid2.shape
        m = n * G
        valid = valid2.reshape(-1)
        cam = scene.camera
        rng = PhiloxStream(self.seed, self.iteration, self.items,
                           CONNECT_DIMS * p, CONNECT_DIMS, BDPT_CONNECT_TAG,
                           self.plain)
        nanf = torch.full((m,), torch.nan, device=self.dev)
        sh = pix = None

        if c1 is not None:
            c1p, c1n = c1["pos"], c1["nor"]
            c2p, c2n = c2["pos"], c2["nor"]
            c1_is_med = c1["mat_idx"] == -1
            in_c1 = normalize(c2p - c1p)   # toward the camera side
        if l1 is not None:
            l1p, l1n = l1["pos"], l1["nor"]
            l2p, l2n = l2["pos"], l2["nor"]
            l1_is_med = l1["mat_idx"] == -1
            l1_mat = bsdf_mod.gather_materials(scene, static, l1["mat_idx"],
                                               l1["uv"])
            in_l1 = normalize(l2p - l1p)   # toward the light side
        if case in ("t1", "gen"):
            c1_mat = bsdf_mod.gather_materials(scene, static, c1["mat_idx"],
                                               c1["uv"])

        if case == "t0":
            # the camera path reached a light (pathtracer.cu:1722-1749)
            lidx = torch.clamp_min(c1["light_idx"], 0)
            L = c1["beta"] * lights_mod.area_light_le(
                scene, c1["light_idx"], c1n, in_c1)
            choice0 = lights_mod.light_choice_pdf(scene, lidx)
            pdf_a0, pdf_w0 = lights_mod.area_light_pdf(scene, lidx, in_c1,
                                                       c1n)
            case_valid = valid & (c1["light_idx"] >= 0) & ~is_black(L)
            c1_rev = pdf_a0 * choice0
            c2_rev = _convert_pdf(pdf_w0, c1p, c2p, c2n)
            l1_rev = l2_rev = l0_fwd = nanf
        elif case == "t1":
            # NEE from the camera path (pathtracer.cu:1750-1809)
            pick, choice1 = lights_mod.pick_light(scene, rng.uniform())
            pick = torch.clamp_max(pick, max(static.n_lights - 1, 0))
            lu1, lu2 = rng.uniform2()
            rad1, _, sd1, st1, lnor1, lpdf1 = lights_mod.sample_area_light(
                scene, pick, c1p, lu1, lu2, eps)
            light_pos1 = c1p + sd1 * (st1 + eps)[:, None]
            fr1, next_pdf1 = self.surf_or_phase(
                c1_is_med, c1["med"], c1_mat, c1n, c1["dpdu"], in_c1, sd1)
            g1 = torch.where(c1_is_med, 1.0, torch.abs(dot(c1n, sd1)))
            L = c1["beta"] * fr1 * rad1 * (
                g1 / torch.clamp_min(lpdf1 * choice1, 1e-30))[:, None]
            pdf_a1, pdf_w1 = lights_mod.area_light_pdf(scene, pick, sd1,
                                                       lnor1)
            _, rev_pdf1 = self.surf_or_phase(
                c1_is_med, c1["med"], c1_mat, c1n, c1["dpdu"], sd1, in_c1)
            case_valid = valid & ~is_black(rad1) & (lpdf1 > 0.0) \
                & ~(~c1_is_med & c1["delta"]) & ~is_black(L)
            l0_fwd = pdf_a1 * choice1
            l1_rev = _convert_pdf(next_pdf1, c1p, light_pos1, lnor1)
            c1_rev = _convert_pdf(pdf_w1, light_pos1, c1p, c1n)
            c2_rev = _convert_pdf(rev_pdf1, c1p, c2p, c2n)
            l2_rev = nanf
            sh = (c1p, sd1, st1, c1["med"])
        elif case == "s1":
            # splat to the camera (pathtracer.cu:1810-1857)
            _, sd2, st2, we2, cpdf2, rx2, ry2 = camera_mod.sample_camera(
                cam, l1p, eps)
            fr2, next_pdf2 = self.surf_or_phase(
                l1_is_med, l1["med"], l1_mat, l1n, l1["dpdu"], in_l1, sd2)
            cos2 = torch.where(l1_is_med, 1.0, torch.abs(dot(sd2, l1n)))
            L = l1["beta"] * fr2 * (
                we2 * cos2 / torch.clamp_min(cpdf2, 1e-30))[:, None]
            _, cam_pdfw2 = camera_mod.pdf_camera(cam, -sd2)
            _, rev_pdf2 = self.surf_or_phase(
                l1_is_med, l1["med"], l1_mat, l1n, l1["dpdu"], sd2, in_l1)
            case_valid = valid & (cpdf2 != 0.0) \
                & ~(~l1_is_med & l1["delta"]) & ~is_black(L)
            l1_rev = _convert_pdf(cam_pdfw2, cam.position.expand(m, 3), l1p,
                                  l1n)
            l2_rev = _convert_pdf(rev_pdf2, l1p, l2p, l2n)
            c1_rev = c2_rev = l0_fwd = nanf
            sh = (l1p, sd2, st2, l1["med"])
            pix = rx2 + ry2 * static.width
        else:
            # the general case (pathtracer.cu:1858-1927)
            conn = c1p - l1p
            d2g = torch.clamp_min(dot(conn, conn), 1e-30)
            l1_to_c1 = conn / torch.sqrt(d2g)[:, None]
            c1_to_l1 = -l1_to_c1
            fr_c1, pdf_to_l1 = self.surf_or_phase(
                c1_is_med, c1["med"], c1_mat, c1n, c1["dpdu"], in_c1,
                c1_to_l1)
            fr_l1, pdf_to_c1 = self.surf_or_phase(
                l1_is_med, l1["med"], l1_mat, l1n, l1["dpdu"], in_l1,
                l1_to_c1)
            cos_l = torch.where(l1_is_med, 1.0, torch.abs(dot(l1_to_c1, l1n)))
            cos_c = torch.where(c1_is_med, 1.0, torch.abs(dot(c1_to_l1, c1n)))
            g3 = cos_l * cos_c / d2g
            L = c1["beta"] * fr_c1 * fr_l1 * l1["beta"] * g3[:, None]
            _, pdf_to_l2 = self.surf_or_phase(
                l1_is_med, l1["med"], l1_mat, l1n, l1["dpdu"], l1_to_c1, in_l1)
            _, pdf_to_c2 = self.surf_or_phase(
                c1_is_med, c1["med"], c1_mat, c1n, c1["dpdu"], c1_to_l1, in_c1)
            case_valid = valid & ~(~c1_is_med & c1["delta"]) \
                & ~(~l1_is_med & l1["delta"]) & ~is_black(L)
            c1_rev = _convert_pdf(pdf_to_c1, l1p, c1p, c1n)
            l1_rev = _convert_pdf(pdf_to_l1, c1p, l1p, l1n)
            l2_rev = _convert_pdf(pdf_to_l2, l1p, l2p, l2n)
            c2_rev = _convert_pdf(pdf_to_c2, c1p, c2p, c2n)
            l0_fwd = nanf
            sh = (c1p, c1_to_l1, torch.sqrt(d2g) - eps, c1["med"])

        # contribution x MIS (before the shadow ray: MIS does not depend
        # on the transmittance, which multiplies in below)
        mis = _mis_weight(*self.mis6, s, t, *(
            x.reshape(n, G) for x in (c1_rev, c2_rev, l1_rev, l2_rev,
                                      l0_fwd))).reshape(m)
        L = L * mis[:, None]
        ok = case_valid & torch.isfinite(L).all(-1) & ~is_black(L)
        L = torch.where(ok[:, None], L, 0.0)
        if case == "t0":   # along an existing segment: no shadow ray
            return L, ok, None, None

        if CONNECT_RR > 0.0:
            # the shadow-connection roulette, against the lane's mean
            lum = luminance(L)
            okf = ok.reshape(n, G)
            mean = _cols_sum(torch.where(okf, lum.reshape(n, G), 0.0)) \
                / torch.clamp_min(okf.sum(1), 1).float()
            q = torch.clamp(lum / torch.clamp_min(
                CONNECT_RR * mean.repeat_interleave(G), 1e-30), 0.0, 1.0)
            ok = ok & (rng.uniform() < q)
            L = torch.where(ok[:, None], L / torch.clamp_min(q, 1e-30)[:, None],
                            0.0)
        return L, ok, sh, pix


def _vslice(v: Vertices, lo: int, gw: int):
    """The vertex records of columns lo .. lo + gw - 1 for every (lane,
    column) item, flattened [N * gw, c]."""
    lo = max(lo, 0)
    sl = slice(lo, lo + gw)
    m = v.pos.shape[0] * gw
    return dict(
        pos=v.pos[:, sl].reshape(m, 3), nor=v.nor[:, sl].reshape(m, 3),
        uv=v.uv[:, sl].reshape(m, 2), dpdu=v.dpdu[:, sl].reshape(m, 3),
        beta=v.beta[:, sl].reshape(m, 3), mat_idx=v.mat_idx[:, sl].reshape(m),
        light_idx=v.light_idx[:, sl].reshape(m),
        med=v.medium[:, sl].reshape(m), delta=v.delta[:, sl].reshape(m))


def _vat(v: Vertices, i: int, gw: int):
    """The vertex records of column i (clipped), for every item."""
    n = v.pos.shape[0]
    c = min(max(i, 0), v.pos.shape[1] - 1)

    def b(x):
        x = x[:, c]
        return x[:, None].expand((n, gw) + x.shape[1:]).reshape(
            (n * gw,) + x.shape[1:])
    return dict(pos=b(v.pos), nor=b(v.nor), uv=b(v.uv), dpdu=b(v.dpdu),
                beta=b(v.beta), mat_idx=b(v.mat_idx),
                light_idx=b(v.light_idx), med=b(v.medium), delta=b(v.delta))


def empty_queue(n: int, g: int, has_media: bool, dev) -> Queue:
    """A queue with every slot dead (zeros)."""
    s = n_slots(g)
    return Queue(
        torch.zeros((s, n), dtype=torch.bool, device=dev),
        torch.zeros((s, n, 3), device=dev), torch.zeros((s, n, 3), device=dev),
        torch.zeros((s, n), device=dev), torch.zeros((s, n, 3), device=dev),
        torch.zeros((s, n), dtype=torch.int32, device=dev) if has_media
        else None, torch.zeros((g, n), dtype=torch.int32, device=dev))


def connect_torch(scene, static, seed, iteration, lanes, v: Vertices,
                  rays=None, plain=True):
    """The plain version of `connect`: the rounds of bdpt.py's `_Round`
    in their order, each round's queued connections written to its
    slots, t0's columns added to li in column order."""
    n = lanes.shape[0]
    dev = lanes.device
    if lanes.is_cuda:
        CONNECT_STATS.plain_cuda += 1
    cam_v, light_v = rows(v, 0, n), rows(v, n, 2 * n)
    G = v.pos.shape[1] - 1
    rd = _Round(scene, static, seed, iteration, lanes, cam_v, light_v, plain)
    q = empty_queue(n, G, static.has_media, dev)
    li = torch.zeros((n, 3), device=dev)
    cc, lc = cam_v.count, light_v.count
    cols = torch.arange(2, G + 2, device=dev)[None, :]   # [1, G]

    def queue(j0, out):
        L, ok, (o, d, tmax, med), pix = out
        sl = slice(j0, j0 + G)

        def put(dst, x):
            dst[sl] = torch.where(ok.reshape(n, G).t().reshape(
                (G, n) + (1,) * (x.dim() - 1)), x.reshape(
                    (n, G) + x.shape[1:]).transpose(0, 1), 0)
        q.live[sl] = ok.reshape(n, G).t()
        for dst, x in ((q.o, o), (q.d, d), (q.tmax, tmax), (q.L, L)):
            put(dst, x)
        if q.med is not None:
            put(q.med, med)
        if pix is not None:
            put(q.pix, pix)

    # s == 1: light vertex t - 1 to the camera, t = column + 2
    valid2 = cols <= lc[:, None]
    if bool(valid2.any()):
        queue(slot0("s1", G), rd.run("s1", 1, 1, cols, None, None,
                                     _vslice(light_v, 1, G),
                                     _vslice(light_v, 0, G), valid2))
    # t == 0 and t == 1: camera vertex s - 1, s = column + 2
    valid2 = cols <= cc[:, None]
    if bool(valid2.any()):
        L, *_ = rd.run("t0", 2, cols, 0, _vslice(cam_v, 1, G),
                       _vslice(cam_v, 0, G), None, None, valid2)
        li = li + _cols_sum(L.reshape(n, G, 3))
    valid2 = valid2 & (lc >= 1)[:, None]
    if bool(valid2.any()):
        queue(slot0("t1", G), rd.run("t1", 3, cols, 1, _vslice(cam_v, 1, G),
                                     _vslice(cam_v, 0, G), None, None,
                                     valid2))
    # the general case: s = 2 .. n_verts, t = column + 2
    for s in range(2, G + 2):
        valid2 = (s <= cc)[:, None] & (cols <= lc[:, None])
        if bool(valid2.any()):
            queue(slot0("gen", G, s), rd.run(
                "gen", 4 + s - 2, s, cols, _vat(cam_v, s - 1, G),
                _vat(cam_v, s - 2, G), _vslice(light_v, 1, G),
                _vslice(light_v, 0, G), valid2))
    if rays is not None and not static.has_media:
        rays += q.live.sum()
    return li, q


def finish_torch(li, q: Queue, shadow, n_pix: int):
    """The plain version of `finish`: each queued credit L x tr (tr 0 or
    1 from the occlusion, or the walk's transmittance), the rounds' columns
    summed in column order into li, the s1 credits splatted in lane order
    (the order the unregrouped rounds splat in), then the NaN guard."""
    if li.is_cuda:
        FINISH_STATS.plain_cuda += 1
    g = q.pix.shape[0]
    s, n = q.live.shape
    if shadow.dtype == torch.bool:
        tr = torch.where(shadow[:, None], 0.0, torch.ones((s * n, 3),
                                                          device=li.device))
    else:
        tr = shadow
    c = torch.where(q.live[..., None], q.L * tr.reshape(s, n, 3), 0.0)
    film = torch.zeros((n_pix, 3), device=li.device)
    live = q.live[:g].t().reshape(-1)
    film.index_put_((q.pix.t().reshape(-1)[live].long(),),
                    c[:g].transpose(0, 1).reshape(-1, 3)[live],
                    accumulate=True)
    for j0 in range(g, s, g):   # t1, then the general rounds
        li = li + _cols_sum(c[j0:j0 + g].transpose(0, 1))
    bad = ~torch.isfinite(li).all(-1)
    return torch.where(bad[:, None], 0.0, li), film


# ---------------------------------------------------------------------------
# the kernels (csrc/bdpt.cu)
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p


def _fields(ptrs, ints="", u32="", f32=""):
    return ([(k, _P) for k in ptrs.split()]
            + [(k, ctypes.c_int) for k in ints.split()]
            + [(k, ctypes.c_uint32) for k in u32.split()]
            + [(k, ctypes.c_float) for k in f32.split()])


_TABLES = "pos nor uv dpdu vbeta fwd rev delta mat_idx light_idx medium count"


class _StartArgs(ctypes.Structure):   # BdptStartArgs
    _fields_ = _fields(
        "lanes px py cam lights cdf l_medium med_table ro rd beta forward med "
        "alive tmax med_sample " + _TABLES,
        "n n_lights n_rows environment camera_medium", "seed iteration",
        "eps")


class _StepArgs(ctypes.Structure):   # BdptStepArgs
    _fields_ = _fields(
        "t prim found_t lanes ro rd beta forward med alive tmax med_sample "
        + _TABLES + " prim_attrs mats med_table tex tex_offset tex_w tex_h "
        "rays", "n k step all_kinds aniso has_media", "seed iteration")


class _ConnectArgs(ctypes.Structure):   # BdptConnectArgs
    _fields_ = _fields(
        "lanes " + _TABLES + " mats lights cdf med_table cam tex tex_offset "
        "tex_w tex_h li_out live q_o q_d q_tmax q_L q_med q_pix rays",
        "n k n_lights n_rows width has_media", "seed iteration", "eps")


class _FinishArgs(ctypes.Structure):   # BdptFinishArgs
    _fields_ = _fields("li live q_L q_pix occluded tr li_out film",
                       "n g")


def _lib():
    lib = load_library("bdpt")
    if lib.bdpt_step.argtypes is None:
        for name, args in (("bdpt_start", _StartArgs),
                           ("bdpt_step", _StepArgs),
                           ("bdpt_connect", _ConnectArgs),
                           ("bdpt_finish", _FinishArgs)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(args), _P]
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


F32, I32, I64, U8 = torch.float32, torch.int32, torch.int64, torch.bool


def _check(dev, shape, *specs):
    """Each (name, tensor or None, trailing shape, dtype) a contiguous
    tensor of that dtype and shape `shape` + trailing, on `dev`."""
    for name, x, tail, dtype in specs:
        if x is not None:
            check_cuda_f32(name, x, tuple(shape) + tuple(tail), dev, dtype)


def _check_rays(rays, dev):
    if rays is None or rays.dtype != I64 or rays.numel() != 1 \
            or rays.device != dev:
        raise ValueError("rays must be a 1-element int64 tensor on the card")


def _table_specs(v: Vertices):
    return (("pos", v.pos, (3,), F32), ("nor", v.nor, (3,), F32),
            ("uv", v.uv, (2,), F32), ("dpdu", v.dpdu, (3,), F32),
            ("beta", v.beta, (3,), F32), ("fwd", v.fwd, (), F32),
            ("rev", v.rev, (), F32), ("delta", v.delta, (), U8),
            ("mat_idx", v.mat_idx, (), I32),
            ("light_idx", v.light_idx, (), I32),
            ("medium", v.medium, (), I32))


def _set_tables(a, v: Vertices):
    (a.pos, a.nor, a.uv, a.dpdu, a.vbeta, a.fwd, a.rev, a.delta, a.mat_idx,
     a.light_idx, a.medium, a.count) = (
        getattr(v, f).data_ptr() for f in Vertices.__annotations__)


def _storage(x):
    """The vertex-major [K, R, ...] storage of a table view."""
    return x.transpose(0, 1)


def _set_textures(a, scene, static, dev):
    if static.has_textures:
        check_cuda_f32("tex_data", scene.tex_data, (None, 3), dev,
                       torch.uint8)
        n_tex = scene.tex_offset.shape[0]
        for name in ("tex_offset", "tex_w", "tex_h"):
            check_cuda_f32(name, getattr(scene, name), (n_tex,), dev,
                           torch.int32)
        a.tex, a.tex_offset, a.tex_w, a.tex_h = (
            x.data_ptr() for x in (scene.tex_data, scene.tex_offset,
                                   scene.tex_w, scene.tex_h))


def _check_tables(v: Vertices, n2: int, dev):
    """The tables' storage: contiguous [K, 2N, ...] (vertex-major)."""
    k = v.pos.shape[1]
    if not 2 <= k <= ITEM_LANES:
        raise ValueError(f"the tables take 2 .. {ITEM_LANES} vertices a "
                         f"subpath, got {k}")
    _check(dev, (k, n2), *((name, _storage(x), tail, dtype)
                           for name, x, tail, dtype in _table_specs(v)))
    _check(dev, (n2,), ("count", v.count, (), I32))
    return k


def step_cuda(scene, static, step_, seed, iteration, lanes, t, prim,
              found_t, v: Vertices, w: Walker, rays=None):
    """Launch csrc/bdpt.cu's bdpt_step: `step`'s contract on CUDA tensors
    (`rays` required)."""
    dev = w.ro.device
    n2 = w.ro.shape[0]
    if n2 % 2:
        raise ValueError(f"the walk has 2N rows, got {n2}")
    n = n2 // 2
    k = _check_tables(v, n2, dev)
    _check(dev, (n2,), ("t", t, (), F32), ("prim", prim, (), I32),
           ("found_t", found_t, (), F32), ("ro", w.ro, (3,), F32),
           ("rd", w.rd, (3,), F32), ("walk beta", w.beta, (3,), F32),
           ("forward", w.forward, (), F32), ("med", w.med, (), I32),
           ("alive", w.alive, (), U8), ("tmax", w.tmax, (), F32),
           ("med_sample", w.med_sample, (), I32))
    _check(dev, (n,), ("lanes", lanes, (), I64))
    if static.has_hetero != (found_t is not None) or \
            static.has_hetero != (w.med_sample is not None):
        raise ValueError("found_t and med_sample are the sample walk's: "
                         "given with heterogeneous media, and only then")
    _check_rays(rays, dev)
    check_cuda_f32("prim_attrs", scene.prim_attrs, (None, 40), dev)
    check_cuda_f32("mat_attrs", scene.mat_attrs, (None, 24), dev)
    check_cuda_f32("med_table", scene.med_table, (None, MED_COLS), dev)
    a = _StepArgs()
    a.t, a.prim, a.found_t, a.lanes = (_ptr(x) for x in (t, prim, found_t,
                                                        lanes))
    a.ro, a.rd, a.beta, a.forward, a.med, a.alive, a.tmax = (
        x.data_ptr() for x in (w.ro, w.rd, w.beta, w.forward, w.med, w.alive,
                               w.tmax))
    a.med_sample = _ptr(w.med_sample)
    _set_tables(a, v)
    a.prim_attrs, a.mats, a.med_table = (
        x.data_ptr() for x in (scene.prim_attrs, scene.mat_attrs,
                               scene.med_table))
    _set_textures(a, scene, static, dev)
    a.rays = rays.data_ptr()
    a.n, a.k, a.step = n, k, step_
    a.all_kinds = int(kernels.all_kinds(kinds_of(static)))
    a.aniso, a.has_media = int(static.has_aniso), int(static.has_media)
    a.seed, a.iteration = int(seed) & MASK32, int(iteration) & MASK32
    rc = _lib().bdpt_step(ctypes.byref(a),
                          torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "bdpt_step")
    STATS.launches += 1


CAM_FLOATS = 23   # position u v w (3 each) resolution (2) distance half_w
#                   half_h area pixel2screen (2) ratio focal aperture


def camera_record(cam) -> torch.Tensor:
    """The camera fields csrc/bdpt.cu reads (shade.cuh's Cam), packed as
    float32 [23]."""
    return torch.cat([x.reshape(-1) for x in (
        cam.position, cam.u, cam.v, cam.w, cam.resolution, cam.distance,
        cam.half_w, cam.half_h, cam.area, cam.pixel2screen, cam.ratio,
        cam.focal, cam.aperture)])


def start_cuda(scene, static, seed, iteration, lanes, pixel_x, pixel_y,
               n_verts):
    """Launch csrc/bdpt.cu's bdpt_start: `start`'s contract on CUDA
    tensors."""
    dev = lanes.device
    n = lanes.shape[0]
    if not 2 <= n_verts <= ITEM_LANES:
        raise ValueError(f"the tables take 2 .. {ITEM_LANES} vertices a "
                         f"subpath, got {n_verts}")
    _check(dev, (n,), ("lanes", lanes, (), I64))
    px, py = (x.to(I32).contiguous() for x in (pixel_x, pixel_y))
    _check(dev, (n,), ("pixel_x", px, (), I32), ("pixel_y", py, (), I32))
    rows_ = n_light_rows(static)
    check_cuda_f32("light_attrs", scene.light_attrs, (rows_, 24), dev)
    check_cuda_f32("light_cdf", scene.light_cdf, (rows_ + 2,), dev)
    check_cuda_f32("med_table", scene.med_table, (None, MED_COLS), dev)
    if static.has_media:
        check_cuda_f32("l_medium", scene.l_medium, (None,), dev, I32)
    cam = camera_record(scene.camera)
    check_cuda_f32("camera", cam, (CAM_FLOATS,), dev)
    f32 = dict(dtype=F32, device=dev)
    i32 = dict(dtype=I32, device=dev)
    n2, k = 2 * n, n_verts
    def vertex_major(*shape, dtype=F32):
        return torch.empty((k, n2) + shape, dtype=dtype,
                           device=dev).transpose(0, 1)
    v = Vertices(*(vertex_major(c) for c in (3, 3, 2, 3, 3)),
                 vertex_major(), vertex_major(), vertex_major(dtype=U8),
                 *(vertex_major(dtype=I32) for _ in range(3)),
                 torch.empty(n2, **i32))
    w = Walker(torch.empty((n2, 3), **f32), torch.empty((n2, 3), **f32),
               torch.empty((n2, 3), **f32), torch.empty(n2, **f32),
               torch.empty(n2, **i32), torch.empty(n2, dtype=U8, device=dev),
               torch.empty(n2, **f32),
               torch.empty(n2, **i32) if static.has_hetero else None)
    a = _StartArgs()
    a.lanes, a.px, a.py, a.cam = (x.data_ptr() for x in (lanes, px, py, cam))
    a.lights, a.cdf, a.med_table = (
        x.data_ptr() for x in (scene.light_attrs, scene.light_cdf,
                               scene.med_table))
    a.l_medium = scene.l_medium.data_ptr() if static.has_media else None
    a.ro, a.rd, a.beta, a.forward, a.med, a.alive, a.tmax = (
        x.data_ptr() for x in (w.ro, w.rd, w.beta, w.forward, w.med, w.alive,
                               w.tmax))
    a.med_sample = _ptr(w.med_sample)
    _set_tables(a, v)
    a.n, a.n_lights, a.n_rows = n, static.n_lights, rows_
    a.environment = int(static.environment_camera)
    a.camera_medium = static.camera_medium
    a.seed, a.iteration = int(seed) & MASK32, int(iteration) & MASK32
    a.eps = float(scene.epsilon)
    rc = _lib().bdpt_start(ctypes.byref(a),
                           torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "bdpt_start")
    START_STATS.launches += 1
    return v, w


def connect_cuda(scene, static, seed, iteration, lanes, v: Vertices,
                 rays=None):
    """Launch csrc/bdpt.cu's bdpt_connect: `connect`'s contract on CUDA
    tensors (`rays` required)."""
    dev = v.pos.device
    n = lanes.shape[0]
    k = _check_tables(v, 2 * n, dev)
    g = k - 1
    _check(dev, (n,), ("lanes", lanes, (), I64))
    _check_rays(rays, dev)
    rows_ = n_light_rows(static)
    check_cuda_f32("mat_attrs", scene.mat_attrs, (None, 24), dev)
    check_cuda_f32("light_attrs", scene.light_attrs, (rows_, 24), dev)
    check_cuda_f32("light_cdf", scene.light_cdf, (rows_ + 2,), dev)
    check_cuda_f32("med_table", scene.med_table, (None, MED_COLS), dev)
    cam = camera_record(scene.camera)
    check_cuda_f32("camera", cam, (CAM_FLOATS,), dev)
    s = n_slots(g)
    f32 = dict(dtype=F32, device=dev)
    q = Queue(torch.empty((s, n), dtype=U8, device=dev),
              torch.empty((s, n, 3), **f32), torch.empty((s, n, 3), **f32),
              torch.empty((s, n), **f32), torch.empty((s, n, 3), **f32),
              torch.empty((s, n), dtype=I32, device=dev)
              if static.has_media else None,
              torch.empty((g, n), dtype=I32, device=dev))
    li = torch.empty((n, 3), **f32)
    a = _ConnectArgs()
    a.lanes = lanes.data_ptr()
    _set_tables(a, v)
    a.mats, a.lights, a.cdf, a.med_table, a.cam = (
        x.data_ptr() for x in (scene.mat_attrs, scene.light_attrs,
                               scene.light_cdf, scene.med_table, cam))
    _set_textures(a, scene, static, dev)
    a.li_out = li.data_ptr()
    a.live, a.q_o, a.q_d, a.q_tmax, a.q_L, a.q_pix = (
        x.data_ptr() for x in (q.live, q.o, q.d, q.tmax, q.L, q.pix))
    a.q_med = _ptr(q.med)
    a.rays = rays.data_ptr()
    a.n, a.k, a.n_lights, a.n_rows = n, k, static.n_lights, rows_
    a.width, a.has_media = static.width, int(static.has_media)
    a.seed, a.iteration = int(seed) & MASK32, int(iteration) & MASK32
    a.eps = float(scene.epsilon)
    rc = _lib().bdpt_connect(ctypes.byref(a),
                             torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "bdpt_connect")
    CONNECT_STATS.launches += 1
    return li, q


def connect_occupancy(k: int, textures: bool = False) -> dict:
    """bdpt_connect's launch shape on the current card for subpaths of k
    vertices: threads a block, blocks an SM (the occupancy API) and
    dynamic shared-memory bytes a block."""
    fn = _lib().bdpt_connect_occupancy
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int, _P]
    out = (ctypes.c_int * 3)()
    check_launch(fn(k, int(textures), out), "bdpt_connect_occupancy")
    return {"threads": out[0], "blocks_per_sm": out[1],
            "smem_bytes": out[2]}


def finish_cuda(li, q: Queue, shadow, n_pix: int):
    """Launch csrc/bdpt.cu's bdpt_finish: `finish`'s contract on CUDA
    tensors."""
    dev = li.device
    n = li.shape[0]
    s, g = q.live.shape[0], q.pix.shape[0]
    if s != n_slots(g):
        raise ValueError(f"a queue of {g} columns has {n_slots(g)} slots, "
                         f"got {s}")
    _check(dev, (n,), ("li", li, (3,), F32))
    _check(dev, (s, n), ("live", q.live, (), U8), ("L", q.L, (3,), F32))
    _check(dev, (g, n), ("pix", q.pix, (), I32))
    if shadow.dtype == U8:
        _check(dev, (s * n,), ("occluded", shadow, (), U8))
    else:
        _check(dev, (s * n,), ("tr", shadow, (3,), F32))
    out = torch.empty((n, 3), dtype=F32, device=dev)
    film = torch.zeros((n_pix, 3), dtype=F32, device=dev)
    a = _FinishArgs()
    a.li, a.live, a.q_L, a.q_pix = (x.data_ptr() for x in (li, q.live, q.L,
                                                           q.pix))
    if shadow.dtype == U8:
        a.occluded = shadow.data_ptr()
    else:
        a.tr = shadow.data_ptr()
    a.li_out, a.film = out.data_ptr(), film.data_ptr()
    a.n, a.g = n, g
    rc = _lib().bdpt_finish(ctypes.byref(a),
                            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "bdpt_finish")
    FINISH_STATS.launches += 1
    return out, film
