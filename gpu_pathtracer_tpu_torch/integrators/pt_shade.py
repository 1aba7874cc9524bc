"""The PT wavefront's shading of one bounce, as one CUDA kernel.

`shade` takes the closest-hit query's raw (t, prim) and the wavefront's
lane state, a `Wave`, and updates it: the previous bounce's NEE credit
where its shadow ray was not occluded, the arrival credit (an emitter
hit, or the sky on a miss), the end of lanes that reach a BSSRDF prim
(flagged SSS: trace_paths' subsurface hook shades them), the NEE light
sample (its shadow ray, and its unoccluded credit beta * Ld, pending
until the any-hit query has run), the BSDF sample, the roulette after
bounce 3 and, when the wavefront sorts, the coherence keys of the next
ray and of the shadow ray. At b = max_depth (`last`) only the two
credits run.

The state that travels between bounces is one 16-float record a lane
(`REC`, read and written as four 16-byte vectors): li and prev_pdf, beta
and the flags, the pending credit and the lane id, the caller's slot.
The next ray stays in [N, 3] ro and rd (`Wave.ray`), as the hit kernels
take it. A lane with nothing left to add (dead, no credit pending, not
SSS) writes its radiance to its caller's slot of `Wave.out` once, and no
later bounce reads or writes it. On the sorted rows (`Wave.sorted`) the
records move with the coherence sort: bounce b reads position i's
record at `order[i]` of bounce b - 1's output and writes position i of
the other buffer; the lanes alive after b - 1 are the first
`counts[b, 0]` positions (the sort puts dead lanes last), the dead lanes
still owed a visit (a pending credit, SSS) are in a device list, and
the positions past both leave at once. `advance` sorts the int32 keys
and gathers the next ray: the only copy between two bounces. On the
unsorted rows (an explicit psample, <= DENSE_MAX prims) the records are
updated in place and a finished lane's visit is one read of its flags.

On CUDA tensors `shade` launches csrc/pt_shade.cu (K2's shading code,
csrc/shade.cuh) and counts the launch in `STATS`; it raises on what the
kernel does not take and has no fallback. `shade_wave_torch` is its
plain version on the same `Wave`, over `shade_torch`, the bounce in
PyTorch on [N] fields (pt._arrival_credit, bsdf.gather_materials,
common.nee_sample, bsdf.sample_bsdf, the roulette, pt._sort_key,
common._shadow_sort_key): it runs for CPU tensors and under
`plain=True`, and counts its calls on CUDA tensors in
`STATS.plain_cuda`.

Lane flags (int32): SPECULAR, ALIVE, OCCLUDED (shade_torch's input: the
previous bounce's shadow ray was blocked), SSS (the lane ended on a
BSSRDF prim this bounce) and PENDING (its record holds a credit that
waits for its shadow ray).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from gpu_pathtracer_tpu_torch import kernels, telemetry
from gpu_pathtracer_tpu_torch.core.rng import (
    PSS_BOUNCE_DIMS, PSS_CAM_DIMS, lane_stream,
)
from gpu_pathtracer_tpu_torch.core.vecmath import dot, is_black, luminance
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.geom.dense import kinds_of
from gpu_pathtracer_tpu_torch.integrators import common, pt
from gpu_pathtracer_tpu_torch.kernels import (
    KernelStats, check_cuda_f32, check_launch, load_library,
)
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade.lights import n_light_rows

STATS = KernelStats()

SPECULAR, ALIVE, OCCLUDED, SSS, PENDING = 1, 2, 4, 8, 16
DEAD_KEY = 1 << 20         # pt._sort_key of a dead lane
NO_SHADOW_KEY = 1 << 24    # common._shadow_sort_key of a lane without one
# the lane record: columns of a [N, REC] float32 tensor (integers as
# their bits)
REC = 16
LI, PDF, BETA, FLAGS, PEND, LANE, SLOT = 0, 3, 4, 7, 8, 11, 12


@dataclass
class Shaded:
    """One bounce's shading on [N] fields: the next lane state, the
    pending NEE credit, the shadow ray (tmax 0 where the lane made none)
    and the keys."""
    ro: torch.Tensor          # [N, 3] the next ray
    rd: torch.Tensor          # [N, 3]
    li: torch.Tensor          # [N, 3]
    beta: torch.Tensor        # [N, 3]
    prev_pdf: torch.Tensor    # [N]
    flags: torch.Tensor       # [N] int32: SPECULAR | ALIVE | SSS
    pending: torch.Tensor     # [N, 3] beta * Ld, 0 without a shadow ray
    shadow_o: torch.Tensor    # [N, 3] (0 without a shadow ray)
    shadow_d: torch.Tensor    # [N, 3]
    shadow_t: torch.Tensor    # [N]
    cand: torch.Tensor        # [N] bool: the lane made a shadow ray
    key: torch.Tensor | None         # [N] int32, pt._sort_key
    shadow_key: torch.Tensor | None  # [N] int32, common._shadow_sort_key
    rays: torch.Tensor        # [2] int64: closest-hit rays, shadow rays


def shade_torch(scene, static, b, seed, iteration, lanes, t, prim, ro, rd,
                li, beta, prev_pdf, flags, pending=None, psample=None,
                key=False, shadow_key=False, plain=True) -> Shaded:
    """Bounce `b` (b == static.max_depth: the epilogue's credits) of the
    lanes in [N] fields, in the kernel's order of operations: `pending`
    (None at bounce 0) is the previous bounce's NEE credit, added where
    `flags` has no OCCLUDED; `key` / `shadow_key` ask for the coherence
    keys."""
    if ro.is_cuda:
        STATS.plain_cuda += 1
    last = b == static.max_depth
    specular = (flags & SPECULAR) != 0
    alive = (flags & ALIVE) != 0
    n_closest = alive.sum()
    if pending is not None:
        li = li + torch.where(((flags & OCCLUDED) != 0)[:, None], 0.0,
                              pending)
    hit = traverse._hit_attributes(scene, static, ro, rd, t, prim, prim >= 0)
    li, alive = pt._arrival_credit(scene, static, hit, ro, rd, li, beta,
                                   specular, prev_pdf, alive,
                                   b == 0 and not last)
    zero3 = torch.zeros_like(ro)
    zero = torch.zeros_like(prev_pdf)
    if last:
        return Shaded(ro, rd, li, beta, prev_pdf,
                      specular.to(torch.int32), zero3, zero3, zero3, zero,
                      torch.zeros_like(alive), None, None,
                      torch.stack([n_closest, torch.zeros_like(n_closest)]))
    sss = torch.zeros_like(alive)
    if static.has_bssrdf:
        sss = alive & (hit.bssrdf_idx >= 0)
        alive = alive & ~sss

    rng = lane_stream(seed, iteration, lanes, psample,
                      PSS_CAM_DIMS + b * PSS_BOUNCE_DIMS, PSS_BOUNCE_DIMS,
                      plain=plain)
    mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
    wi = -rd
    not_delta = ~bsdf_mod.is_delta(mat.type)

    # NEE light sample (pathtracer.cu:925-951); its shadow ray runs after
    contrib, cand, sd, st = common.nee_sample(
        scene, static, rng, hit.pos, hit.nor, hit.dpdu, mat, wi,
        alive & not_delta)
    pending = torch.where(cand[:, None], beta * contrib, 0.0)
    shadow_o = torch.where(cand[:, None], hit.pos, 0.0)
    shadow_d = torch.where(cand[:, None], sd, 0.0)
    shadow_t = torch.where(cand, st, 0.0)

    # one BSDF sample: continuation + MIS pdf (pathtracer.cu:997-1008)
    u1, u2, u3 = rng.uniform3()
    wo, fr, pdf = bsdf_mod.sample_bsdf(
        mat, wi, hit.nor, hit.dpdu, u1, u2, u3, static.material_types)
    alive = alive & ~(is_black(fr) | (pdf <= 0.0))
    beta_next = beta * fr * torch.abs(dot(hit.nor, wo))[:, None] \
        / torch.clamp_min(pdf, 1e-30)[:, None]
    beta = torch.where(alive[:, None], beta_next, beta)
    specular = torch.where(alive, bsdf_mod.is_delta(mat.type), specular)
    prev_pdf = torch.where(alive, pdf, prev_pdf)
    ro = torch.where(alive[:, None], hit.pos, ro)
    rd = torch.where(alive[:, None], wo, rd)

    # Russian roulette after bounce 3 (pathtracer.cu:1010-1016)
    u_rr = rng.uniform()
    if b > 3:
        illumate = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
        alive = alive & ~(u_rr < illumate)
        rr_scale = 1.0 / torch.clamp_min(1.0 - illumate, 1e-30)
        beta = torch.where(alive[:, None], beta * rr_scale[:, None], beta)

    out_flags = specular.to(torch.int32) | (alive.to(torch.int32) << 1) \
        | (sss.to(torch.int32) << 3)
    return Shaded(
        ro, rd, li, beta, prev_pdf, out_flags, pending, shadow_o, shadow_d,
        shadow_t, cand,
        pt._sort_key(scene, ro, rd, alive) if key else None,
        common._shadow_sort_key(scene, hit.pos, cand & (shadow_t > 0.0))
        if shadow_key else None,
        torch.stack([n_closest, cand.sum()]))


# ---------------------------------------------------------------------------
# the wavefront's lane state
# ---------------------------------------------------------------------------
def _bits(x):
    """float32 x as int32 bits, any strides."""
    return x.view(torch.int32)


@dataclass
class Wave:
    """The PT wavefront's state over one spp (`start`). Positions are
    the lanes' places in the current bounce's arrays (t, prim, ray, tmax,
    the shadow ray, the keys); N is padded to a multiple of 4 (the pad's
    lanes are finished from the start), so ro and rd stay 16-byte
    aligned."""
    n: int                    # the caller's lanes (<= the padded N)
    sorted: bool              # the records move with the coherence sort
    rec: torch.Tensor         # [N, REC] the records bounce b reads
    spare: torch.Tensor | None    # sorted: the buffer bounce b writes
    ray: torch.Tensor         # [2, N, 3] ro, rd at the current positions
    tmax: torch.Tensor        # [N] the closest hit's: inf alive, else 0
    order: torch.Tensor | None    # sorted, after bounce 0: position i's
    #                               record is rec[order[i]] (int64)
    key: torch.Tensor | None      # sorted: [N] int32 pt._sort_key
    lists: torch.Tensor | None    # sorted: [2, N] int32, bounce b reads
    #                               row b % 2: rec positions owed a visit
    counts: torch.Tensor | None   # sorted: [D + 2, 2] int32, row b: the
    #                               lanes alive after bounce b - 1, the
    #                               list's length
    shadow_o: torch.Tensor    # [N, 3] the shadow ray (where shadow_t > 0)
    shadow_d: torch.Tensor    # [N, 3]
    shadow_t: torch.Tensor    # [N] 0 where the position made none
    shadow_key: torch.Tensor | None   # [N] int32 common._shadow_sort_key
    out: torch.Tensor         # [N, 3] the radiance by caller slot
    rays: torch.Tensor        # [2] int64: closest-hit rays, shadow rays

    @property
    def ro(self):
        return self.ray[0]

    @property
    def rd(self):
        return self.ray[1]

    def written(self):
        """The records the last `shade` wrote (before `advance`)."""
        return self.spare if self.sorted else self.rec


def start(static, lanes, slot, ro, rd, sort: bool, shadow_key: bool,
          max_depth: int) -> Wave:
    """The state at bounce 0 of lanes with ids `lanes` (int32) and caller
    slots `slot`, already in position order, tracing ro, rd."""
    n = ro.shape[0]
    n_pad = -(-max(n, 1) // 4) * 4
    dev = ro.device
    i32 = dict(dtype=torch.int32, device=dev)
    # unwritten words hold NaN off the card, so a read of one shows
    fill = (lambda *s: torch.empty(*s, device=dev)) if ro.is_cuda else \
        (lambda *s: torch.full(s, torch.nan, device=dev))
    one = int(np.float32(1.0).view(np.int32))
    with telemetry.sync("sync.wave_row", dev):   # a pageable copy
        row = torch.tensor([0, 0, 0, one, one, one, one, ALIVE, 0, 0, 0, 0,
                            0, 0, 0, 0], **i32)
    rec = row.repeat(n_pad, 1)
    rec[:n, LANE] = lanes.to(torch.int32)
    rec[:n, SLOT] = slot.to(torch.int32)
    rec[n:, FLAGS] = 0
    rec = rec.view(torch.float32)
    ray = torch.zeros((2, n_pad, 3), device=dev)
    ray[0, :n] = ro
    ray[1, :n] = rd
    tmax = torch.full((n_pad,), torch.inf, device=dev)
    tmax[n:] = 0.0
    key = lists = counts = spare = None
    if sort:
        spare = fill(n_pad, REC)
        key = torch.full((n_pad,), DEAD_KEY, **i32)
        lists = torch.empty((2, n_pad), **i32)
        counts = torch.zeros((max_depth + 2, 2), **i32)
        with telemetry.sync("sync.wave_count", dev):   # a host scalar
            counts[0, 0] = n
    return Wave(
        n=n, sorted=sort, rec=rec, spare=spare, ray=ray, tmax=tmax,
        order=None, key=key, lists=lists, counts=counts,
        shadow_o=fill(n_pad, 3), shadow_d=fill(n_pad, 3),
        shadow_t=torch.zeros(n_pad, device=dev),
        shadow_key=torch.full((n_pad,), NO_SHADOW_KEY, **i32)
        if shadow_key else None,
        out=fill(n_pad, 3), rays=torch.zeros(2, dtype=torch.int64,
                                             device=dev))


def advance(w: Wave) -> None:
    """Between two bounces of the sorted rows: sort the next rays' keys
    (stable, dead lanes last), gather the next ray by the order, and swap
    the record buffers. The sorted keys are the next bounce's key buffer:
    its positions past the live lanes already hold DEAD_KEY."""
    w.key, w.order = torch.sort(w.key, stable=True)
    w.ray = w.ray.index_select(1, w.order)
    w.tmax = torch.where(w.key == DEAD_KEY, 0.0, torch.inf)
    w.rec, w.spare = w.spare, w.rec


def fields(rec):
    """A record tensor's fields: dict of li [N, 3], prev_pdf, beta [N, 3],
    flags (int32), pending [N, 3], lanes (int32), slot (int32)."""
    return dict(li=rec[:, LI:LI + 3], prev_pdf=rec[:, PDF],
                beta=rec[:, BETA:BETA + 3], flags=_bits(rec[:, FLAGS]),
                pending=rec[:, PEND:PEND + 3], lanes=_bits(rec[:, LANE]),
                slot=_bits(rec[:, SLOT]))


def visits(w: Wave, b: int):
    """(src, front, visit) of bounce b: the record each position reads
    (int64), the positions of lanes alive at the start, the positions
    that shade a lane (the alive ones and those owed a visit)."""
    n = w.rec.shape[0]
    pos = torch.arange(n, device=w.rec.device)
    if not w.sorted:
        flags = _bits(w.rec[:, FLAGS])
        return (pos, (flags & ALIVE) != 0,
                (flags & (ALIVE | PENDING | SSS)) != 0)
    n_live, n_list = w.counts[b, 0].long(), w.counts[b, 1].long()
    front = pos < n_live
    visit = pos < n_live + n_list
    listed = w.lists[b % 2][(pos - n_live).clamp(0, n - 1)].long()
    src = torch.where(front, pos if w.order is None else w.order, listed)
    return torch.where(visit, src, pos), front, visit


# ---------------------------------------------------------------------------
# the shading step
# ---------------------------------------------------------------------------
def shade(scene, static, b, seed, iteration, w: Wave, t, prim, occ=None,
          psample=None, plain=False) -> None:
    """Shade bounce `b` of the wave `w` whose closest-hit query gave (t,
    prim; prim -1 on a miss) at its positions; `occ` (None at bounce 0)
    is the previous bounce's shadow verdicts by position. Updates `w`.
    The kernel on CUDA tensors, else (or under `plain`)
    `shade_wave_torch`."""
    if plain or w.rec.device.type != "cuda":
        return shade_wave_torch(scene, static, b, seed, iteration, w, t,
                                prim, occ, psample, plain)
    return shade_cuda(scene, static, b, seed, iteration, w, t, prim, occ,
                      psample)


def shade_wave_torch(scene, static, b, seed, iteration, w: Wave, t, prim,
                     occ=None, psample=None, plain=True):
    """The plain version of `shade`: `shade_torch` over the visited
    positions' records, written back as the kernel writes them (the
    records of lanes that go on, the finished lanes' radiance, the next
    ray, tmax, the shadow ray, the keys, the counts and the list).
    Returns the positions whose lane finished (bool [N])."""
    last = b == static.max_depth
    n = w.rec.shape[0]
    src, front, visit = visits(w, b)
    rec = w.rec[src]
    f = fields(rec)
    alive_in = front & ((f["flags"] & ALIVE) != 0)
    pend = (f["flags"] & PENDING) != 0
    occluded = occ[src] if occ is not None else torch.zeros_like(visit)
    flags_in = (f["flags"] & SPECULAR) | (alive_in.to(torch.int32) << 1) \
        | (occluded.to(torch.int32) << 2)
    pending = None
    if b > 0:
        pending = torch.where((visit & pend)[:, None], f["pending"], 0.0)
    s = shade_torch(scene, static, b, seed, iteration, f["lanes"], t, prim,
                    w.ro, w.rd, f["li"], f["beta"], f["prev_pdf"], flags_in,
                    pending, psample, w.sorted and not last,
                    w.shadow_key is not None and not last, plain)
    w.rays += s.rays
    if last:
        done = visit
    else:
        cand = visit & s.cand
        alive = visit & ((s.flags & ALIVE) != 0)
        sss = visit & ((s.flags & SSS) != 0)
        done = visit & ~(alive | cand | sss)
    slot = f["slot"].long()
    w.out[slot[done]] = s.li[done]
    if last:
        return done
    keep = visit & ~done
    new = rec.clone()
    new[:, LI:LI + 3] = s.li
    new[:, PDF] = s.prev_pdf
    new[:, BETA:BETA + 3] = s.beta
    _bits(new[:, FLAGS])[:] = torch.where(
        done, 0, s.flags | (cand.to(torch.int32) << 4))
    new[:, PEND:PEND + 3] = torch.where(cand[:, None], s.pending,
                                        f["pending"])
    w.ray[0] = s.ro
    w.ray[1] = s.rd
    if w.sorted:
        w.spare[keep] = new[keep]
        w.key[front] = s.key[front]
        w.shadow_t[:] = torch.where(front, s.shadow_t, 0.0)
        if w.shadow_key is not None:
            w.shadow_key[:] = torch.where(front, s.shadow_key, NO_SHADOW_KEY)
        ids = (keep & ~alive).nonzero()[:, 0].to(torch.int32)
        w.lists[(b + 1) % 2][:ids.shape[0]] = ids
        w.counts[b + 1, 0] = (front & alive).sum()
        w.counts[b + 1, 1] = ids.shape[0]
    else:   # a finished lane's record too, flags 0: later bounces skip it
        w.rec[visit] = new[visit]
        w.tmax[:] = torch.where(visit & ~alive, 0.0, w.tmax)
        w.shadow_t[:] = torch.where(visit, s.shadow_t, w.shadow_t)
        if w.shadow_key is not None:
            w.shadow_key[:] = torch.where(visit, s.shadow_key, w.shadow_key)
    w.shadow_o[:] = torch.where(cand[:, None], s.shadow_o, w.shadow_o)
    w.shadow_d[:] = torch.where(cand[:, None], s.shadow_d, w.shadow_d)
    return done


# ---------------------------------------------------------------------------
# the kernel (csrc/pt_shade.cu)
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p


class _ShadeArgs(ctypes.Structure):   # PtShadeArgs
    _fields_ = (
        [(k, _P) for k in (
            "t prim psample rec rec_out order list_in list_out counts occ "
            "ray tmax so sd st key skey out rays prim_attrs mats lights cdf "
            "env_data env_u env_v env_w tex tex_offset tex_w tex_h "
            "center").split()]
        + [(k, ctypes.c_int) for k in (
            "n bounce last sorted n_lights env_cols env_rows all_kinds "
            "aniso bssrdf").split()]
        + [(k, ctypes.c_uint32) for k in ("seed", "iteration")]
        + [(k, ctypes.c_float) for k in (
            "env_tmax", "eps", "key_inv", "shadow_inv")])


def _lib():
    lib = load_library("pt_shade")
    if lib.pt_shade.argtypes is None:
        lib.pt_shade.restype = ctypes.c_int
        lib.pt_shade.argtypes = [ctypes.POINTER(_ShadeArgs), _P]
    return lib


def _inv32(x) -> float:
    """1 / x as PyTorch computes a division by the Python float x on CUDA:
    the product with the float32 reciprocal of float32(x)."""
    return float(np.float32(1.0) / np.float32(x))


def _ptr(x):
    return None if x is None else x.data_ptr()


def shade_cuda(scene, static, b, seed, iteration, w: Wave, t, prim,
               occ=None, psample=None) -> None:
    """Launch csrc/pt_shade.cu: `shade`'s contract on CUDA tensors."""
    dev = w.rec.device
    n = w.rec.shape[0]
    check_cuda_f32("rec", w.rec, (n, REC), dev)
    for name, x, shape in (("ro", w.ro, (n, 3)), ("rd", w.rd, (n, 3)),
                           ("tmax", w.tmax, (n,)), ("t", t, (n,)),
                           ("shadow_o", w.shadow_o, (n, 3)),
                           ("shadow_d", w.shadow_d, (n, 3)),
                           ("shadow_t", w.shadow_t, (n,)),
                           ("out", w.out, (n, 3))):
        check_cuda_f32(name, x, shape, dev)
    check_cuda_f32("prim", prim, (n,), dev, torch.int32)
    check_cuda_f32("rays", w.rays, (2,), dev, torch.int64)
    if w.shadow_key is not None:
        check_cuda_f32("shadow_key", w.shadow_key, (n,), dev, torch.int32)
    if w.sorted:
        check_cuda_f32("spare", w.spare, (n, REC), dev)
        check_cuda_f32("key", w.key, (n,), dev, torch.int32)
        check_cuda_f32("lists", w.lists, (2, n), dev, torch.int32)
        check_cuda_f32("counts", w.counts, (static.max_depth + 2, 2), dev,
                       torch.int32)
        if w.order is not None:
            check_cuda_f32("order", w.order, (n,), dev, torch.int64)
        if psample is not None:
            raise ValueError("an explicit psample runs unsorted")
    if (occ is None) != (b == 0):
        raise ValueError("occ is the previous bounce's verdicts: None at "
                         "bounce 0 only")
    if occ is not None:
        check_cuda_f32("occ", occ, (n,), dev, torch.bool)
    if psample is not None:
        need = PSS_CAM_DIMS + static.max_depth * PSS_BOUNCE_DIMS
        check_cuda_f32("psample", psample, (None, n), dev)
        if psample.shape[0] < need:
            raise ValueError(f"psample needs {need} rows, got "
                             f"{psample.shape[0]}")
    if not 0 <= b <= static.max_depth:
        raise ValueError(f"bounce {b} outside 0..{static.max_depth}")
    check_cuda_f32("prim_attrs", scene.prim_attrs, (None, 40), dev)
    check_cuda_f32("mat_attrs", scene.mat_attrs, (None, 24), dev)
    rows = n_light_rows(static)
    check_cuda_f32("light_attrs", scene.light_attrs, (rows, 24), dev)
    check_cuda_f32("light_cdf", scene.light_cdf, (rows + 2,), dev)
    check_cuda_f32("world_center", scene.world_center, (3,), dev)
    a = _ShadeArgs()
    if static.has_infinite:
        check_cuda_f32("env_data", scene.env_data, (None, None, 3), dev)
        for name in ("env_u", "env_v", "env_w"):
            check_cuda_f32(name, getattr(scene, name), (3,), dev)
        a.env_data, a.env_u, a.env_v, a.env_w = (
            x.data_ptr() for x in (scene.env_data, scene.env_u, scene.env_v,
                                   scene.env_w))
        a.env_cols, a.env_rows = scene.env_data.shape[1], \
            scene.env_data.shape[0]
        a.env_tmax = 2.0 * scene.world_radius - scene.epsilon
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
    last = b == static.max_depth
    a.t, a.prim, a.psample = t.data_ptr(), prim.data_ptr(), _ptr(psample)
    a.rec = w.rec.data_ptr()
    a.rec_out = (w.spare if w.sorted else w.rec).data_ptr()
    a.order = _ptr(w.order)
    if w.sorted:
        a.list_in = w.lists[b % 2].data_ptr()
        a.list_out = w.lists[(b + 1) % 2].data_ptr()
        a.counts = w.counts.data_ptr()
        a.key = w.key.data_ptr()
    a.occ = _ptr(occ)
    a.ray, a.tmax = w.ray.data_ptr(), w.tmax.data_ptr()
    a.so, a.sd, a.st = (x.data_ptr() for x in (w.shadow_o, w.shadow_d,
                                               w.shadow_t))
    a.skey = _ptr(w.shadow_key)
    a.out, a.rays = w.out.data_ptr(), w.rays.data_ptr()
    a.prim_attrs, a.mats, a.lights, a.cdf, a.center = (
        x.data_ptr() for x in (scene.prim_attrs, scene.mat_attrs,
                               scene.light_attrs, scene.light_cdf,
                               scene.world_center))
    a.n, a.bounce, a.last, a.sorted = n, b, int(last), int(w.sorted)
    a.n_lights = static.n_lights
    a.all_kinds = int(kernels.all_kinds(kinds_of(static)))
    a.aniso, a.bssrdf = int(static.has_aniso), int(static.has_bssrdf)
    a.seed, a.iteration = int(seed) & 0xFFFFFFFF, int(iteration) & 0xFFFFFFFF
    a.eps = float(scene.epsilon)
    a.key_inv = _inv32(2.0 * max(scene.world_radius, 1e-6))
    a.shadow_inv = _inv32(2.0 * scene.world_radius)
    rc = _lib().pt_shade(ctypes.byref(a),
                         torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "pt_shade")
    STATS.launches += 1
