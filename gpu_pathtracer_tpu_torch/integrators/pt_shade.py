"""The PT wavefront's shading of one bounce, as one CUDA kernel.

`shade` takes the closest-hit query's raw (t, prim) and the lane state
of integrators/pt.py::trace_paths and returns the next lane state: the
previous bounce's NEE credit where its shadow ray was not occluded, the
arrival credit (an emitter hit, or the sky on a miss), the end of lanes
that reach a BSSRDF prim (flagged SSS: trace_paths' subsurface hook
shades them), the NEE light sample (its shadow ray, and its unoccluded
credit beta * Ld, pending until the any-hit query has run), the BSDF
sample, the roulette after bounce 3 and, when asked, the coherence keys
of the next ray and of the shadow ray. At b = max_depth (`last`) only
the two credits run.

On CUDA tensors it launches csrc/pt_shade.cu (K2's shading code,
csrc/shade.cuh) and counts the launch in `STATS`; it raises on what the
kernel does not take and has no fallback. `shade_torch`, its plain
version, is the wavefront's bounce in PyTorch (pt._arrival_credit,
bsdf.gather_materials, common.nee_sample, bsdf.sample_bsdf, the
roulette, pt._sort_key, common._shadow_sort_key): it runs for CPU
tensors and under `plain=True`, and counts its calls on CUDA tensors in
`STATS.plain_cuda`.

Lane flags (int32): SPECULAR, ALIVE, OCCLUDED (in: the previous
bounce's shadow ray was blocked) and SSS (out: the lane ended on a
BSSRDF prim this bounce).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from gpu_pathtracer_tpu_torch import kernels
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

SPECULAR, ALIVE, OCCLUDED, SSS = 1, 2, 4, 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float


@dataclass
class Shaded:
    """One bounce's shading: the next lane state, the pending NEE credit,
    the shadow ray (tmax 0 where the lane made none) and the keys."""
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
    key: torch.Tensor | None         # [N] int64, pt._sort_key
    shadow_key: torch.Tensor | None  # [N] int64, common._shadow_sort_key
    rays: torch.Tensor        # [2] int64: closest-hit rays, shadow rays


def shade(scene, static, b, seed, iteration, lanes, t, prim, ro, rd, li,
          beta, prev_pdf, flags, pending=None, psample=None, key=False,
          shadow_key=False, plain=False) -> Shaded:
    """Shade bounce `b` (b == static.max_depth: the epilogue's credits)
    of lanes whose closest-hit query gave (t, prim; prim -1 on a miss).
    `pending` (None at bounce 0) is the previous bounce's NEE credit,
    added where `flags` has no OCCLUDED; `key` / `shadow_key` ask for the
    coherence keys. The kernel on CUDA tensors, else (or under `plain`)
    `shade_torch`."""
    if plain or ro.device.type != "cuda":
        return shade_torch(scene, static, b, seed, iteration, lanes, t,
                           prim, ro, rd, li, beta, prev_pdf, flags, pending,
                           psample, key, shadow_key, plain)
    return shade_cuda(scene, static, b, seed, iteration, lanes, t, prim, ro,
                      rd, li, beta, prev_pdf, flags, pending, psample, key,
                      shadow_key)


def shade_torch(scene, static, b, seed, iteration, lanes, t, prim, ro, rd,
                li, beta, prev_pdf, flags, pending=None, psample=None,
                key=False, shadow_key=False, plain=True) -> Shaded:
    """The plain version of `shade`, on any device: the wavefront's
    bounce in PyTorch, in the kernel's order of operations."""
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
                      None, None,
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
        shadow_t, pt._sort_key(scene, ro, rd, alive) if key else None,
        common._shadow_sort_key(scene, hit.pos, cand & (shadow_t > 0.0))
        if shadow_key else None,
        torch.stack([n_closest, cand.sum()]))


def _lib():
    lib = load_library("pt_shade")
    if lib.pt_shade.argtypes is None:
        lib.pt_shade.restype = ctypes.c_int
        lib.pt_shade.argtypes = [
            _I, _I, _I, _U, _U, _P,        # n, b, last, seed, it, psample
            _P, _P, _P, _P, _P, _P, _P,    # t, prim, ro, rd, li, beta, pdf
            _P, _P, _P,                    # flags, lane ids, pending
            _P, _P, _P, _I, _P,            # prim, mat, light rows, L, cdf
            _P, _I, _I, _P, _P, _P, _F,    # env data, w, h, frame, tmax
            _P, _P, _P, _P,                # tex data, offsets, widths, heights
            _I, _F, _I, _I,                # all kinds, eps, aniso, bssrdf
            _P, _F, _F,                    # centre, the keys' scales
            _P, _P, _P, _P, _P, _P,        # ro rd li beta pdf flags out
            _P, _P, _P, _P,                # pending, shadow o, d, tmax out
            _P, _P, _P, _P]                # key, shadow key, counts, stream
    return lib


def _inv32(x) -> float:
    """1 / x as PyTorch computes a division by the Python float x on CUDA:
    the product with the float32 reciprocal of float32(x)."""
    return float(np.float32(1.0) / np.float32(x))


def shade_cuda(scene, static, b, seed, iteration, lanes, t, prim, ro, rd, li,
               beta, prev_pdf, flags, pending=None, psample=None, key=False,
               shadow_key=False) -> Shaded:
    """Launch csrc/pt_shade.cu: `shade`'s contract on CUDA tensors."""
    dev = ro.device
    n = ro.shape[0]
    for name, x, shape in (("ro", ro, (n, 3)), ("rd", rd, (n, 3)),
                           ("li", li, (n, 3)), ("beta", beta, (n, 3)),
                           ("prev_pdf", prev_pdf, (n,)), ("t", t, (n,))):
        check_cuda_f32(name, x, shape, dev)
    for name, x in (("prim", prim), ("flags", flags), ("lanes", lanes)):
        check_cuda_f32(name, x, (n,), dev, torch.int32)
    if pending is not None:
        check_cuda_f32("pending", pending, (n, 3), dev)
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
    env = (None, 0, 0, None, None, None, 0.0)
    if static.has_infinite:
        check_cuda_f32("env_data", scene.env_data, (None, None, 3), dev)
        for name in ("env_u", "env_v", "env_w"):
            check_cuda_f32(name, getattr(scene, name), (3,), dev)
        env = (scene.env_data.data_ptr(), scene.env_data.shape[1],
               scene.env_data.shape[0], scene.env_u.data_ptr(),
               scene.env_v.data_ptr(), scene.env_w.data_ptr(),
               2.0 * scene.world_radius - scene.epsilon)
    tex = (None,) * 4
    if static.has_textures:
        check_cuda_f32("tex_data", scene.tex_data, (None, 3), dev,
                       torch.uint8)
        n_tex = scene.tex_offset.shape[0]
        for name in ("tex_offset", "tex_w", "tex_h"):
            check_cuda_f32(name, getattr(scene, name), (n_tex,), dev,
                           torch.int32)
        tex = tuple(x.data_ptr() for x in (scene.tex_data, scene.tex_offset,
                                           scene.tex_w, scene.tex_h))

    f32 = dict(dtype=torch.float32, device=dev)
    out = [torch.empty((n, 3), **f32) for _ in range(4)]   # ro rd li beta
    pdf_out = torch.empty(n, **f32)
    flags_out = torch.empty(n, dtype=torch.int32, device=dev)
    pend_out, so_out, sd_out = (torch.empty((n, 3), **f32) for _ in range(3))
    st_out = torch.empty(n, **f32)
    key_out = torch.empty(n, dtype=torch.int64, device=dev) if key else None
    skey_out = torch.empty(n, dtype=torch.int64, device=dev) \
        if shadow_key else None
    counts = torch.empty(2, dtype=torch.int64, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    rc = _lib().pt_shade(
        n, b, int(b == static.max_depth), int(seed) & 0xFFFFFFFF,
        int(iteration) & 0xFFFFFFFF, ptr(psample), t.data_ptr(),
        prim.data_ptr(), ro.data_ptr(), rd.data_ptr(), li.data_ptr(),
        beta.data_ptr(), prev_pdf.data_ptr(), flags.data_ptr(),
        lanes.data_ptr(), ptr(pending), scene.prim_attrs.data_ptr(),
        scene.mat_attrs.data_ptr(), scene.light_attrs.data_ptr(),
        static.n_lights, scene.light_cdf.data_ptr(), *env, *tex,
        int(kernels.all_kinds(kinds_of(static))), float(scene.epsilon),
        int(static.has_aniso), int(static.has_bssrdf),
        scene.world_center.data_ptr(),
        _inv32(2.0 * max(scene.world_radius, 1e-6)),
        _inv32(2.0 * scene.world_radius), *(x.data_ptr() for x in out),
        pdf_out.data_ptr(), flags_out.data_ptr(), pend_out.data_ptr(),
        so_out.data_ptr(), sd_out.data_ptr(), st_out.data_ptr(),
        ptr(key_out), ptr(skey_out), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "pt_shade")
    STATS.launches += 1
    return Shaded(*out, pdf_out, flags_out, pend_out, so_out, sd_out, st_out,
                  key_out, skey_out, counts)
