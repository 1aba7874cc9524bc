"""Instant radiosity: cached VPL sets gathered by camera rays.

The port of gpu_pathtracer_tpu/integrators/ir.py (the reference IR,
pathtracer.cu:2352-2513). Every IR_MAX_VPLS iterations the renderer
regenerates IR_MAX_VPLS light paths (`generate_vpls`, a 32-lane walk
storing a VPL at each surface it reaches), and each iteration's camera
pass (`render_lanes`) walks through delta surfaces and, at the first
non-delta one, gathers the VPLs of one path (row `vpl_iter`) with one
shadow ray each.

Quirks kept from the reference, as the JAX package keeps them: the
squared distance is clamped to `vpl_bias` (pathtracer.cu:2488); slot 0
is the emission point, emitting one-sided and weighted by 1 / `pdf0`
(its pdfA x choicePdf, 2494-2498); Le is added at every bounce of the
delta chain, unweighted (2462-2464); delta-material VPLs are skipped
(2500-2501); NaN/Inf lanes write 0 (the JAX package's deviation, 2510).

The gather differs from the JAX package only in what it leaves out, not
in what it computes: it runs over the gathering lanes only (compacted
with `nonzero`), and over the row's `count` slots, not all
IR_MAX_VPLS: the other slots contribute nothing there. Their shadow
rays go to one any-hit call of count x lanes rays, split by slots into
calls of at most GATHER_MAX_RAYS rays; a bounce where no lane gathers
skips the gather (one host read, as the JAX package's `lax.cond`).

Random numbers (core/rng.py): the camera pass reads the tag-0 pixel
sites (0-3 the camera, PSS_CAM_DIMS + PSS_BOUNCE_DIMS b + k for k = 0-2
bounce b's BSDF sample); the VPL paths read tag IR_VPL_TAG keyed by path
index and the iteration that regenerates the set. An explicit `psample`
replaces either stream row for row (the parity tests).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from gpu_pathtracer_tpu_torch.core.rng import (
    IR_VPL_TAG, PSS_BOUNCE_DIMS, PSS_CAM_DIMS, lane_stream,
)
from gpu_pathtracer_tpu_torch.core.vecmath import (
    dot, is_black, luminance, normalize,
)
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators.common import primary_rays
from gpu_pathtracer_tpu_torch.integrators.pt import lane_ids_of
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod

IR_MAX_VPLS = 32          # pathtracer.cu:2352
IR_EMIT_DIMS = 8          # VPL path emission sites (5 read)
IR_BOUNCE_DIMS = 4        # VPL path sites per bounce (4 read)
GATHER_MAX_RAYS = 1 << 24  # shadow rays per any-hit call of the gather


@dataclass
class VplStore:
    """vpls[path][slot] (pathtracer.cu:2363-2364)."""
    beta: torch.Tensor     # [P, S, 3]
    dir: torch.Tensor      # [P, S, 3] incoming direction at the VPL
    pos: torch.Tensor      # [P, S, 3]
    nor: torch.Tensor      # [P, S, 3]
    uv: torch.Tensor       # [P, S, 2]
    dpdu: torch.Tensor     # [P, S, 3]
    mat_idx: torch.Tensor  # [P, S] i32
    pdf0: torch.Tensor     # [P] pdfA x choicePdf of the emission point
    count: torch.Tensor    # [P] i32


def vpls_from_numpy(arrays: dict, device) -> VplStore:
    """A VplStore on `device` from numpy fields (the JAX package's
    VplStore read out field by field; extra keys are ignored)."""
    out = {}
    for f in dataclasses.fields(VplStore):
        a = np.asarray(arrays[f.name])
        dtype = torch.int32 if f.name in ("mat_idx", "count") \
            else torch.float32
        out[f.name] = torch.as_tensor(np.array(a), dtype=dtype,
                                      device=device)
    return VplStore(**out)


def generate_vpls(scene, static, seed: int, iteration: int,
                  with_stats: bool = False, psample=None, plain: bool = False):
    """GenerateVpl (pathtracer.cu:2367-2439): IR_MAX_VPLS light paths of
    at most max_depth bounces. Returns the VplStore (and, with_stats, the
    closest hits traced, 0-d int64)."""
    p = s = IR_MAX_VPLS
    dev = scene.device
    eps = scene.epsilon
    lanes = torch.arange(p, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    rng = lane_stream(seed, iteration, lanes, psample, 0, IR_EMIT_DIMS,
                      IR_VPL_TAG, plain)
    light_idx, choice_pdf = lights_mod.pick_light(scene, rng.uniform())
    light_idx = torch.clamp_max(light_idx, max(static.n_lights - 1, 0))
    u1, u2, u3 = rng.uniform3()
    u4 = rng.uniform()
    ro, rd, l_nor, radiance, pdf_a, pdf_w = \
        lights_mod.sample_area_light_emission(scene, light_idx, u1, u2, u3,
                                              u4, eps)
    denom = torch.clamp_min(pdf_a * pdf_w * choice_pdf, 1e-30)
    beta = radiance * (torch.abs(dot(rd, l_nor)) / denom)[:, None]

    z3 = torch.zeros((p, s, 3), dtype=torch.float32, device=dev)
    store = VplStore(
        beta=z3.clone(), dir=z3.clone(), pos=z3.clone(), nor=z3.clone(),
        uv=torch.zeros((p, s, 2), dtype=torch.float32, device=dev),
        dpdu=z3.clone(),
        mat_idx=torch.full((p, s), -1, dtype=torch.int32, device=dev),
        pdf0=pdf_a * choice_pdf,
        count=torch.ones(p, dtype=torch.int32, device=dev))
    # slot 0 = the emission point (pathtracer.cu:2386-2393)
    store.beta[:, 0] = radiance
    store.pos[:, 0] = ro
    store.nor[:, 0] = l_nor

    alive = torch.full((p,), static.n_lights > 0, dtype=torch.bool,
                       device=dev)
    for b in range(static.max_depth):
        rng = lane_stream(seed, iteration, lanes, psample,
                          IR_EMIT_DIMS + b * IR_BOUNCE_DIMS, IR_BOUNCE_DIMS,
                          IR_VPL_TAG, plain)
        rays = rays + alive.sum()
        hit = traverse.intersect_closest(
            scene, static, ro, rd, eps, torch.where(alive, torch.inf, 0.0),
            plain)
        alive = alive & hit.valid
        w = torch.clamp(store.count, 0, s - 1).long()
        put = alive & (store.count < s)
        for name, val in (("beta", beta), ("dir", -rd), ("pos", hit.pos),
                          ("nor", hit.nor), ("uv", hit.uv),
                          ("dpdu", hit.dpdu), ("mat_idx", hit.mat_idx)):
            arr = getattr(store, name)
            m = put.reshape(put.shape + (1,) * (val.dim() - 1))
            arr[lanes, w] = torch.where(m, val, arr[lanes, w])
        store.count = torch.where(put, store.count + 1, store.count)

        mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
        u1, u2, u3 = rng.uniform3()
        wo, fr, pdf = bsdf_mod.sample_bsdf(
            mat, -rd, hit.nor, hit.dpdu, u1, u2, u3, static.material_types,
            bsdf_mod.IMPORTANCE)
        alive = alive & ~is_black(fr)
        beta = torch.where(alive[:, None],
                           beta * fr * torch.abs(dot(wo, hit.nor))[:, None]
                           / torch.clamp_min(pdf, 1e-30)[:, None], beta)
        ro = torch.where(alive[:, None], hit.pos, ro)
        rd = torch.where(alive[:, None], wo, rd)

        u_rr = rng.uniform()
        illumate = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
        do_rr = alive & (b > 3)
        alive = alive & ~(do_rr & (u_rr < illumate))
        scale = 1.0 / torch.clamp_min(1.0 - illumate, 1e-30)
        beta = torch.where((do_rr & alive)[:, None], beta * scale[:, None],
                           beta)
    if with_stats:
        return store, rays
    return store


def _expand(mat: bsdf_mod.MatParams, m: int) -> bsdf_mod.MatParams:
    """A one-row MatParams repeated for m lanes."""
    return dataclasses.replace(mat, **{
        f.name: getattr(mat, f.name).expand(m, *getattr(mat, f.name).shape[1:])
        for f in dataclasses.fields(mat) if f.name != "aniso"})


def _gather(scene, static, vpls, row, count, pos, nor, dpdu, wi, beta,
            mat_idx, uv, plain):
    """The VPL gather of the gathering lanes (pathtracer.cu:2479-2505):
    returns (their added radiance [m, 3], shadow rays traced)."""
    eps = scene.epsilon
    m = pos.shape[0]
    types = static.material_types
    v_beta, v_dir, v_pos, v_nor = (vpls.beta[row], vpls.dir[row],
                                   vpls.pos[row], vpls.nor[row])
    v_uv, v_dpdu, v_mat = vpls.uv[row], vpls.dpdu[row], vpls.mat_idx[row]

    # the shadow rays of every slot, one any-hit call per slot group
    d_b = pos[None, :, :] - v_pos[:count, None, :]           # [S, m, 3]
    d2_b = torch.clamp_min(dot(d_b, d_b), 1e-30)
    out_b = d_b / torch.sqrt(d2_b)[..., None]
    st_b = torch.sqrt(d2_b) - eps
    group = max(1, GATHER_MAX_RAYS // max(m, 1))
    occ = []
    for i0 in range(0, count, group):
        k = min(group, count - i0)
        occ.append(traverse.intersect_any(
            scene, static, pos.repeat(k, 1), -out_b[i0:i0 + k].reshape(-1, 3),
            eps, st_b[i0:i0 + k].reshape(-1), plain).reshape(k, m))
    occ = torch.cat(occ)
    del d_b, d2_b, out_b, st_b

    mat = bsdf_mod.gather_materials(scene, static, mat_idx, uv)
    li = torch.zeros_like(pos)
    for i in range(count):
        d = pos - v_pos[i]
        out = normalize(d)
        d2 = dot(d, d)
        ok = ~occ[i]
        d2c = torch.clamp_min(d2, static.vpl_bias)
        g = torch.abs(dot(out, nor)) * torch.abs(dot(out, v_nor[i])) \
            / torch.clamp_min(d2c, 1e-30)
        fr1, _ = bsdf_mod.eval_bsdf(mat, wi, -out, nor, dpdu, types)
        if i == 0:   # the emission point, one-sided (cu:2494-2498)
            contrib = beta * fr1 * v_beta[i] * \
                (g / torch.clamp_min(vpls.pdf0[row], 1e-30))[:, None]
            ok = ok & (dot(d, v_nor[i]) > 0.0)
        else:
            vmat = _expand(bsdf_mod.gather_materials(
                scene, static, v_mat[i:i + 1], v_uv[i:i + 1]), m)
            fr2, _ = bsdf_mod.eval_bsdf(
                vmat, v_dir[i].expand(m, 3), out, v_nor[i].expand(m, 3),
                v_dpdu[i].expand(m, 3), types)
            contrib = beta * fr1 * fr2 * v_beta[i] * g[:, None]
            ok = ok & ~bsdf_mod.is_delta(vmat.type)
        li = li + torch.where(ok[:, None], contrib, 0.0)
    return li, count * m


def render_lanes(scene, static, seed: int, iteration: int, pixel_x, pixel_y,
                 vpls: VplStore, vpl_iter: int, with_stats: bool = False,
                 psample=None, plain: bool = False):
    """InstantRadiosity camera pass (pathtracer.cu:2441-2513): per-lane
    radiance [N, 3] gathering VPL row `vpl_iter` (and, with_stats, the
    rays traced: closest hits and gather shadow rays, 0-d int64)."""
    n = pixel_x.shape[0]
    dev = pixel_x.device
    eps = scene.epsilon
    lanes = lane_ids_of(static, pixel_x, pixel_y)
    rng0 = lane_stream(seed, iteration, lanes, psample, 0, PSS_CAM_DIMS,
                       plain=plain)
    ro, rd = primary_rays(scene, static, rng0, pixel_x, pixel_y)
    count = int(vpls.count[vpl_iter])

    li = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(static.max_depth):
        rng = lane_stream(seed, iteration, lanes, psample,
                          PSS_CAM_DIMS + b * PSS_BOUNCE_DIMS, PSS_BOUNCE_DIMS,
                          plain=plain)
        rays = rays + alive.sum()
        hit = traverse.intersect_closest(
            scene, static, ro, rd, eps, torch.where(alive, torch.inf, 0.0),
            plain)
        alive = alive & hit.valid

        le = lights_mod.area_light_le(scene, hit.light_idx, hit.nor, -rd)
        li = li + torch.where((alive & (hit.light_idx >= 0))[:, None], le,
                              0.0)

        mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
        delta = bsdf_mod.is_delta(mat.type)
        # the delta chain continues (pathtracer.cu:2466-2477)
        u1, u2, u3 = rng.uniform3()
        wo, fr, pdf = bsdf_mod.sample_bsdf(
            mat, -rd, hit.nor, hit.dpdu, u1, u2, u3, static.material_types)
        go = alive & delta & ~is_black(fr)
        beta_next = beta * fr * torch.abs(dot(hit.nor, wo))[:, None] \
            / torch.clamp_min(pdf, 1e-30)[:, None]

        # the VPL gather at the first non-delta surface
        idx = (alive & ~delta).nonzero().squeeze(1)
        if idx.numel():
            add, r = _gather(scene, static, vpls, vpl_iter, count,
                             hit.pos[idx], hit.nor[idx], hit.dpdu[idx],
                             -rd[idx], beta[idx], hit.mat_idx[idx],
                             hit.uv[idx], plain)
            li = li.index_put((idx,), li[idx] + add)
            rays = rays + r
        beta = torch.where(go[:, None], beta_next, beta)
        ro = torch.where(go[:, None], hit.pos, ro)
        rd = torch.where(go[:, None], wo, rd)
        alive = go   # non-delta lanes are done after the gather
        if not bool(alive.any()):
            break

    bad = ~torch.isfinite(li).all(dim=-1)
    li = torch.where(bad[:, None], 0.0, li)
    if with_stats:
        return li, rays
    return li
