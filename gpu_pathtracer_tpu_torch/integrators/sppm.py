"""Stochastic progressive photon mapping with a photon grid on the device.

The port of gpu_pathtracer_tpu/integrators/sppm.py (the reference SPPM,
pathtracer.cu:1986-2348). One iteration (`render_iteration`):
1. eye pass: one camera path per pixel walks through delta and low-alpha
   glossy surfaces, adds direct light with MIS, and parks a visible
   point at the first other surface (TraceRay, 2101-2205);
2. grid: every visible point emits 27 (cell, point) entries covering its
   radius box, sorted by cell hash with a stable `torch.sort`; a bucket
   is found with `torch.searchsorted` (the JAX package's device sort,
   replacing BuildHashTable, 2039-2099);
3. photon pass: light paths deposit flux into the visible points of
   their cell (TracePhoton, 2207-2281);
4. density pass: the progressive radius shrink (alpha = 0.7) and the
   tau / (pi r^2 N iteration) estimate; the film is absolute, not
   accumulated (2330-2348, Output 2524-2527).

Kept, because it is the estimator the port is held against: the capped,
sampled deposit (each photon takes min(bucket length, K_CAP) entries of
its bucket from a random rotation, weighted bucket length / K: unbiased,
exact once buckets are shorter than K_CAP), and the bfloat16 rounding of
a visible point's normal, tangent and direction before the BSDF is
evaluated at a deposit. Left out, because they are TPU layout
workarounds: the photons' sort by bucket length with its four gated
slices, and the x8 / x32 padded side tables; a deposit here is one
`index_add_` of (phi, m) rows into an [N, 4] accumulator over the pairs
that pass the distance test (compacted with `nonzero`). On the card the
adds land in no fixed order, so phi and m agree with another run within
float32 summation order, not bit for bit.

The JAX package's deviations from the reference are kept: the batched
progressive update, grid bounds over valid visible points only, Le only
at lights (light_idx >= 0), no depth of field, media or sky sampling.
Pixels whose eye path escapes keep their previous visible point.

Random numbers (core/rng.py): the eye pass reads the tag-0 pixel sites
(0-1 the pixel jitter, PSS_CAM_DIMS + SPPM_EYE_DIMS b + k bounce b's
nine), the photons tag SPPM_PHOTON_TAG keyed by photon index. An
explicit `psample` replaces a pass's stream row for row (the tests).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from gpu_pathtracer_tpu_torch.core.rng import (
    MASK32, PSS_CAM_DIMS, SPPM_PHOTON_TAG, lane_stream,
)
from gpu_pathtracer_tpu_torch.core.sampling import power_heuristic
from gpu_pathtracer_tpu_torch.core.vecmath import dot, is_black, luminance
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators.pt import lane_ids_of
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import camera as camera_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod

SPPM_ALPHA = 0.7        # progressive shrink factor (pathtracer.cu:2252)
K_CAP = 32              # visible-point entries a photon deposits into
SPPM_EYE_DIMS = 12      # eye-pass sites per bounce (9 read)
PHOTON_EMIT_DIMS = 8    # photon emission sites (5 read)
PHOTON_BOUNCE_DIMS = 8  # photon sites per bounce (5 read)
HASH_MUL = (73856093, 19349663, 83492791)   # Hash (pathtracer.cu:2033-2036)


@dataclass
class SppmState:
    """Per-pixel VisiblePoint store (pathtracer.cu:1986-1997)."""
    ld: torch.Tensor       # [N, 3] accumulated direct light
    ind: torch.Tensor      # [N, 3] last finite indirect estimate
    beta: torch.Tensor     # [N, 3] eye-path throughput at the point
    dir: torch.Tensor      # [N, 3] -ray.d at the point
    pos: torch.Tensor      # [N, 3]
    nor: torch.Tensor      # [N, 3]
    uv: torch.Tensor       # [N, 2]
    dpdu: torch.Tensor     # [N, 3]
    mat_idx: torch.Tensor  # [N] i32
    tau: torch.Tensor      # [N, 3]
    radius: torch.Tensor   # [N]
    n: torch.Tensor        # [N] photon count statistic
    valid: torch.Tensor    # [N] bool


def init_state(n: int, init_radius: float, device) -> SppmState:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return SppmState(
        ld=z(n, 3), ind=z(n, 3), beta=z(n, 3), dir=z(n, 3), pos=z(n, 3),
        nor=z(n, 3), uv=z(n, 2), dpdu=z(n, 3),
        mat_idx=torch.full((n,), -1, dtype=torch.int32, device=device),
        tau=z(n, 3), radius=torch.full((n,), init_radius,
                                       dtype=torch.float32, device=device),
        n=z(n), valid=torch.zeros(n, dtype=torch.bool, device=device))


def state_from_numpy(arrays: dict, device) -> SppmState:
    """An SppmState on `device` from numpy fields (the JAX package's
    SppmState read out field by field; extra keys are ignored)."""
    dtypes = {"mat_idx": torch.int32, "valid": torch.bool}
    return SppmState(**{
        f.name: torch.as_tensor(np.array(arrays[f.name]),
                                dtype=dtypes.get(f.name, torch.float32),
                                device=device)
        for f in dataclasses.fields(SppmState)})


def _direct_light_no_env(scene, static, rng, pos, nor, dpdu, mat, wi, active,
                         plain):
    """SPPM's NEE with MIS: area lights only, no media (TraceRay,
    pathtracer.cu:2125-2172). Returns (Ld [N, 3], rays traced)."""
    eps = scene.epsilon
    ld = torch.zeros_like(pos)
    if static.n_lights == 0:
        return ld, 0
    types = static.material_types
    idx, choice_pdf = lights_mod.pick_light(scene, rng.uniform())
    idx = torch.clamp_max(idx, static.n_lights - 1)
    u1, u2 = rng.uniform2()
    rad, _, sd, st, _, lpdf = lights_mod.sample_area_light(scene, idx, pos,
                                                           u1, u2, eps)
    cand = active & ~is_black(rad) & (lpdf > 0.0)
    rays = cand.sum()
    occluded = traverse.intersect_any(scene, static, pos, sd, eps,
                                      torch.where(cand, st, 0.0), plain)
    cand = cand & ~occluded
    fr, sample_pdf = bsdf_mod.eval_bsdf(mat, wi, sd, nor, dpdu, types)
    weight = power_heuristic(lpdf * choice_pdf, sample_pdf)
    contrib = weight[:, None] * fr * rad * torch.abs(dot(nor, sd))[:, None] \
        / torch.clamp_min(lpdf * choice_pdf, 1e-30)[:, None]
    ld = ld + torch.where(cand[:, None], contrib, 0.0)

    # the BSDF-sample branch against emitters (pathtracer.cu:2146-2171)
    u1, u2, u3 = rng.uniform3()
    wo, fr_s, pdf_s = bsdf_mod.sample_bsdf(mat, wi, nor, dpdu, u1, u2, u3,
                                           types)
    cand_b = active & ~(is_black(fr_s) | (pdf_s == 0.0))
    rays = rays + cand_b.sum()
    hit = traverse.intersect_closest(scene, static, pos, wo, eps,
                                     torch.where(cand_b, torch.inf, 0.0),
                                     plain)
    hit_light = cand_b & hit.valid & (hit.light_idx >= 0)
    lidx = torch.clamp_min(hit.light_idx, 0)
    le = lights_mod.area_light_le(scene, hit.light_idx, hit.nor, -wo)
    pdf_area, _ = lights_mod.area_light_pdf(scene, lidx, wo, hit.nor)
    lchoice = lights_mod.light_choice_pdf(scene, lidx)
    seg = hit.pos - pos
    len2 = dot(seg, seg)
    cos_l = torch.abs(dot(hit.nor, wo))
    l_pdf = pdf_area * len2 / torch.clamp_min(cos_l, 1e-30)
    w_b = power_heuristic(pdf_s, l_pdf * lchoice)
    contrib_b = w_b[:, None] * fr_s * le * torch.abs(dot(wo, nor))[:, None] \
        / torch.clamp_min(pdf_s, 1e-30)[:, None]
    hit_light = hit_light & ~is_black(le)
    return ld + torch.where(hit_light[:, None], contrib_b, 0.0), rays


def eye_pass(scene, static, seed: int, iteration: int, pixel_x, pixel_y,
             state: SppmState, psample=None, plain: bool = False):
    """TraceRay per pixel (pathtracer.cu:2101-2205, FP kernel 2289-2307).
    Returns (state, rays traced: 0-d int64)."""
    n = pixel_x.shape[0]
    dev = pixel_x.device
    eps = scene.epsilon
    types = static.material_types
    lanes = lane_ids_of(static, pixel_x, pixel_y)
    rng0 = lane_stream(seed, iteration, lanes, psample, 0, PSS_CAM_DIMS,
                       plain=plain)
    ox = rng0.uniform() - 0.5
    oy = rng0.uniform() - 0.5
    # no depth of field (quirk, pathtracer.cu:2302-2304)
    ro, rd = camera_mod.generate_primary_ray(
        scene.camera, pixel_x.float() + ox, pixel_y.float() + oy,
        torch.zeros((n, 2), dtype=torch.float32, device=dev),
        static.environment_camera)

    if iteration == 1:
        z = torch.zeros_like
        state = dataclasses.replace(
            state, radius=torch.full_like(state.radius, static.init_radius),
            n=z(state.n), ld=z(state.ld), tau=z(state.tau),
            ind=z(state.ind), valid=z(state.valid))

    f3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    ld_add = f3
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    specular = torch.zeros(n, dtype=torch.bool, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    stored = torch.zeros(n, dtype=torch.bool, device=dev)
    vp = dict(beta=f3, dir=f3, pos=f3, nor=f3, dpdu=f3,
              uv=torch.zeros((n, 2), dtype=torch.float32, device=dev),
              mat_idx=torch.full((n,), -1, dtype=torch.int32, device=dev))
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    for b in range(static.max_depth):
        rng = lane_stream(seed, iteration, lanes, psample,
                          PSS_CAM_DIMS + b * SPPM_EYE_DIMS, SPPM_EYE_DIMS,
                          plain=plain)
        rays = rays + alive.sum()
        hit = traverse.intersect_closest(
            scene, static, ro, rd, eps, torch.where(alive, torch.inf, 0.0),
            plain)
        alive = alive & hit.valid

        mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
        wi = -rd
        delta = bsdf_mod.is_delta(mat.type)
        ld, r = _direct_light_no_env(
            scene, static, rng, hit.pos, hit.nor, hit.dpdu, mat, wi,
            alive & ~delta & (hit.light_idx == -1), plain)
        rays = rays + r

        # emitter hit credit (quirk-guarded: light_idx >= 0)
        take_le = alive & (hit.light_idx >= 0)
        if b > 0:
            take_le = take_le & specular
        le = lights_mod.area_light_le(scene, hit.light_idx, hit.nor, -rd)
        ld = ld + torch.where(take_le[:, None], le, 0.0)
        ld_ok = torch.isfinite(ld).all(-1)
        ld_add = ld_add + torch.where((alive & ld_ok)[:, None], beta * ld,
                                      0.0)

        # walk through delta / low-alpha glossy (pathtracer.cu:2183-2196)
        walk = delta | (bsdf_mod.is_glossy(mat.type) & (mat.alpha_u < 0.2))
        u1, u2, u3 = rng.uniform3()
        wo, fr, pdf = bsdf_mod.sample_bsdf(mat, wi, hit.nor, hit.dpdu, u1,
                                           u2, u3, types)
        dead = is_black(fr)
        go = alive & walk & ~dead
        beta = torch.where(go[:, None],
                           beta * fr * torch.abs(dot(wo, hit.nor))[:, None]
                           / torch.clamp_min(pdf, 1e-30)[:, None], beta)
        specular = torch.where(go, delta, specular)
        ro = torch.where(go[:, None], hit.pos, ro)
        rd = torch.where(go[:, None], wo, rd)

        # park the visible point (pathtracer.cu:2198-2203)
        park = alive & ~walk
        for name, val in (("beta", beta), ("dir", wi), ("pos", hit.pos),
                          ("nor", hit.nor), ("uv", hit.uv),
                          ("dpdu", hit.dpdu), ("mat_idx", hit.mat_idx)):
            m = park[:, None] if val.dim() == 2 else park
            vp[name] = torch.where(m, val, vp[name])
        stored = stored | park
        alive = alive & ~park & ~(walk & dead)
        if not bool(alive.any()):   # every path parked or ended
            break

    sm = stored[:, None]
    upd = {name: torch.where(sm if val.dim() == 2 else stored, val,
                             getattr(state, name))
           for name, val in vp.items()}
    return dataclasses.replace(state, ld=state.ld + ld_add,
                               valid=state.valid | stored, **upd), rays


def _hash_cell(cell, hash_size: int):
    """pbrt-style spatial hash (Hash, pathtracer.cu:2033-2036) of int
    cells [..., 3], with uint32 products emulated in int64."""
    c = cell.to(torch.int64) & MASK32
    h = ((c[..., 0] * HASH_MUL[0]) & MASK32) \
        ^ ((c[..., 1] * HASH_MUL[1]) & MASK32) \
        ^ ((c[..., 2] * HASH_MUL[2]) & MASK32)
    return h % hash_size


def _to_cell(p, bmin, diag, res):
    pg = (p - bmin) / torch.where(diag > 0, diag, 1.0)
    return torch.floor(res.float() * pg).to(torch.int32)


def build_grid(state: SppmState, hash_size: int):
    """The photon grid (replaces BuildHashTable, pathtracer.cu:
    2039-2099). Returns (sorted_vp [27 N] i64, bucket_start [H + 1] i64,
    bounds_min, bounds_max, grid_res [3] i32): each valid visible point
    enters the <= 27 cells its radius box covers; the entries are sorted
    by cell hash (stable), so a photon finds its bucket as a range."""
    n = state.radius.shape[0]
    dev = state.radius.device
    valid = state.valid
    big = 3.4e38
    vpos = state.pos
    bmin = torch.where(valid[:, None], vpos, big).amin(0)
    bmax = torch.where(valid[:, None], vpos, -big).amax(0)
    any_valid = valid.any()
    bmin = torch.where(any_valid, bmin, 0.0)
    bmax = torch.where(any_valid, bmax, 1.0)
    r_max = state.radius.max()
    bmin = bmin - r_max
    bmax = bmax + r_max
    diag = bmax - bmin
    max_diag = diag.max()
    base_res = torch.floor(max_diag / torch.clamp_min(r_max, 1e-30))
    res = torch.clamp_min(
        torch.floor(base_res * diag / torch.clamp_min(max_diag, 1e-30)),
        1.0).to(torch.int32)

    r = state.radius[:, None]
    c_lo = torch.minimum(torch.clamp_min(_to_cell(vpos - r, bmin, diag, res),
                                         0), res - 1)
    c_hi = torch.minimum(torch.clamp_min(_to_cell(vpos + r, bmin, diag, res),
                                         0), res - 1)
    a = torch.arange(3, device=dev, dtype=torch.int32)
    offs = torch.stack(torch.meshgrid(a, a, a, indexing="ij"),
                       -1).reshape(27, 3)
    cells = c_lo[:, None, :] + offs[None, :, :]             # [N, 27, 3]
    ok = valid[:, None] & (cells <= c_hi[:, None, :]).all(-1)
    h = torch.where(ok, _hash_cell(cells, hash_size), hash_size).reshape(-1)
    del cells, ok
    order = torch.sort(h, stable=True).indices
    sorted_vp = order // 27   # the entry's visible point
    bucket_start = torch.searchsorted(
        h[order], torch.arange(hash_size + 1, device=dev, dtype=torch.int64))
    return sorted_vp, bucket_start, bmin, bmax, res


def _frame_bf16(x):
    """The bfloat16 rounding (to nearest even) of the deposit's frame
    vectors, as the JAX package's packed side table carries them."""
    return x.to(torch.bfloat16).to(torch.float32)


def _deposit(scene, static, state, frame, sorted_vp, acc, ppos, prd, pbeta,
             start, end, u_off):
    """All (photon, sampled entry) pairs of the depositing photons: each
    takes min(bucket length, K_CAP) entries of its bucket from rotation
    u_off, weighted bucket length / K; the pairs within the point's
    radius add (fr x beta x w, w) into acc [N, 4]."""
    blen = torch.clamp_min(end - start, 0)
    sel = torch.clamp_max(blen, K_CAP)
    off0 = torch.minimum((u_off * blen.float()).to(torch.int64),
                         torch.clamp_min(blen - 1, 0))
    kio = torch.arange(K_CAP, device=blen.device)[None, :]
    rel = off0[:, None] + kio
    rel = torch.where(rel >= blen[:, None],
                      rel - torch.clamp_min(blen[:, None], 1), rel)
    pair_ok = kio < sel[:, None]                               # [k, K]
    eidx = torch.clamp(start[:, None] + rel, 0, sorted_vp.shape[0] - 1)
    vp = sorted_vp[torch.where(pair_ok, eidx, 0)]
    d = ppos[:, None, :] - state.pos[vp]
    vrad = state.radius[vp]
    near = (dot(d, d) <= vrad * vrad) & state.valid[vp] & pair_ok
    ph, col = near.nonzero(as_tuple=True)
    if ph.numel() == 0:
        return
    fl = vp[ph, col]
    vnor, vdpdu, vdir = (f[fl] for f in frame)
    vmat = bsdf_mod.gather_materials(scene, static, state.mat_idx[fl],
                                     state.uv[fl])
    fr, _ = bsdf_mod.eval_bsdf(vmat, vdir, -prd[ph], vnor, vdpdu,
                               static.material_types)
    take = ~is_black(fr) & torch.isfinite(fr).all(-1)
    w = (blen.float() / torch.clamp_min(sel, 1).float())[ph]
    contrib = torch.where(take[:, None], fr * pbeta[ph] * w[:, None], 0.0)
    acc.index_add_(0, fl, torch.cat(
        [contrib, torch.where(take, w, 0.0)[:, None]], 1))


def photon_pass(scene, static, seed: int, iteration: int, state: SppmState,
                grid, n_photons: int, hash_size: int, psample=None,
                plain: bool = False, photon_ids=None):
    """TracePhoton (pathtracer.cu:2207-2281): returns (phi [N, 3], m [N],
    rays traced: 0-d int64), the visible points' flux sums and photon
    counts for the progressive update. Photons deposit at bounces > 0.
    `photon_ids` (default 0 .. n_photons - 1) are the photons traced:
    a rank of a sharded render traces its share of the ids."""
    sorted_vp, bucket_start, bmin, bmax, res = grid
    sorted_vp, bucket_start = sorted_vp.long(), bucket_start.long()
    dev = state.radius.device
    lanes = torch.arange(n_photons, device=dev) if photon_ids is None \
        else photon_ids
    n = lanes.shape[0]
    eps = scene.epsilon
    types = static.material_types
    diag = bmax - bmin
    frame = tuple(_frame_bf16(f) for f in (state.nor, state.dpdu, state.dir))
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    rng = lane_stream(seed, iteration, lanes, psample, 0, PHOTON_EMIT_DIMS,
                      SPPM_PHOTON_TAG, plain)
    light_idx, choice_pdf = lights_mod.pick_light(scene, rng.uniform())
    light_idx = torch.clamp_max(light_idx, max(static.n_lights - 1, 0))
    u1, u2, u3 = rng.uniform3()
    u4 = rng.uniform()
    ro, rd, l_nor, radiance, pdf_a, pdf_w = \
        lights_mod.sample_area_light_emission(scene, light_idx, u1, u2, u3,
                                              u4, eps)
    denom = torch.clamp_min(pdf_a * pdf_w * choice_pdf, 1e-30)
    beta = radiance * (torch.abs(dot(rd, l_nor)) / denom)[:, None]
    alive = torch.full((n,), static.n_lights > 0, dtype=torch.bool,
                       device=dev)
    acc = torch.zeros((state.radius.shape[0], 4), dtype=torch.float32,
                      device=dev)   # phi (3), m

    for b in range(static.max_depth):
        rng = lane_stream(seed, iteration, lanes, psample,
                          PHOTON_EMIT_DIMS + b * PHOTON_BOUNCE_DIMS,
                          PHOTON_BOUNCE_DIMS, SPPM_PHOTON_TAG, plain)
        rays = rays + alive.sum()
        hit = traverse.intersect_closest(
            scene, static, ro, rd, eps, torch.where(alive, torch.inf, 0.0),
            plain)
        alive = alive & hit.valid
        u_off = rng.uniform()

        # the deposit into the grid (bounces > 0, pathtracer.cu:2229-2262)
        if b > 0:
            cell = _to_cell(hit.pos, bmin, diag, res)
            in_bounds = ((cell >= 0) & (cell < res)).all(-1)
            dep = (alive & in_bounds).nonzero().squeeze(1)
            if dep.numel():
                h = _hash_cell(cell[dep], hash_size)
                _deposit(scene, static, state, frame, sorted_vp, acc,
                         hit.pos[dep], rd[dep], beta[dep], bucket_start[h],
                         bucket_start[h + 1], u_off[dep])

        # scatter onward, importance transport (pathtracer.cu:2264-2279)
        mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
        u1, u2, u3 = rng.uniform3()
        wo, fr, pdf = bsdf_mod.sample_bsdf(
            mat, -rd, hit.nor, hit.dpdu, u1, u2, u3, types,
            bsdf_mod.IMPORTANCE)
        alive = alive & (pdf != 0.0)
        beta = torch.where(alive[:, None],
                           beta * fr * torch.abs(dot(hit.nor, wo))[:, None]
                           / torch.clamp_min(pdf, 1e-30)[:, None], beta)
        ro = torch.where(alive[:, None], hit.pos, ro)
        rd = torch.where(alive[:, None], wo, rd)

        u_rr = rng.uniform()
        if b > 3:
            illumate = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
            alive = alive & ~(u_rr < illumate)
            scale = 1.0 / torch.clamp_min(1.0 - illumate, 1e-30)
            beta = torch.where(alive[:, None], beta * scale[:, None], beta)
    return acc[:, 0:3], acc[:, 3], rays


def density_pass(state: SppmState, phi, m, iteration: int, n_photons: int):
    """The batched progressive update and density estimate (TP kernel,
    pathtracer.cu:2330-2348). Returns (state, L [N, 3])."""
    has = m > 0.0
    n_new = state.n + SPPM_ALPHA * m
    g = torch.where(has, n_new / torch.clamp_min(state.n + m, 1e-30), 1.0)
    radius = state.radius * torch.sqrt(g)
    tau = torch.where(has[:, None], (state.tau + state.beta * phi)
                      * g[:, None], state.tau)
    denom = torch.pi * radius * radius * n_photons * iteration
    indirect = tau / torch.clamp_min(denom, 1e-30)[:, None]
    fin = torch.isfinite(indirect).all(-1)
    indirect = torch.where(fin[:, None], indirect, state.ind)
    it = float(max(iteration, 1))
    L = torch.where(state.valid[:, None], state.ld / it + indirect, 0.0)
    return dataclasses.replace(state, radius=radius, tau=tau, n=n_new,
                               ind=indirect), L


def render_iteration(scene, static, seed: int, iteration: int,
                     state: SppmState, pixel_x, pixel_y,
                     with_stats: bool = False, plain: bool = False,
                     shard=None):
    """One SPPM iteration over every pixel: eye pass -> grid -> photon
    pass -> density. Returns (state, absolute film [N, 3]) and, with
    with_stats, the rays traced (eye closest hits, NEE shadow rays,
    BSDF-sample closest hits, photon closest hits).

    With `shard` (parallel/dist.py's Shard of a sharded render), the
    state and film are whole on every rank: the rank runs the eye pass
    on its pixels, the visible points are gathered bit for bit (so every
    rank builds the same grid), the rank traces its share of the photon
    ids, phi and m are summed over the ranks and the density pass runs
    whole. The rays are the rank's own."""
    n = pixel_x.shape[0]
    n_photons = static.photons_per_iteration
    if shard is None or not shard.joined:
        state, r_eye = eye_pass(scene, static, seed, iteration, pixel_x,
                                pixel_y, state, plain=plain)
        photon_ids = None
    else:
        lo, hi = shard.range(n)
        part = SppmState(**{f.name: getattr(state, f.name)[lo:hi]
                            for f in dataclasses.fields(SppmState)})
        part, r_eye = eye_pass(scene, static, seed, iteration,
                               pixel_x[lo:hi], pixel_y[lo:hi], part,
                               plain=plain)
        state = SppmState(**{f.name: shard.gather(getattr(part, f.name), n)
                             for f in dataclasses.fields(SppmState)})
        photon_ids = shard.ids(n_photons, pixel_x.device)
    grid = build_grid(state, n)
    phi, m, r_ph = photon_pass(scene, static, seed, iteration, state, grid,
                               n_photons, n, plain=plain,
                               photon_ids=photon_ids)
    if photon_ids is not None:
        pm = shard.reduce(torch.cat([phi, m[:, None]], 1))
        phi, m = pm[:, 0:3], pm[:, 3]
    state, film = density_pass(state, phi, m, iteration, n_photons)
    if with_stats:
        return state, film, r_eye + r_ph
    return state, film
