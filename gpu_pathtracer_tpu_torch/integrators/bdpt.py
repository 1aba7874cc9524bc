"""Bidirectional path tracing.

The port of gpu_pathtracer_tpu/integrators/bdpt.py (the reference BDPT,
pathtracer.cu:1393-1970). Each lane traces one camera subpath and one
light subpath into vertex tables [N, K] (`Vertices`, K = max_depth + 1
vertices), then connects them strategy by strategy. A connection round
covers one case over a dense [N, G] grid of (lane, strategy) items,
G = K - 1, the strategy's free index being the grid column:

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
into a [W*H, 3] film with an accumulating `index_put_` (the reference's
atomicAdd): the "hybrid" kind of run/renderer.py.

Semantics kept from the JAX package: ConvertPdf's area pdfs; the four
Connect cases with their temporary pdf overrides; no depth of field
(pathtracer.cu:1420-1422); medium vertices scatter by the phase
function and interface crossings (matIdx == -1) consume no bounce, with
INTERFACE_BUDGET extra steps; infinite lights are not connected; the
path capacity is max_depth (the reference walks to 65 vertices).

Shadow connections (t1, s1, general) are thinned by an unbiased Russian
roulette (CONNECT_RR, bdpt.py:66-75): a connection whose unoccluded
luminance is below CONNECT_RR x the mean of the valid connections is
traced with probability q = luminance / (CONNECT_RR x mean) and weighted
1 / q. Deviation: the mean is the lane's own (over the lane's valid
items of the round), not the round's over all lanes, so a lane's
radiance does not depend on the other lanes of its tile. The surviving
connections are compacted (`nonzero`) before their shadow rays run; in
a scene without media the shadow ray is an any-hit query (the JAX
package walks interfaces there too, which only differs where a
material-less prim would be crossed), with media the interface-walking
transmittance of shade/media.py (csrc/track.cu on the card).

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
  4 p + k, k = 0-2 the t1 light sample (pick, u, v), 3 the connection's
  roulette.
- Tracking walks: track_tag(s + 1, TRACK_SAMPLE) on the camera subpath
  and track_tag(s + 1, TRACK_LIGHT_PATH) on the light subpath, keyed by
  the lane; connection round p's transmittance at track_tag(p,
  TRACK_CAMERA) (s1) or track_tag(p, TRACK_CONNECT), keyed by the item.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gpu_pathtracer_tpu_torch.core.rng import (
    BDPT_CONNECT_TAG, BDPT_LIGHT_TAG, TRACK_CAMERA, TRACK_CONNECT,
    TRACK_LIGHT_PATH, TRACK_SAMPLE, PhiloxStream, track_tag,
)
from gpu_pathtracer_tpu_torch.core.vecmath import (
    dot, is_black, luminance, normalize,
)
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators.common import shadow_transmittance
from gpu_pathtracer_tpu_torch.integrators.pt import lane_ids_of
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import camera as camera_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod
from gpu_pathtracer_tpu_torch.shade import media as media_mod
from gpu_pathtracer_tpu_torch.shade.media import TrackKey

INTERFACE_BUDGET = 8
CONNECT_RR = 1.0    # shadow-connection roulette threshold (0 disables)
EMIT_DIMS = 8       # sites before a subpath's first step
STEP_DIMS = 8       # sites per subpath step (7 read)
ITEM_LANES = 32     # item id = 32 lane + column: columns < 32
CONNECT_DIMS = 4    # sites per item per connection round


@dataclass
class Vertices:
    """SoA subpath vertex storage (BdptVertex, pathtracer.cu:1395-1402)."""
    pos: torch.Tensor        # [N, K, 3]
    nor: torch.Tensor        # [N, K, 3] zero for medium vertices
    uv: torch.Tensor         # [N, K, 2]
    dpdu: torch.Tensor       # [N, K, 3]
    beta: torch.Tensor       # [N, K, 3]
    fwd: torch.Tensor        # [N, K] forward area pdf
    rev: torch.Tensor        # [N, K] reverse area pdf
    delta: torch.Tensor      # [N, K] bool
    mat_idx: torch.Tensor    # [N, K] i32 (-1: medium vertex)
    light_idx: torch.Tensor  # [N, K] i32
    medium: torch.Tensor     # [N, K] i32 the medium the vertex sits in
    count: torch.Tensor      # [N] i32 valid vertices


def empty_vertices(n: int, k: int, device) -> Vertices:
    def z(*shape):
        return torch.zeros((n, k) + shape, device=device)

    def neg():
        return torch.full((n, k), -1, dtype=torch.int32, device=device)
    return Vertices(
        pos=z(3), nor=z(3), uv=z(2), dpdu=z(3), beta=z(3), fwd=z(), rev=z(),
        delta=torch.zeros((n, k), dtype=torch.bool, device=device),
        mat_idx=neg(), light_idx=neg(), medium=neg(),
        count=torch.zeros(n, dtype=torch.int32, device=device))


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
    """Write the fields `vals` of vertex v.count on the lanes of mask."""
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


def _generate_subpath(scene, static, stream, walk_key, n_verts, ro, rd, beta,
                      forward, med, verts: Vertices, mode, plain):
    """The random walk shared by the camera and light subpaths
    (GenerateCameraPath / GenerateLightPath, pathtracer.cu:1415-1690).
    `verts` holds vertex 0 (count 1); the walk appends up to n_verts - 1
    more. `forward` is the solid-angle pdf of the first ray;
    stream(step) / walk_key(step) give the step's draws. Returns the
    rays traced (closest hits and Tr segments)."""
    n = ro.shape[0]
    dev = ro.device
    eps = scene.epsilon
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    bounce_ct = torch.zeros(n, dtype=torch.int32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    zeros3 = torch.zeros((n, 3), device=dev)
    neg1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    gate = plain or dev.type != "cuda"
    n_steps = (n_verts - 1) + (INTERFACE_BUDGET if static.has_media else 0)
    for step in range(n_steps):
        alive = alive & (verts.count < n_verts)
        if gate and not bool(alive.any()):
            break
        rng = stream(step)
        u_bsdf = rng.uniform3()
        u_rr = rng.uniform()
        rays = rays + alive.sum()
        hit = traverse.intersect_closest(
            scene, static, ro, rd, eps, torch.where(alive, torch.inf, 0.0),
            plain)
        alive = alive & hit.valid

        prev_idx = verts.count - 1
        prev_pos = _lane_get(verts.pos, prev_idx)
        prev_nor = _lane_get(verts.nor, prev_idx)

        # ---- medium scattering vertex (pathtracer.cu:1603-1630) --------
        if static.has_media:
            pu1, pu2 = rng.uniform2()
            u0 = rng.uniform()
            weight, t_med, sampled = media_mod.medium_sample(
                scene, static, med, ro, rd, hit.t, u0, walk_key(step), alive,
                plain)
            beta = torch.where(alive[:, None], beta * weight, beta)
            alive = alive & ~is_black(beta)
            in_scatter = alive & sampled
            sample_pos = ro + rd * t_med[:, None]
            new_dir, ph = media_mod.sample_phase(scene, med, -rd, pu1, pu2)
            fwd_m = _convert_pdf(forward, prev_pos, sample_pos, zeros3)
            _set_vertex(verts, in_scatter, pos=sample_pos, nor=zeros3,
                        beta=beta, fwd=fwd_m,
                        delta=torch.zeros_like(in_scatter), mat_idx=neg1,
                        light_idx=neg1, medium=med)
            rev_m = _convert_pdf(ph, sample_pos, prev_pos, prev_nor)
            _lane_set(verts.rev, in_scatter, prev_idx, rev_m)
            forward = torch.where(in_scatter, ph, forward)
            ro = torch.where(in_scatter[:, None], sample_pos, ro)
            rd = torch.where(in_scatter[:, None], new_dir, rd)
        else:
            in_scatter = torch.zeros_like(alive)

        # ---- interface crossing: no bounce (pathtracer.cu:1632-1639) ---
        on_surface = alive & ~in_scatter
        interface = on_surface & (hit.mat_idx == -1)
        going_out = dot(rd, hit.nor) > 0.0
        med = torch.where(interface, torch.where(
            going_out, hit.medium_outside, hit.medium_inside), med)
        ro = torch.where(interface[:, None], hit.pos, ro)
        surf = on_surface & ~interface

        # ---- surface vertex (pathtracer.cu:1641-1676) ------------------
        mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
        delta = bsdf_mod.is_delta(mat.type)
        fwd_s = _convert_pdf(forward, prev_pos, hit.pos, hit.nor)
        _set_vertex(verts, surf, pos=hit.pos, nor=hit.nor, uv=hit.uv,
                    dpdu=hit.dpdu, beta=beta, fwd=fwd_s, delta=delta,
                    mat_idx=hit.mat_idx, light_idx=hit.light_idx, medium=med)

        wo, fr, pdf = bsdf_mod.sample_bsdf(
            mat, -rd, hit.nor, hit.dpdu, *u_bsdf, static.material_types, mode)
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
        _lane_set(verts.rev, surf_go, prev_idx, rev_s)

        out_side = torch.where(dot(wo, hit.nor) > 0.0, hit.medium_outside,
                               hit.medium_inside)
        same_side = dot(-rd, hit.nor) * dot(wo, hit.nor) > 0.0
        med = torch.where(surf_go, torch.where(same_side, med, out_side), med)
        ro = torch.where(surf_go[:, None], hit.pos, ro)
        rd = torch.where(surf_go[:, None], wo, rd)

        consumed = in_scatter | surf
        verts.count = torch.where(consumed, verts.count + 1, verts.count)
        bounce_ct = torch.where(consumed, bounce_ct + 1, bounce_ct)

        # Russian roulette (pathtracer.cu:1679-1686)
        rr_pdf = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
        do_rr = alive & (in_scatter | surf_go) & (bounce_ct > 4)
        alive = alive & ~(do_rr & (u_rr < rr_pdf))
        scale = 1.0 / torch.clamp_min(1.0 - rr_pdf, 1e-30)
        beta = torch.where((do_rr & alive)[:, None], beta * scale[:, None],
                           beta)
    return rays


def camera_subpath(scene, static, seed, iteration, lanes, pixel_x, pixel_y,
                   n_verts, plain=False):
    """GenerateCameraPath (pathtracer.cu:1415-1553), no depth of field.
    Returns (Vertices, rays traced)."""
    n = pixel_x.shape[0]
    dev = pixel_x.device
    rng = PhiloxStream(seed, iteration, lanes, 0, EMIT_DIMS, plain=plain)
    ox = rng.uniform() - 0.5
    oy = rng.uniform() - 0.5
    cam = scene.camera
    ro, rd = camera_mod.generate_primary_ray(
        cam, pixel_x.float() + ox, pixel_y.float() + oy,
        torch.zeros((n, 2), device=dev), static.environment_camera)

    verts = empty_vertices(n, n_verts, dev)
    med0 = torch.full((n,), static.camera_medium, dtype=torch.int32,
                      device=dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    _set_vertex(verts, every, pos=cam.position.expand(n, 3),
                nor=(-cam.w).expand(n, 3), beta=torch.ones((n, 3), device=dev),
                fwd=torch.ones(n, device=dev), medium=med0)
    verts.count = verts.count + 1
    _, forward = camera_mod.pdf_camera(cam, rd)
    rays = _generate_subpath(
        scene, static,
        lambda s: PhiloxStream(seed, iteration, lanes,
                               EMIT_DIMS + s * STEP_DIMS, STEP_DIMS,
                               plain=plain),
        lambda s: TrackKey(seed, iteration, lanes,
                           track_tag(s + 1, TRACK_SAMPLE)),
        n_verts, ro, rd, torch.ones((n, 3), device=dev), forward, med0, verts,
        bsdf_mod.RADIANCE, plain)
    return verts, rays


def light_subpath(scene, static, seed, iteration, lanes, n_verts,
                  plain=False):
    """GenerateLightPath (pathtracer.cu:1553-1690). Returns (Vertices,
    rays traced)."""
    n = lanes.shape[0]
    dev = lanes.device
    eps = scene.epsilon
    rng = PhiloxStream(seed, iteration, lanes, 0, EMIT_DIMS, BDPT_LIGHT_TAG,
                       plain)
    light_idx, choice_pdf = lights_mod.pick_light(scene, rng.uniform())
    light_idx = torch.clamp_max(light_idx, max(static.n_lights - 1, 0))
    u1, u2, u3 = rng.uniform3()
    u4 = rng.uniform()
    ro, rd, l_nor, radiance, pdf_a, pdf_w = \
        lights_mod.sample_area_light_emission(scene, light_idx, u1, u2, u3,
                                              u4, eps)
    med0 = scene.l_medium[light_idx.long()] if static.has_media else \
        torch.full((n,), -1, dtype=torch.int32, device=dev)

    verts = empty_vertices(n, n_verts, dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    _set_vertex(verts, every, pos=ro, nor=l_nor, beta=radiance,
                fwd=pdf_a * choice_pdf, light_idx=light_idx, medium=med0)
    verts.count = verts.count + 1
    denom = torch.clamp_min(pdf_a * pdf_w * choice_pdf, 1e-30)
    beta = radiance * (torch.abs(dot(rd, l_nor)) / denom)[:, None]
    rays = _generate_subpath(
        scene, static,
        lambda s: PhiloxStream(seed, iteration, lanes,
                               EMIT_DIMS + s * STEP_DIMS, STEP_DIMS,
                               BDPT_LIGHT_TAG, plain),
        lambda s: TrackKey(seed, iteration, lanes,
                           track_tag(s + 1, TRACK_LIGHT_PATH)),
        n_verts, ro, rd, beta, pdf_w, med0, verts, bsdf_mod.IMPORTANCE, plain)
    if static.n_lights == 0:
        verts.count = torch.zeros_like(verts.count)
    return verts, rays


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


class _Round:
    """The state shared by an iteration's connection rounds."""

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
        self.li = torch.zeros((self.n, 3), device=self.dev)
        self.film = torch.zeros((static.width * static.height, 3),
                                device=self.dev)
        self.rays = torch.zeros((), dtype=torch.int64, device=self.dev)

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
        l1 / l2 (light vertices t - 1 / t - 2) are flat record dicts."""
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
            self.li += L.reshape(n, G, 3).sum(1)
            return

        if CONNECT_RR > 0.0:
            # the shadow-connection roulette, against the lane's mean
            lum = luminance(L)
            okf = ok.reshape(n, G)
            mean = torch.where(okf, lum.reshape(n, G), 0.0).sum(1) \
                / torch.clamp_min(okf.sum(1), 1).float()
            q = torch.clamp(lum / torch.clamp_min(
                CONNECT_RR * mean.repeat_interleave(G), 1e-30), 0.0, 1.0)
            ok = ok & (rng.uniform() < q)
            L = torch.where(ok[:, None], L / torch.clamp_min(q, 1e-30)[:, None],
                            0.0)

        # the surviving connections' shadow rays, compacted
        sel = ok.nonzero().squeeze(1)
        o, d, tmax, med = (x[sel] for x in sh)
        site = TRACK_CAMERA if case == "s1" else TRACK_CONNECT
        tr, r = shadow_transmittance(
            scene, static, med, o, d, tmax,
            TrackKey(self.seed, self.iteration, self.items[sel],
                     track_tag(p, site)),
            torch.ones(sel.shape[0], dtype=torch.bool, device=self.dev),
            self.plain)
        self.rays += r
        Lc = L[sel] * tr
        if case == "s1":
            idx = (rx2.long() + ry2.long() * static.width)[sel]
            self.film.index_put_((idx,), Lc, accumulate=True)
        else:
            full = torch.zeros_like(L)
            full[sel] = Lc
            self.li += full.reshape(n, G, 3).sum(1)


def render_lanes(scene, static, seed: int, iteration: int, pixel_x, pixel_y,
                 with_stats: bool = False, plain: bool = False):
    """One BDPT sample per lane. Returns (li [N, 3], film [W*H, 3]): li
    holds the s >= 2 strategies for the lane's own pixel, the film the
    s == 1 splats (the Bdpt kernel, pathtracer.cu:1933-1970); with_stats
    also the rays traced (the subpaths' closest hits and Tr segments and
    the connections' shadow rays), 0-d int64. `plain` runs the plain
    intersection and tracking on any device."""
    n_verts = static.max_depth + 1
    G = n_verts - 1
    if G >= ITEM_LANES:
        raise ValueError(f"BDPT takes max_depth < {ITEM_LANES}")
    lanes = lane_ids_of(static, pixel_x, pixel_y)
    cam_v, r_cam = camera_subpath(scene, static, seed, iteration, lanes,
                                  pixel_x, pixel_y, n_verts, plain)
    light_v, r_light = light_subpath(scene, static, seed, iteration, lanes,
                                     n_verts, plain)
    rd = _Round(scene, static, seed, iteration, lanes, cam_v, light_v, plain)
    rd.rays += r_cam + r_light
    cc, lc = cam_v.count, light_v.count
    cols = torch.arange(2, G + 2, device=lanes.device)[None, :]   # [1, G]
    gate = plain or not lanes.is_cuda

    def live(valid2):
        return not gate or bool(valid2.any())

    # s == 1: light vertex t - 1 to the camera, t = column + 2
    valid2 = cols <= lc[:, None]
    if live(valid2):
        rd.run("s1", 1, 1, cols, None, None, _vslice(light_v, 1, G),
               _vslice(light_v, 0, G), valid2)
    # t == 0 and t == 1: camera vertex s - 1, s = column + 2
    valid2 = cols <= cc[:, None]
    if live(valid2):
        rd.run("t0", 2, cols, 0, _vslice(cam_v, 1, G), _vslice(cam_v, 0, G),
               None, None, valid2)
    valid2 = valid2 & (lc >= 1)[:, None]
    if live(valid2):
        rd.run("t1", 3, cols, 1, _vslice(cam_v, 1, G), _vslice(cam_v, 0, G),
               None, None, valid2)
    # the general case: s = 2 .. n_verts, t = column + 2
    for s in range(2, n_verts + 1):
        valid2 = (s <= cc)[:, None] & (cols <= lc[:, None])
        if live(valid2):
            rd.run("gen", 4 + s - 2, s, cols, _vat(cam_v, s - 1, G),
                   _vat(cam_v, s - 2, G), _vslice(light_v, 1, G),
                   _vslice(light_v, 0, G), valid2)

    li = torch.where(torch.isfinite(rd.li).all(-1)[:, None], rd.li, 0.0)
    if with_stats:
        return li, rd.film, rd.rays
    return li, rd.film
