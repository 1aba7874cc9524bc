"""BDPT's per-lane work (integrators/bdpt_shade.py) on the CPU.

`start_torch`, `step_torch`, `connect_torch` and `finish_torch`, the
plain versions of csrc/bdpt.cu, are bdpt.py's subpath walk and connection
rounds regrouped:
both subpaths walk as the 2N rows of one walk, and the connections that
need a shadow ray wait in a queue of fixed slots a lane until one any-hit
call (or, with media, one transmittance walk) has run. These tests hold
`bdpt.render_lanes` over them to the loop before the regrouping
(`_reference_*`: the camera and light subpaths walked apart, each round
tracing its compacted shadow rays and crediting at once), on cornell_port,
smoke_port (heterogeneous smoke, fog, interfaces, sample walks and Tr
walks), materials.json (six BSDFs, lines, spheres) and textured.json at
16^2:

- the vertex tables and the rows' state after every step, bit for bit;
- each round's queued connections (which survive the roulette, their
  shadow rays bit for bit, their credit), its radiance and the rays it
  traces; the sample's per-lane radiance, film and rays. The credits, the
  radiance and the film agree within 1e-6 abs + 1e-5 rel, not bit for
  bit: the plain versions add a round's columns and the values of the
  roulette's lane mean in column order (as the kernel does), where the
  loop before summed with torch's `.sum(1)` (measured: at most 6e-8);
  the rays are equal.

Beside them: that no step or connection reads a slot at or above a
row's count (the kernels leave those unwritten); that lanes run in
chunks of QUEUE_SLOTS give each lane the result of one call; the
connection roulette's random sites; the Tr walk of all rounds at once against a walk per round;
the wrappers' refusal of CPU tensors; the route of `render_lanes`
through the kernel wrappers; and chip_smoke.py's recounted bound of
bdpt_step, which charges a row beyond its flag only where it steps and
a word only where its value changes. `start_torch`, the plain version of the
start kernel, is the vertex 0 and first ray of both subpaths before the
regrouping (the steps' tables are held from it on). The kernels
themselves run only on the card (chip_smoke.py phase T holds them to
these plain versions).
"""

import dataclasses

import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu_torch.core.rng import (
    BDPT_CONNECT_TAG, BDPT_LIGHT_TAG, TRACK_CAMERA, TRACK_CONNECT,
    TRACK_LIGHT_PATH, TRACK_SAMPLE, PhiloxStream, track_tag,
)
from gpu_pathtracer_tpu_torch.core.vecmath import (
    dot, is_black, luminance, normalize,
)
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators import bdpt, bdpt_shade as bs
from gpu_pathtracer_tpu_torch.integrators.bdpt_shade import (
    CONNECT_DIMS, CONNECT_RR, EMIT_DIMS, ITEM_LANES, STEP_DIMS, _convert_pdf,
    _lane_get, _lane_set, _mis_tables, _mis_weight, _set_vertex, _vat,
    _vslice, empty_vertices,
)
from gpu_pathtracer_tpu_torch.integrators.common import shadow_transmittance
from gpu_pathtracer_tpu_torch.integrators.pt import lane_ids_of
from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
from gpu_pathtracer_tpu_torch.scene.parse import load_scene
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import camera as camera_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod
from gpu_pathtracer_tpu_torch.shade import media as media_mod
from gpu_pathtracer_tpu_torch.shade.media import TrackKey

SCENES = {
    "cornell": tp.PORT_SCENES["cornell"],
    "smoke": tp.SMOKE_SCENE,
    "materials": tp.PORT_SCENES["materials"],
    "textured": tp.REPO / "scenes" / "cornell_port" / "textured.json",
}
SIZE, DEPTH, SEED = 16, 5, 5
ATOL, RTOL = 1e-6, 1e-5   # the fixed summation order (module docstring)


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    """(DeviceScene, StaticConfig) on the CPU at 16^2, BDPT at depth 5,
    and its name."""
    host = load_scene(str(SCENES[request.param]))
    host.width = host.height = SIZE
    sc, st = flatten_scene(host, torch.device("cpu"), cache=False)
    st = dataclasses.replace(st, integrator=IntegratorType.BDPT,
                             max_depth=DEPTH)
    return sc, st, request.param


def _pixels(st):
    ids = torch.arange(st.width * st.height)
    return ids % st.width, ids // st.width


# ---------------------------------------------------------------------------
# the loop before the regrouping
# ---------------------------------------------------------------------------
def _reference_generate_subpath(scene, static, stream, walk_key, n_verts, ro,
                                rd, beta, forward, med, verts, mode):
    """bdpt.py's _generate_subpath, all-plain, yielding the tables (a
    copy), the rays so far and the walk's state after every step (every
    step runs: the loop no longer stops once no lane is alive, which
    changes no result)."""
    n = ro.shape[0]
    eps = scene.epsilon
    alive = torch.ones(n, dtype=torch.bool)
    bounce_ct = torch.zeros(n, dtype=torch.int32)
    rays = torch.zeros((), dtype=torch.int64)
    zeros3 = torch.zeros((n, 3))
    neg1 = torch.full((n,), -1, dtype=torch.int32)
    n_steps = (n_verts - 1) + (bdpt.INTERFACE_BUDGET if static.has_media
                               else 0)
    for step in range(n_steps):
        alive = alive & (verts.count < n_verts)
        rng = stream(step)
        u_bsdf = rng.uniform3()
        u_rr = rng.uniform()
        rays = rays + alive.sum()
        hit = traverse.intersect_closest(
            scene, static, ro, rd, eps, torch.where(alive, torch.inf, 0.0),
            True)
        alive = alive & hit.valid
        prev_idx = verts.count - 1
        prev_pos = _lane_get(verts.pos, prev_idx)
        prev_nor = _lane_get(verts.nor, prev_idx)
        if static.has_media:
            pu1, pu2 = rng.uniform2()
            u0 = rng.uniform()
            weight, t_med, sampled = media_mod.medium_sample(
                scene, static, med, ro, rd, hit.t, u0, walk_key(step), alive,
                True)
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
        on_surface = alive & ~in_scatter
        interface = on_surface & (hit.mat_idx == -1)
        going_out = dot(rd, hit.nor) > 0.0
        med = torch.where(interface, torch.where(
            going_out, hit.medium_outside, hit.medium_inside), med)
        ro = torch.where(interface[:, None], hit.pos, ro)
        surf = on_surface & ~interface
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
        rr_pdf = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
        do_rr = alive & (in_scatter | surf_go) & (bounce_ct > 4)
        alive = alive & ~(do_rr & (u_rr < rr_pdf))
        scale = 1.0 / torch.clamp_min(1.0 - rr_pdf, 1e-30)
        beta = torch.where((do_rr & alive)[:, None], beta * scale[:, None],
                           beta)
        tables = {f: getattr(verts, f).clone()
                  for f in bs.Vertices.__annotations__}
        yield dict(verts=dataclasses.replace(verts, **tables),
                   rays=rays, ro=ro, rd=rd, beta=beta,
                   forward=forward, med=med,
                   alive=alive & (verts.count < n_verts))


def _reference_camera_subpath(scene, static, seed, iteration, lanes, px, py,
                              n_verts):
    n = px.shape[0]
    rng = PhiloxStream(seed, iteration, lanes, 0, EMIT_DIMS, plain=True)
    ox = rng.uniform() - 0.5
    oy = rng.uniform() - 0.5
    cam = scene.camera
    ro, rd = camera_mod.generate_primary_ray(
        cam, px.float() + ox, py.float() + oy, torch.zeros((n, 2)),
        static.environment_camera)
    verts = empty_vertices(n, n_verts, "cpu")
    med0 = torch.full((n,), static.camera_medium, dtype=torch.int32)
    _set_vertex(verts, torch.ones(n, dtype=torch.bool),
                pos=cam.position.expand(n, 3), nor=(-cam.w).expand(n, 3),
                beta=torch.ones((n, 3)), fwd=torch.ones(n), medium=med0)
    verts.count = verts.count + 1
    _, forward = camera_mod.pdf_camera(cam, rd)
    return _reference_generate_subpath(
        scene, static,
        lambda s: PhiloxStream(seed, iteration, lanes,
                               EMIT_DIMS + s * STEP_DIMS, STEP_DIMS,
                               plain=True),
        lambda s: TrackKey(seed, iteration, lanes,
                           track_tag(s + 1, TRACK_SAMPLE)),
        n_verts, ro, rd, torch.ones((n, 3)), forward, med0, verts,
        bsdf_mod.RADIANCE)


def _reference_light_subpath(scene, static, seed, iteration, lanes, n_verts):
    n = lanes.shape[0]
    rng = PhiloxStream(seed, iteration, lanes, 0, EMIT_DIMS, BDPT_LIGHT_TAG,
                       True)
    light_idx, choice_pdf = lights_mod.pick_light(scene, rng.uniform())
    light_idx = torch.clamp_max(light_idx, max(static.n_lights - 1, 0))
    u1, u2, u3 = rng.uniform3()
    u4 = rng.uniform()
    ro, rd, l_nor, radiance, pdf_a, pdf_w = \
        lights_mod.sample_area_light_emission(scene, light_idx, u1, u2, u3,
                                              u4, scene.epsilon)
    med0 = scene.l_medium[light_idx.long()] if static.has_media else \
        torch.full((n,), -1, dtype=torch.int32)
    verts = empty_vertices(n, n_verts, "cpu")
    _set_vertex(verts, torch.ones(n, dtype=torch.bool), pos=ro, nor=l_nor,
                beta=radiance, fwd=pdf_a * choice_pdf, light_idx=light_idx,
                medium=med0)
    verts.count = verts.count + 1
    denom = torch.clamp_min(pdf_a * pdf_w * choice_pdf, 1e-30)
    beta = radiance * (torch.abs(dot(rd, l_nor)) / denom)[:, None]
    return _reference_generate_subpath(
        scene, static,
        lambda s: PhiloxStream(seed, iteration, lanes,
                               EMIT_DIMS + s * STEP_DIMS, STEP_DIMS,
                               BDPT_LIGHT_TAG, True),
        lambda s: TrackKey(seed, iteration, lanes,
                           track_tag(s + 1, TRACK_LIGHT_PATH)),
        n_verts, ro, rd, beta, pdf_w, med0, verts, bsdf_mod.IMPORTANCE)


def _reference_steps(scene, static, seed, iteration, px, py):
    """Both subpaths' walks in step, [(camera state, light state)]."""
    lanes = lane_ids_of(static, px, py)
    k = static.max_depth + 1
    return list(zip(
        _reference_camera_subpath(scene, static, seed, iteration, lanes, px,
                                  py, k),
        _reference_light_subpath(scene, static, seed, iteration, lanes, k)))


class _ReferenceRound:
    """bdpt.py's connection rounds before the regrouping, recording each
    round's credits, valid items, shadow rays, radiance and rays in
    `rounds`."""

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
        self.rounds = {}

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
        name = case if case != "gen" else f"gen{s}"
        if case == "t0":   # along an existing segment: no shadow ray
            self.li += L.reshape(n, G, 3).sum(1)
            self.rounds[name] = dict(li=L.reshape(n, G, 3).sum(1))
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
        rec = dict(L=L, ok=ok, o=o, d=d, tmax=tmax, rays=int(r))
        if case == "s1":
            idx = (rx2.long() + ry2.long() * static.width)[sel]
            self.film.index_put_((idx,), Lc, accumulate=True)
        else:
            full = torch.zeros_like(L)
            full[sel] = Lc
            rec["li"] = full.reshape(n, G, 3).sum(1)
            self.li += rec["li"]
        self.rounds[name] = rec


def _reference_render(scene, static, seed, iteration, px, py):
    """bdpt.py's render_lanes before the regrouping, all-plain: (li, film,
    rays, {round: its record})."""
    steps = _reference_steps(scene, static, seed, iteration, px, py)
    cam_v, light_v = steps[-1][0]["verts"], steps[-1][1]["verts"]
    if static.n_lights == 0:
        light_v.count = torch.zeros_like(light_v.count)
    lanes = lane_ids_of(static, px, py)
    G = static.max_depth
    rd = _ReferenceRound(scene, static, seed, iteration, lanes, cam_v,
                         light_v, True)
    rd.rays += steps[-1][0]["rays"] + steps[-1][1]["rays"]
    cc, lc = cam_v.count, light_v.count
    cols = torch.arange(2, G + 2)[None, :]
    valid2 = cols <= lc[:, None]
    if bool(valid2.any()):
        rd.run("s1", 1, 1, cols, None, None, _vslice(light_v, 1, G),
               _vslice(light_v, 0, G), valid2)
    valid2 = cols <= cc[:, None]
    if bool(valid2.any()):
        rd.run("t0", 2, cols, 0, _vslice(cam_v, 1, G), _vslice(cam_v, 0, G),
               None, None, valid2)
    valid2 = valid2 & (lc >= 1)[:, None]
    if bool(valid2.any()):
        rd.run("t1", 3, cols, 1, _vslice(cam_v, 1, G), _vslice(cam_v, 0, G),
               None, None, valid2)
    for s in range(2, G + 2):
        valid2 = (s <= cc)[:, None] & (cols <= lc[:, None])
        if bool(valid2.any()):
            rd.run("gen", 4 + s - 2, s, cols, _vat(cam_v, s - 1, G),
                   _vat(cam_v, s - 2, G), _vslice(light_v, 1, G),
                   _vslice(light_v, 0, G), valid2)
    li = torch.where(torch.isfinite(rd.li).all(-1)[:, None], rd.li, 0.0)
    return li, rd.film, rd.rays, rd.rounds


# ---------------------------------------------------------------------------
# the regrouped path against it
# ---------------------------------------------------------------------------
def _bitwise(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32) if a.dtype == torch.float32 else a,
        b.contiguous().view(torch.int32) if b.dtype == torch.float32 else b)


def _close(a, b):
    torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


def test_steps_are_the_reference_steps(scene, monkeypatch):
    """After every step, the tables and the rows' state of the camera
    rows equal the camera subpath's, those of the light rows the light
    subpath's, bit for bit; the rays so far are equal."""
    sc, st, name = scene
    px, py = _pixels(st)
    ref = _reference_steps(sc, st, SEED, 1, px, py)
    seen = []
    step = bs.step

    def spy(*args, **kw):
        step(*args, **kw)
        v, w, rays = args[9], args[10], args[11]
        seen.append(({f: getattr(v, f).clone() for f in bs.Vertices.
                      __annotations__},
                     {f: getattr(w, f).clone() for f in (
                         "ro", "rd", "beta", "forward", "med", "alive")},
                     int(rays)))

    monkeypatch.setattr(bs, "step", spy)
    bdpt.render_lanes(sc, st, SEED, 1, px, py, True)
    n = px.shape[0]
    assert 0 < len(seen) <= len(ref)
    for s, (v, w, rays) in enumerate(seen):
        cam, lit = ref[s]
        for half, r in ((slice(0, n), cam), (slice(n, 2 * n), lit)):
            for f in bs.Vertices.__annotations__:
                assert _bitwise(v[f][half], getattr(r["verts"], f)), \
                    (name, s, f)
            for f in ("ro", "rd", "beta", "forward", "med", "alive"):
                assert _bitwise(w[f][half], r[f]), (name, s, f)
        assert rays == int(cam["rays"] + lit["rays"]), (name, s)
    # the steps the regrouped loop left out leave every row as it was
    for cam, lit in ref[len(seen):]:
        assert not bool(cam["alive"].any() or lit["alive"].any())


def test_rounds_are_the_reference_rounds(scene, monkeypatch):
    """Each round's queue slots: live where the loop before traced a
    shadow ray, those rays bit for bit, their credits and the round's
    radiance within the summation order's bound, its rays equal."""
    sc, st, name = scene
    px, py = _pixels(st)
    *_, ref = _reference_render(sc, st, SEED, 2, px, py)
    got = {}
    connect, finish = bs.connect, bs.finish

    def connect_spy(*args, **kw):
        out = connect(*args, **kw)
        got["li"], got["q"] = out
        return out

    def finish_spy(li, q, shadow, n_pix, plain=False):
        got["shadow"] = shadow
        return finish(li, q, shadow, n_pix, plain)

    monkeypatch.setattr(bs, "connect", connect_spy)
    monkeypatch.setattr(bs, "finish", finish_spy)
    bdpt.render_lanes(sc, st, SEED, 2, px, py, True)
    q, G = got["q"], st.max_depth
    n = px.shape[0]
    s_n = q.live.shape[0]
    tr = torch.where(got["shadow"][:, None], 0.0, torch.ones(s_n * n, 3)) \
        if not st.has_media else got["shadow"]
    tr = tr.reshape(s_n, n, 3)
    _close(got["li"], ref["t0"]["li"] if "t0" in ref else got["li"] * 0)
    checked = 0
    for rname, j0 in [("s1", bs.slot0("s1", G)), ("t1", bs.slot0("t1", G))] \
            + [(f"gen{s}", bs.slot0("gen", G, s)) for s in range(2, G + 2)]:
        live = q.live[j0:j0 + G].t()            # [N, G] lane-major
        if rname not in ref:
            assert not bool(live.any()), (name, rname)
            continue
        r = ref[rname]
        ok = r["ok"].reshape(n, G)
        assert torch.equal(live, ok), (name, rname)
        L = q.L[j0:j0 + G].transpose(0, 1)
        _close(torch.where(live[..., None], L, 0.0), r["L"].reshape(n, G, 3))
        sel = live.reshape(-1)
        for f, x in (("o", q.o), ("d", q.d), ("tmax", q.tmax)):
            x = x[j0:j0 + G].transpose(0, 1)
            x = x.reshape((n * G,) + x.shape[2:])[sel]
            assert _bitwise(x, r[f]), (name, rname, f)
        assert not bool((q.tmax[j0:j0 + G].t()[~live] != 0).any())
        if not st.has_media:
            assert int(live.sum()) == r["rays"], (name, rname)
        if "li" in r:
            c = torch.where(live[..., None], L * tr[j0:j0 + G].transpose(0, 1),
                            0.0)
            _close(bs._cols_sum(c), r["li"])
        checked += int(live.sum())
    assert checked > 0


def test_connect_bound_counts_the_plain_items(scene, monkeypatch):
    """chip_smoke.py's bound of bdpt_connect counts, round by round, the
    items the plain version treats as valid (their vertices exist), and
    the valid ones before the roulette hold every kept slot; its least
    time is the larger of its bytes' and its instructions' times."""
    import chip_smoke
    sc, st, name = scene
    px, py = _pixels(st)
    seen = dict.fromkeys(("s1", "t0", "t1", "gen"), 0)
    got = {}
    run, connect = bs._Round.run, bs.connect

    def run_spy(self, case, p, s, t, c1, c2, l1, l2, valid2):
        seen[case] += int(valid2.sum())
        return run(self, case, p, s, t, c1, c2, l1, l2, valid2)

    def connect_spy(scene_, static, seed, iteration, lanes, v, *args, **kw):
        li, q = connect(scene_, static, seed, iteration, lanes, v, *args,
                        **kw)
        got.update(kw=dict(scene=scene_, static=static, seed=seed,
                           iteration=iteration, lanes=lanes, v=v),
                   q=q, n=lanes.shape[0])
        return li, q

    monkeypatch.setattr(bs._Round, "run", run_spy)
    monkeypatch.setattr(bs, "connect", connect_spy)
    bdpt.render_lanes(sc, st, SEED, 1, px, py, True)
    monkeypatch.undo()
    ok = chip_smoke.connect_valid(got["kw"]).bool()
    b = chip_smoke.bdpt_connect_bound(sc, st, got["kw"]["v"], got["q"], ok,
                                      got["n"])
    assert b["items_by_round"] == seen and sum(seen.values()) > 0, name
    assert not (got["q"].live.bool() & ~ok).any(), name
    assert 0 < b["valid"] <= b["items"] - seen["t0"], name
    assert b["bound_ms"] == max(b["bytes_ms"], b["operations_ms"])


def test_render_lanes_is_the_reference(scene):
    """A whole sample: per-lane radiance and film within the summation
    order's bound of the loop before, the rays equal; on CPU tensors the
    kernels never count a launch or a plain call."""
    sc, st, name = scene
    px, py = _pixels(st)
    li_r, film_r, rays_r, _ = _reference_render(sc, st, SEED, 1, px, py)
    stats = (bs.STATS, bs.CONNECT_STATS, bs.FINISH_STATS)
    for s_ in stats:
        s_.launches = s_.plain_cuda = 0
    li, film, rays = bdpt.render_lanes(sc, st, SEED, 1, px, py, True)
    _close(li, li_r)
    _close(film, film_r)
    assert int(rays) == int(rays_r)
    assert li.mean() > 0.0 and film.sum() > 0.0
    assert bool(torch.isfinite(li).all() and torch.isfinite(film).all())
    assert all(s_.launches == s_.plain_cuda == 0 for s_ in stats)


# ---------------------------------------------------------------------------
# the slots at and above the count, and the lane chunks
# ---------------------------------------------------------------------------
def _below(v):
    """[R, K] bool: the slots below each row's count."""
    return torch.arange(v.pos.shape[1])[None, :] < v.count[:, None]


def _scribbled(v):
    """A copy of tables v whose slots at and above each row's count hold
    NaN floats, flipped flags and index 0, as the kernels' unwritten
    slots may hold anything."""
    above = ~_below(v)
    out = {"count": v.count.clone()}
    for f in bs.Vertices.__annotations__:
        x = getattr(v, f)
        if f == "count":
            continue
        junk = ~x if x.dtype == torch.bool else (
            torch.full_like(x, float("nan")) if x.is_floating_point()
            else torch.zeros_like(x))
        m = above.reshape(above.shape + (1,) * (x.dim() - 2))
        out[f] = torch.where(m, junk, x)
    return bs.Vertices(**out)


def _same_below(a, b):
    """Tables a and b bit for bit below the count (the counts equal)."""
    if not torch.equal(a.count, b.count):
        return False
    m = _below(a)
    return all(_bitwise(getattr(a, f)[m], getattr(b, f)[m])
               for f in bs.Vertices.__annotations__ if f != "count")


def test_slots_at_and_above_the_count_reach_no_result(scene, monkeypatch):
    """The kernels write vertex 0 and each step's vertex alone and leave
    the slots at and above a row's count unwritten, so no result may
    read them: each step, and the connections, on tables whose slots
    there hold NaN, flipped flags and index 0 give the same tables below
    the count, rows' state, radiance, queue and rays, bit for bit."""
    sc, st, name = scene
    px, py = _pixels(st)
    step, connect = bs.step, bs.connect
    seen = {"steps": 0}

    def step_spy(*args, **kw):
        args = list(args)
        v, w = args[9], args[10]
        v2, w2 = _scribbled(v), dataclasses.replace(w)
        rays2 = args[11].clone()
        step(*args[:9], v2, w2, rays2, *args[12:], **kw)
        step(*args, **kw)
        assert _same_below(v, v2), (name, seen["steps"])
        for f in ("ro", "rd", "beta", "forward", "med", "alive", "tmax"):
            assert _bitwise(getattr(w, f), getattr(w2, f)), (name, f)
        assert int(args[11]) == int(rays2)
        seen["steps"] += 1

    def connect_spy(*args, **kw):
        v, rays = args[5], args[6]
        rays2 = rays.clone()
        li2, q2 = connect(*args[:5], _scribbled(v), rays2, *args[7:], **kw)
        li, q = connect(*args, **kw)
        assert _bitwise(li, li2), name
        for f in ("live", "o", "d", "tmax", "L", "med", "pix"):
            a, b = getattr(q, f), getattr(q2, f)
            assert (a is None and b is None) or _bitwise(a, b), (name, f)
        assert int(rays) == int(rays2)
        seen["above"] = int((~_below(v)).sum())
        return li, q

    monkeypatch.setattr(bs, "step", step_spy)
    monkeypatch.setattr(bs, "connect", connect_spy)
    bdpt.render_lanes(sc, st, SEED, 1, px, py)
    assert seen["steps"] >= 1 and seen["above"] > 0


def test_lane_chunks_are_one_call(scene, monkeypatch):
    """Lanes whose queue passes QUEUE_SLOTS run in chunks: each lane's
    radiance and the rays are those of one call bit for bit, the film
    (the chunks' films added) within the summation order's bound."""
    sc, st, _ = scene
    px, py = _pixels(st)
    li, film, rays = bdpt.render_lanes(sc, st, SEED, 1, px, py, True)
    lanes_a_call = []
    connect = bs.connect

    def spy(*args, **kw):
        lanes_a_call.append(args[4].shape[0])
        return connect(*args, **kw)

    monkeypatch.setattr(bs, "connect", spy)
    monkeypatch.setattr(bdpt, "QUEUE_SLOTS", bs.n_slots(st.max_depth) * 100)
    li_c, film_c, rays_c = bdpt.render_lanes(sc, st, SEED, 1, px, py, True)
    assert lanes_a_call == [100, 100, SIZE * SIZE - 200]
    assert _bitwise(li_c, li)
    assert int(rays_c) == int(rays)
    _close(film_c, film)


# ---------------------------------------------------------------------------
# the random sites, the walk, the wrappers and the route
# ---------------------------------------------------------------------------
def test_connection_roulette_sites(scene, monkeypatch):
    """Round p reads sites 4 p + k of tag BDPT_CONNECT_TAG: t1 its light
    sample at k = 0-2 and its roulette at k = 3; s1 and the general
    rounds their roulette at k = 0; t0 none."""
    sc, st, _ = scene
    px, py = _pixels(st)
    read = []
    row = PhiloxStream._row

    def spy(self):
        if self._tag == BDPT_CONNECT_TAG:
            read.append(self._base + self._site)
        return row(self)

    monkeypatch.setattr(PhiloxStream, "_row", spy)
    bdpt.render_lanes(sc, st, SEED, 1, px, py)
    want = [4 * 1] + [4 * 3 + k for k in range(4)] \
        + [4 * (4 + s - 2) for s in range(2, st.max_depth + 2)]
    got = sorted(set(read))
    assert got == sorted(x for x in want if x in got), got
    assert {4, 12, 13, 14, 15, 16} <= set(got) and 8 not in got
    assert read.index(15) > read.index(14) > read.index(12)


def test_one_walk_serves_every_round(monkeypatch):
    """With media the queue's live slots of every round take one Tr walk,
    each drawing at its round's tag through TrackKey.sites; its Tr is bit
    for bit that of a walk per round (the loop before)."""
    host = load_scene(str(tp.SMOKE_SCENE))
    host.width = host.height = SIZE
    sc, st = flatten_scene(host, torch.device("cpu"), cache=False)
    st = dataclasses.replace(st, integrator=IntegratorType.BDPT,
                             max_depth=DEPTH)
    px, py = _pixels(st)
    lanes = lane_ids_of(st, px, py)
    got = {}
    connect = bs.connect

    def spy(*args, **kw):
        got["out"] = connect(*args, **kw)
        return got["out"]

    monkeypatch.setattr(bs, "connect", spy)
    bdpt.render_lanes(sc, st, SEED, 1, px, py)
    _, q = got["out"]
    rays = torch.zeros((), dtype=torch.int64)
    tr = bdpt.shadow(sc, st, SEED, 1, lanes, q, rays, True)
    n, G = lanes.shape[0], st.max_depth
    walked = 0
    for p, site, j0 in [(1, TRACK_CAMERA, 0), (3, TRACK_CONNECT, G)] + [
            (4 + s - 2, TRACK_CONNECT, bs.slot0("gen", G, s))
            for s in range(2, G + 2)]:
        live = q.live[j0:j0 + G].reshape(-1)
        sel = live.nonzero()[:, 0]
        flat = j0 * n + sel
        cols = sel // n
        items = lanes.long()[sel % n] * ITEM_LANES + cols
        tr_p, _ = shadow_transmittance(
            sc, st, q.med.reshape(-1)[flat], q.o.reshape(-1, 3)[flat],
            q.d.reshape(-1, 3)[flat], q.tmax.reshape(-1)[flat],
            TrackKey(SEED, 1, items, track_tag(p, site)),
            torch.ones(sel.shape[0], dtype=torch.bool), True)
        assert _bitwise(tr[flat], tr_p), p
        walked += sel.shape[0]
    assert walked == int(q.live.sum()) > 0
    assert bool((tr[~q.live.reshape(-1)] == 1.0).all())


def test_bdpt_kernels_refuse_cpu_tensors(scene):
    """The kernels' wrappers take CUDA tensors only: no fallback."""
    sc, st, _ = scene
    px, py = _pixels(st)
    lanes = lane_ids_of(st, px, py)
    n = lanes.shape[0]
    with pytest.raises(ValueError, match="CUDA"):
        bs.start_cuda(sc, st, 1, 1, lanes, px, py, st.max_depth + 1)
    v, w = bs.start_torch(sc, st, 1, 1, lanes, px, py, st.max_depth + 1)
    rays = torch.zeros((), dtype=torch.int64)
    t, prim = torch.zeros(2 * n), torch.full((2 * n,), -1, dtype=torch.int32)
    found = torch.zeros(2 * n) if st.has_hetero else None
    with pytest.raises(ValueError, match="CUDA"):
        bs.step_cuda(sc, st, 0, 1, 1, lanes, t, prim, found, v, w, rays)
    with pytest.raises(ValueError, match="CUDA"):
        bs.connect_cuda(sc, st, 1, 1, lanes, v, rays)
    li, q = bs.connect_torch(sc, st, 1, 1, lanes, v, rays)
    occ = torch.zeros(q.live.numel(), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        bs.finish_cuda(li, q, occ, n)


def test_render_lanes_routes_to_the_kernels(scene, monkeypatch):
    """On CUDA tensors (the route forced here, the kernels stood in for
    by their plain versions) render_lanes calls the kernel wrappers, one
    start, a step each step, one connect and one finish, and never a
    plain version itself; the result is the plain route's."""
    sc, st, _ = scene
    px, py = _pixels(st)
    calls = []

    def stand_in(name, plain_fn):
        def fn(*args, **kw):
            calls.append(name)
            return plain_fn(*args, **kw)
        return fn

    ref = bdpt.render_lanes(sc, st, SEED, 1, px, py, True)
    for name in ("start", "step", "connect", "finish"):
        monkeypatch.setattr(bs, f"{name}_cuda",
                            stand_in(name, getattr(bs, f"{name}_torch")))
        monkeypatch.setattr(bs, f"{name}_torch", stand_in(
            f"plain {name}", getattr(bs, f"{name}_torch")))
    monkeypatch.setattr(bs, "_on_card", lambda x: True)
    got = bdpt.render_lanes(sc, st, SEED, 1, px, py, True)
    assert calls.count("start") == calls.count("connect") \
        == calls.count("finish") == 1
    assert calls[0] == "start" and calls[-2:] == ["connect", "finish"]
    assert calls.count("step") == len(calls) - 3 >= 1
    assert not any(c.startswith("plain") for c in calls), calls
    assert all(_bitwise(a, b) for a, b in zip(got, ref))


def _plain_steps(sc, st, monkeypatch):
    """Every step of one sample over the plain versions: [(step, t, prim,
    counts and Walker before, counts and Walker after)]."""
    out = []
    step = bs.step

    def spy(scene_, static, step_, seed, iteration, lanes, t, prim, found_t,
            v, w, rays=None, plain=False):
        before = (v.count.clone(), dataclasses.replace(w))
        step(scene_, static, step_, seed, iteration, lanes, t, prim, found_t,
             v, w, rays, plain)
        out.append((step_, t, prim, before,
                    (v.count.clone(), dataclasses.replace(w))))

    monkeypatch.setattr(bs, "step", spy)
    px, py = _pixels(st)
    bdpt.render_lanes(sc, st, SEED, 1, px, py)
    monkeypatch.undo()
    return out


def test_step_bound_charges_no_dead_row(scene, monkeypatch):
    """chip_smoke.py's recounted bound of bdpt_step charges a row beyond
    its alive flag only where it steps: the bound over all 2N rows equals
    the bound over the rows alive at the step's start, plus a byte for
    each other row's flag; and a word only where its value changes: the
    bound less the bound of a state left as it was is the changed words
    of the rows' state, the counts that rose and the vertices made, no
    row left as it was charged a written byte."""
    import chip_smoke
    sc, st, name = scene
    steps = _plain_steps(sc, st, monkeypatch)
    assert len(steps) > 1
    for s, t, prim, (c0, w0), (c1, w1) in steps:
        full = chip_smoke.bdpt_step_bound(st, (c0, w0), (c1, w1), prim)
        on = w0.alive

        def sub(w):
            return dataclasses.replace(w, **{
                f: getattr(w, f)[on] for f in chip_smoke.WALKER_FIELDS
                if getattr(w, f) is not None})
        part = chip_smoke.bdpt_step_bound(st, (c0[on], sub(w0)),
                                          (c1[on], sub(w1)), prim[on])
        assert full["bytes"] == part["bytes"] + int((~on).sum()) \
            and full["rows"] == int(on.sum()) > 0, (name, s)
        same = chip_smoke.bdpt_step_bound(st, (c0, w0), (c0, w0), prim)
        changed = sum(
            int((chip_smoke.bits(getattr(w0, f)) != chip_smoke.bits(
                getattr(w1, f)))[on].sum()) * getattr(w0, f).element_size()
            for f in chip_smoke.WALKER_FIELDS if getattr(w0, f) is not None)
        for f in chip_smoke.WALKER_FIELDS:   # a row off the step: as it was
            if getattr(w0, f) is not None:
                assert _bitwise(getattr(w0, f)[~on], getattr(w1, f)[~on]), \
                    (name, s, f)
        made = int((c1 > c0).sum())
        assert full["bytes"] - same["bytes"] == changed + int(
            (c1 != c0).sum()) * 4 + made * 77, (name, s)


# ---------------------------------------------------------------------------
# bdpt_finish: the kernel's order and its bound
# ---------------------------------------------------------------------------
def _finish_args(sc, st, monkeypatch):
    """The arguments of the one finish call of a sample: (li, q, shadow,
    n_pix)."""
    px, py = _pixels(st)
    got = {}
    finish = bs.finish

    def spy(li, q, shadow, n_pix, plain=False):
        got["args"] = (li, q, shadow, n_pix)
        return finish(li, q, shadow, n_pix, plain)

    monkeypatch.setattr(bs, "finish", spy)
    bdpt.render_lanes(sc, st, SEED, 1, px, py)
    monkeypatch.undo()
    return got["args"]


def _finish_in_slot_order(li, q, shadow, n_pix, lanes=4):
    """bdpt_finish's loop (csrc/bdpt.cu) on the CPU: a thread `lanes`
    neighbouring lanes, the slots in order; a slot's credit L x tr where
    live, else 0; s1's slots splatted; a round's columns added as they
    come (its first column the sum's start), the round added to li at its
    last column; then the NaN guard."""
    g = q.pix.shape[0]
    s, n = q.live.shape
    tr = torch.where(shadow[:, None], 0.0, 1.0).expand(s * n, 3) \
        if shadow.dtype == torch.bool else shadow
    tr = tr.reshape(s, n, 3)
    out = torch.empty_like(li)
    film = torch.zeros((n_pix, 3))
    for i0 in range(0, n, lanes):
        ln = slice(i0, min(i0 + lanes, n))
        acc, lv = None, li[ln]
        for j in range(s):
            f = q.live[j, ln]
            c = torch.where(f[:, None], q.L[j, ln] * tr[j, ln], 0.0)
            if j < g:
                film.index_put_((q.pix[j, ln][f].long(),), c[f],
                                accumulate=True)
                continue
            col = (j - g) % g
            acc = c if col == 0 else acc + c
            if col == g - 1:
                lv = lv + acc
        out[ln] = torch.where(torch.isfinite(lv).all(-1)[:, None], lv, 0.0)
    return out, film


@pytest.mark.parametrize("poison", [False, True])
def test_finish_in_slot_order_is_finish_torch(scene, monkeypatch, poison):
    """finish_torch, the plain version, walked as bdpt_finish walks the
    queue (a thread four lanes, the slots in order, each round's columns
    summed as they come and the round added at its last column) gives
    the same per-lane radiance bit for bit and the film within float32
    summation order; with a live credit made infinite, the NaN guard
    zeroes the same lane."""
    sc, st, name = scene
    li, q, shadow, n_pix = _finish_args(sc, st, monkeypatch)
    g = q.pix.shape[0]
    assert bool(q.live[g:].any()) and bool(q.live[:g].any()), name
    if poison:
        q = dataclasses.replace(q, L=q.L.clone())
        j, i = q.live[g:].nonzero()[0].tolist()
        q.L[g + j, i, 0] = float("inf")
    li_p, film_p = bs.finish_torch(li, q, shadow, n_pix)
    li_k, film_k = _finish_in_slot_order(li, q, shadow, n_pix)
    assert _bitwise(li_k, li_p), name
    _close(film_k, film_p)
    if poison:
        assert bool((li_p[i] == 0).all()) and bool(torch.isfinite(li[i]).all())


def test_finish_bound_charges_live_slots_only(scene, monkeypatch):
    """chip_smoke.py's bound of bdpt_finish charges every slot's flag, the
    lanes' radiance in and out and the film once, and a slot's credit
    (12 B), verdict (a byte, or Tr's 12 B with media) and, in s1, pixel
    (4 B) only where the slot is live, whatever an empty slot holds."""
    import chip_smoke
    sc, st, name = scene
    _, q, shadow, n_pix = _finish_args(sc, st, monkeypatch)
    s, n = q.live.shape
    g = q.pix.shape[0]
    b = chip_smoke.bdpt_finish_bound(q, shadow, n_pix)
    dead = chip_smoke.bdpt_finish_bound(
        dataclasses.replace(q, live=torch.zeros_like(q.live)), shadow, n_pix)
    assert dead["bytes"] == s * n + n * 24 + n_pix * 12, name
    verdict = 1 if shadow.dtype == torch.bool else 12
    assert b["bytes"] - dead["bytes"] == int(q.live.sum()) * (
        12 + verdict) + int(q.live[:g].sum()) * 4 > 0, name
    scribbled = dataclasses.replace(
        q, L=torch.where(q.live[..., None], q.L, float("nan")))
    assert chip_smoke.bdpt_finish_bound(scribbled, shadow, n_pix) == b
    assert b["bound_ms"] == b["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
