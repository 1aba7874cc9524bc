"""The VPT wavefront's step (integrators/vpt_shade.py) on the CPU.

`shade_torch`, `tr_round_torch` and `finish_torch`, the plain versions of
csrc/vpt_shade.cu, are the VPT step regrouped around one transmittance
walk a lane, its credit pending until the walk has run. These tests hold
the restructured `vpt.render_lanes` over them, bit for bit, to the step
written with its walks inside it (`_reference_steps`: the loop body with
a walk for the medium-scatter NEE ray, one for the surface NEE ray and
the emitter segment's Tr, each credit added at once), step by step (the
lane state and the radiance with the pending credit settled, after every
step) and over whole paths (radiance and rays), on small scenes:
smoke_port at 16^2 (heterogeneous smoke, HG fog, interfaces), its
fog-camera edit (a homogeneous medium around the camera), smoke_port's
sky.json, cornell_port (no media) and bssrdf.json (VPT shades its
BSSRDF material as a plain surface). The kernels themselves run only on
the card (chip_smoke.py phase V holds them to these plain versions).
"""

import json

import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu_torch.core.rng import (
    PSS_CAM_DIMS, TRACK_EMITTER, TRACK_SAMPLE, TRACK_SCATTER, TRACK_SURFACE,
    VPT_MEDIUM, VPT_SCATTER, VPT_STEP_DIMS, VPT_SURFACE, lane_stream,
    track_tag,
)
from gpu_pathtracer_tpu_torch.core.sampling import power_heuristic
from gpu_pathtracer_tpu_torch.core.vecmath import dot, is_black, luminance
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators import vpt, vpt_shade
from gpu_pathtracer_tpu_torch.integrators.common import primary_rays
from gpu_pathtracer_tpu_torch.integrators.pt import (
    env_credit_weight, lane_ids_of,
)
from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
from gpu_pathtracer_tpu_torch.scene.parse import load_scene
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod
from gpu_pathtracer_tpu_torch.shade import media as media_mod
from gpu_pathtracer_tpu_torch.shade.media import TrackKey

SCENES = {
    "smoke": (tp.SMOKE_SCENE, 16),
    "fog_camera": (tp.SMOKE_SCENE, 12),
    "smoke_camera": (tp.SMOKE_SCENE, 12),
    "sky": (tp.REPO / "scenes" / "smoke_port" / "sky.json", 16),
    "cornell": (tp.PORT_SCENES["cornell"], 16),
    "bssrdf": (tp.BSSRDF_SCENE, 16),
}


def _fog_camera(doc):
    """smoke_port without the smoke, the camera inside the fog sphere
    looking at the back wall (as tests/test_torch_vpt.py edits it)."""
    doc["medium"] = [m for m in doc["medium"] if m["name"] == "fog"]
    doc["scene"] = [u for u in doc["scene"] if u.get("inside") != "smoke"]
    doc["camera"].update(position=[0.5, 0.45, 0.7], lookat=[0.0, 1.0, -1.0],
                         fov=60, medium="fog")


def _smoke_camera(doc):
    """smoke_port without the smoke box's interface, the camera in the
    smoke's density box looking up at the light: camera rays reach the
    light through the heterogeneous medium (the emitter segment's walk)."""
    doc["scene"] = [u for u in doc["scene"] if u.get("inside") != "smoke"]
    doc["camera"].update(position=[-0.35, 1.2, -0.45], lookat=[0.0, 2.0, 0.0],
                         fov=60, medium="smoke")


EDITS = {"fog_camera": _fog_camera, "smoke_camera": _smoke_camera}


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request, tmp_path_factory):
    """(DeviceScene, StaticConfig) on the CPU, and its name."""
    path, size = SCENES[request.param]
    if request.param in EDITS:
        doc = json.loads(path.read_text())
        for unit in doc["scene"] + doc["light"]:
            if "mesh" in unit:
                unit["mesh"] = str(path.parent / unit["mesh"])
        for med in doc["medium"]:
            if "density" in med:
                med["density"] = str(path.parent / med["density"])
        EDITS[request.param](doc)
        path = tmp_path_factory.mktemp("edit") / f"{request.param}.json"
        path.write_text(json.dumps(doc))
    host = load_scene(str(path))
    host.width = host.height = size
    sc, st = flatten_scene(host, torch.device("cpu"))
    if request.param == "fog_camera":
        assert st.camera_medium == 0 and not st.has_hetero
    return sc, st, request.param


def _sample_light_toward(scene, static, rng, pos):
    u_pick = rng.uniform()
    idx, choice_pdf = lights_mod.pick_light(scene, u_pick)
    u1, u2 = rng.uniform2()
    from gpu_pathtracer_tpu_torch.integrators.common import sample_light
    rad, sd, st, pdf = sample_light(scene, static, pos, pos, idx, u1, u2)
    return rad, sd, st, pdf, choice_pdf


def _direct_light_vol(scene, static, rng, key, pos, nor, dpdu, mat, wi,
                      med_idx, active):
    """Surface NEE with its transmittance walk inside (the step before
    its regrouping)."""
    rad, sd, st, light_pdf, choice_pdf = _sample_light_toward(
        scene, static, rng, pos)
    cand = active & ~is_black(rad) & (light_pdf > 0.0)
    fr, sample_pdf = bsdf_mod.eval_bsdf(mat, wi, sd, nor, dpdu,
                                        static.material_types)
    tr, rays = media_mod.transmittance(
        scene, static, med_idx, pos, sd, torch.where(cand, st, 0.0), key,
        cand)
    weight = power_heuristic(light_pdf * choice_pdf, sample_pdf)
    denom = torch.clamp_min(light_pdf * choice_pdf, 1e-30)
    contrib = weight[:, None] * tr * fr * rad \
        * torch.abs(dot(nor, sd))[:, None] / denom[:, None]
    return torch.where(cand[:, None], contrib, 0.0), rays


def _reference_steps(scene, static, seed, iteration, px, py):
    """The VPT loop with its walks inside each step (all-plain), yielding
    the state after every step, then the radiance after the NaN guard."""
    lanes = lane_ids_of(static, px, py)
    ro, rd = primary_rays(scene, static, lane_stream(
        seed, iteration, lanes, None, 0, PSS_CAM_DIMS, plain=True), px, py)
    n = ro.shape[0]
    eps = scene.epsilon

    def stream(step, scope, budget):
        return lane_stream(seed, iteration, lanes, None,
                           PSS_CAM_DIMS + step * VPT_STEP_DIMS + scope,
                           budget, plain=True)

    def key(step, site):
        return TrackKey(seed, iteration, lanes, track_tag(step, site))

    li = torch.zeros((n, 3))
    beta = torch.ones((n, 3))
    specular = torch.zeros(n, dtype=torch.bool)
    alive = torch.ones(n, dtype=torch.bool)
    depth = torch.zeros(n, dtype=torch.int32)
    med = torch.full((n,), static.camera_medium, dtype=torch.int32)
    prev_pdf = torch.ones(n)
    from_surf = torch.zeros(n, dtype=torch.bool)
    rays = torch.zeros((), dtype=torch.int64)
    for it in range(static.max_depth + vpt.INTERFACE_BUDGET + 1):
        if not bool(alive.any()):
            break
        rays = rays + alive.sum()
        hit = traverse.intersect_closest(
            scene, static, ro, rd, eps, torch.where(alive, torch.inf, 0.0),
            True)
        if static.has_infinite:
            full = (depth == 0) | specular
            take_env = alive & ~hit.valid & (full | from_surf)
            w_env = env_credit_weight(scene, static, full, prev_pdf)
            env = lights_mod.infinite_le(scene, rd)
            li = li + torch.where(take_env[:, None],
                                  beta * env * w_env[:, None], 0.0)
        alive = alive & hit.valid
        if static.has_media:
            u0 = stream(it, VPT_MEDIUM, 1).uniform()
            weight, t_med, sampled = media_mod.medium_sample(
                scene, static, med, ro, rd, hit.t, u0,
                key(it, TRACK_SAMPLE), alive, True)
            beta = torch.where(alive[:, None], beta * weight, beta)
            alive = alive & ~is_black(beta)
        else:
            sampled = torch.zeros(n, dtype=torch.bool)
            t_med = hit.t
        at_max = depth >= static.max_depth
        alive = alive & ~(sampled & at_max)
        in_scatter = alive & sampled
        if static.has_media:
            sample_pos = ro + rd * t_med[:, None]
            srng = stream(it, VPT_SCATTER, 5)
            rad, sd, st, light_pdf, choice_pdf = _sample_light_toward(
                scene, static, srng, sample_pos)
            cand = in_scatter & ~is_black(rad) & (light_pdf > 0.0)
            tr, sh = media_mod.transmittance(
                scene, static, med, sample_pos, sd,
                torch.where(cand, st, 0.0), key(it, TRACK_SCATTER), cand,
                True)
            rays = rays + sh
            ph = media_mod.phase(scene, med, -rd, sd)
            denom = torch.clamp_min(light_pdf * choice_pdf, 1e-30)
            contrib = tr * beta * (ph / denom)[:, None] * rad
            li = li + torch.where(cand[:, None], contrib, 0.0)
            u1, u2 = srng.uniform2()
            new_dir, _ = media_mod.sample_phase(scene, med, -rd, u1, u2)
            ro = torch.where(in_scatter[:, None], sample_pos, ro)
            rd = torch.where(in_scatter[:, None], new_dir, rd)
            specular = torch.where(in_scatter, False, specular)
            from_surf = torch.where(in_scatter, False, from_surf)
        on_surface = alive & ~sampled
        if static.n_lights > 0:
            full = (depth == 0) | specular
            emitter = on_surface & (hit.light_idx >= 0)
            le = lights_mod.area_light_le(scene, hit.light_idx, hit.nor, -rd)
            if static.has_media:
                tr_e = media_mod.medium_tr_segment(
                    scene, static, med, ro, rd,
                    torch.where(emitter & full, hit.t, 0.0),
                    key(it, TRACK_EMITTER), emitter & full, True)
            else:
                tr_e = torch.ones((n, 3))
            li = li + torch.where((emitter & full)[:, None],
                                  tr_e * beta * le, 0.0)
            lidx = torch.clamp_min(hit.light_idx, 0)
            pdf_area, _ = lights_mod.area_light_pdf(scene, lidx, rd, hit.nor)
            lchoice = lights_mod.light_choice_pdf(scene, lidx)
            seg = hit.pos - ro
            cos_l = torch.abs(dot(hit.nor, rd))
            l_pdf = pdf_area * dot(seg, seg) / torch.clamp_min(cos_l, 1e-30)
            w_le = power_heuristic(prev_pdf, l_pdf * lchoice)
            mis_hit = emitter & ~full & from_surf & ~is_black(le)
            li = li + torch.where(mis_hit[:, None],
                                  beta * le * w_le[:, None], 0.0)
            died = emitter & full
            alive = alive & ~died
            on_surface = on_surface & ~died
        alive = alive & ~at_max
        on_surface = on_surface & ~at_max
        interface = on_surface & (hit.mat_idx == -1)
        going_out = dot(rd, hit.nor) > 0.0
        side_med = torch.where(going_out, hit.medium_outside,
                               hit.medium_inside)
        med = torch.where(interface, side_med, med)
        ro = torch.where(interface[:, None], hit.pos, ro)
        on_surface = on_surface & ~interface
        mat = bsdf_mod.gather_materials(scene, static, hit.mat_idx, hit.uv)
        wi = -rd
        not_delta = ~bsdf_mod.is_delta(mat.type)
        surf_rng = stream(it, VPT_SURFACE, 7)
        ld, sh = _direct_light_vol(
            scene, static, surf_rng, key(it, TRACK_SURFACE), hit.pos,
            hit.nor, hit.dpdu, mat, wi, med, on_surface & not_delta)
        rays = rays + sh
        li = li + beta * ld
        u1, u2, u3 = surf_rng.uniform3()
        wo, fr, pdf = bsdf_mod.sample_bsdf(
            mat, wi, hit.nor, hit.dpdu, u1, u2, u3, static.material_types)
        dead = on_surface & (is_black(fr) | (pdf <= 0.0))
        alive = alive & ~dead
        surf_go = on_surface & ~dead
        beta_next = beta * fr * torch.abs(dot(hit.nor, wo))[:, None] \
            / torch.clamp_min(pdf, 1e-30)[:, None]
        beta = torch.where(surf_go[:, None], beta_next, beta)
        delta = bsdf_mod.is_delta(mat.type)
        specular = torch.where(surf_go, delta, specular)
        prev_pdf = torch.where(surf_go, pdf, prev_pdf)
        from_surf = torch.where(surf_go, ~delta, from_surf)
        out_side = torch.where(dot(wo, hit.nor) > 0.0, hit.medium_outside,
                               hit.medium_inside)
        same_side = dot(wi, hit.nor) * dot(wo, hit.nor) > 0.0
        med = torch.where(surf_go, torch.where(same_side, med, out_side),
                          med)
        ro = torch.where(surf_go[:, None], hit.pos, ro)
        rd = torch.where(surf_go[:, None], wo, rd)
        consumed = in_scatter | surf_go
        depth = torch.where(consumed, depth + 1, depth)
        u_rr = surf_rng.uniform()
        illumate = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
        do_rr = (depth > 4) & alive & consumed
        alive = alive & ~(do_rr & (u_rr < illumate))
        rr_scale = 1.0 / torch.clamp_min(1.0 - illumate, 1e-30)
        beta = torch.where((do_rr & alive)[:, None],
                           beta * rr_scale[:, None], beta)
        yield dict(ro=ro, rd=rd, li=li, beta=beta, prev_pdf=prev_pdf,
                   depth=depth, med=med, rays=rays,
                   flags=specular.to(torch.int32)
                   | (alive.to(torch.int32) << 1)
                   | (from_surf.to(torch.int32) << 2))
    bad = ~torch.isfinite(li).all(dim=-1)
    yield torch.where(bad[:, None], 0.0, li), rays


def _bitwise(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32) if a.dtype == torch.float32 else a,
        b.contiguous().view(torch.int32) if b.dtype == torch.float32 else b)


def _pixels(st):
    ids = torch.arange(st.width * st.height)
    return ids % st.width, ids // st.width


@pytest.mark.parametrize("iteration", [1, 2])
def test_render_lanes_is_the_reference_loop(scene, iteration):
    """Whole paths over the regrouped step (one walk a lane, pending
    credits, the emitter segment's walk in round 0, `finish`) give the
    reference loop's radiance and ray count bit for bit; on CPU tensors
    the step kernels never count a launch or a plain call."""
    sc, st, _ = scene
    px, py = _pixels(st)
    *_, (ref, rays_ref) = _reference_steps(sc, st, 5, iteration, px, py)
    stats = (vpt_shade.STATS, vpt_shade.TR_STATS, vpt_shade.FINISH_STATS)
    for st_ in stats:
        st_.launches = st_.plain_cuda = 0
    got, rays = vpt.render_lanes(sc, st, 5, iteration, px, py, True)
    assert _bitwise(got, ref)
    assert int(rays) == int(rays_ref)
    assert got.mean() > 0.0 and bool(torch.isfinite(got).all())
    assert all(st_.launches == st_.plain_cuda == 0 for st_ in stats)


def test_steps_are_the_reference_steps(scene, monkeypatch):
    """Step by step: at the start of each step after the first (and in
    `finish` after the last), the lane state equals the reference's after
    the step before, bit for bit, and the radiance does once the pending
    credit of the step's walk is settled; the rays so far are equal."""
    sc, st, name = scene
    px, py = _pixels(st)
    ref = list(_reference_steps(sc, st, 9, 1, px, py))[:-1]
    seen, last = [], {}
    shade, finish = vpt_shade.shade, vpt_shade.finish

    def record(lane, walk, walk_out, rays):
        li = lane.li if walk is None else vpt_shade._settle(walk, walk_out,
                                                            lane.li)
        seen.append(dict(ro=lane.ro, rd=lane.rd, li=li, beta=lane.beta,
                         prev_pdf=lane.prev_pdf, depth=lane.depth,
                         med=lane.med, flags=lane.flags, rays=int(rays)))

    def shade_spy(scene_, static, step, seed, iteration, lanes, t, prim,
                  lane, found_t=None, walk=None, walk_out=None, rays=None,
                  plain=False):
        if step > 0:
            record(lane, walk, walk_out, rays)
        out = shade(scene_, static, step, seed, iteration, lanes, t, prim,
                    lane, found_t, walk, walk_out, rays, plain)
        last.update(lane=out[0], rays=rays)
        return out

    def finish_spy(li, walk, walk_out=None, plain=False):
        record(last["lane"], walk, walk_out, last["rays"])
        return finish(li, walk, walk_out, plain)

    monkeypatch.setattr(vpt_shade, "shade", shade_spy)
    monkeypatch.setattr(vpt_shade, "finish", finish_spy)
    vpt.render_lanes(sc, st, 9, 1, px, py, True)
    assert len(seen) == len(ref) > 3, (len(seen), len(ref))
    for s, (a, b) in enumerate(zip(seen, ref)):
        for f in ("ro", "rd", "li", "beta", "prev_pdf", "depth", "med",
                  "flags"):
            assert _bitwise(a[f], b[f]), (name, s, f)
        assert a["rays"] == int(b["rays"]), (name, s)


def test_one_walk_serves_several_call_sites(scene, monkeypatch):
    """Some step's walk holds lanes of two call sites at once
    (medium-scatter and surface NEE rays: smoke_port and its edits), which
    the unregrouped step walks apart; with the camera in the smoke,
    emitter segments join round 0's track call (EMIT, TRACK_EMITTER)."""
    sc, st, name = scene
    px, py = _pixels(st)
    sites, emit = [], []
    shade = vpt_shade.shade

    def spy(*args, **kw):
        lane, walk = shade(*args, **kw)
        sites.append(set(walk.sites[(walk.flags & vpt_shade.WALKING) != 0]
                         .tolist()))
        emit.append(int(((walk.flags & vpt_shade.EMIT) != 0).sum()))
        assert bool((walk.sites[(walk.flags & vpt_shade.EMIT) != 0]
                     == TRACK_EMITTER).all())
        return lane, walk

    monkeypatch.setattr(vpt_shade, "shade", spy)
    vpt.render_lanes(sc, st, 5, 1, px, py)
    if st.has_media:
        assert any(s >= {TRACK_SCATTER, TRACK_SURFACE} for s in sites), sites
    else:
        assert all(s <= {TRACK_SURFACE} for s in sites), sites
    assert (sum(emit) > 0) == (name == "smoke_camera"), emit


def test_vpt_shade_refuses_cpu_tensors(scene):
    """The kernels' wrappers take CUDA tensors only: no fallback."""
    sc, st, _ = scene
    n = st.width * st.height
    ro = torch.zeros((n, 3))
    lane = vpt_shade.start(sc, st, ro, ro)
    rays = torch.zeros((), dtype=torch.int64)
    t, prim = torch.zeros(n), torch.full((n,), -1, dtype=torch.int32)
    found = torch.zeros(n) if st.has_hetero else None
    lanes = torch.arange(n)
    with pytest.raises(ValueError, match="CUDA"):
        vpt_shade.shade_cuda(sc, st, 0, 1, 1, lanes, t, prim, lane, found,
                             rays=rays)
    _, walk = vpt_shade.shade_torch(sc, st, 0, 1, 1, lanes, t, prim, lane,
                                    found, rays=rays)
    with pytest.raises(ValueError, match="CUDA"):
        vpt_shade.tr_round_cuda(sc, st, t, prim, walk, rays=rays)
    with pytest.raises(ValueError, match="CUDA"):
        vpt_shade.finish_cuda(lane.li, walk)


# ---------------------------------------------------------------------------
# The lists the kernels cover (vpt_shade.shade_list, round_list): the plain
# versions leave every lane off a launch's list as it was, so a kernel that
# reads and writes only the listed rows, in place, gives the same paths.
# ---------------------------------------------------------------------------
LANE_FIELDS = ("ro", "rd", "li", "beta", "prev_pdf", "depth", "med", "flags",
               "tmax", "med_sample")
WALK_FIELDS = ("o", "d", "rem", "med", "tr", "flags", "sites", "pending",
               "tmax", "track_med", "track_t")


@pytest.fixture(scope="module")
def path_calls(scene):
    """One whole path of every lane through the plain versions, with the
    arguments and results of each shade, tr_round and finish call."""
    sc, st, name = scene
    px, py = _pixels(st)
    calls = []
    orig = {k: getattr(vpt_shade, k) for k in ("shade", "tr_round", "finish")}

    def shade(*args, **kw):
        out = orig["shade"](*args, **kw)
        calls.append(("shade", args[8], args[10], args[11], out))
        return out

    def tr_round(*args, **kw):
        out = orig["tr_round"](*args, **kw)
        calls.append(("round", args[4], args[5], None, out))
        return out

    def finish(li, walk, walk_out=None, plain=False):
        out = orig["finish"](li, walk, walk_out, plain)
        calls.append(("finish", li, walk, walk_out, out))
        return out

    for k, fn in (("shade", shade), ("tr_round", tr_round),
                  ("finish", finish)):
        setattr(vpt_shade, k, fn)
    try:
        li, rays = vpt.render_lanes(sc, st, 7, 1, px, py, True)
    finally:
        for k, fn in orig.items():
            setattr(vpt_shade, k, fn)
    return name, calls, li, rays


def _rows_equal(a, b, rows):
    """Whether tensors a and b are bit-equal on the lanes of `rows`."""
    if a is None or b is None:
        return a is None and b is None
    return _bitwise(a[rows], b[rows])


def test_shade_leaves_lanes_off_its_list_unchanged(path_calls):
    """Every step of a whole path: the lanes outside `shade_list` (dead,
    owed no credit, beta finite) leave `shade_torch` with every lane field
    and, after the first step, every walk field bit-unchanged (their
    tmax 0 and med_sample -1 were written when they died)."""
    name, calls, _, _ = path_calls
    off_any = 0
    for s, (kind, lane, walk, _, (lane2, walk2)) in enumerate(
            c for c in calls if c[0] == "shade"):
        off = ~vpt_shade.shade_list(lane, walk)
        off_any += int(off.sum())
        for f in LANE_FIELDS:
            assert _rows_equal(getattr(lane, f), getattr(lane2, f), off), \
                (name, s, f)
        if walk is not None:
            for f in WALK_FIELDS[:9]:
                assert _rows_equal(getattr(walk, f), getattr(walk2, f), off), \
                    (name, s, "walk", f)
    assert off_any > 0, name


def test_round_leaves_lanes_off_its_list_unchanged(path_calls):
    """Every round of every step: the lanes outside `round_list` (neither
    walking, nor with an emitter segment to walk, nor a Tr to fold) leave
    `tr_round_torch` with every walk field bit-unchanged, their track call
    empty (track_med -1, track_t 0); the rounds' lists shrink."""
    name, calls, _, _ = path_calls
    sizes = []
    for kind, walk, _, _, walk2 in (c for c in calls if c[0] == "round"):
        on = vpt_shade.round_list(walk)
        sizes.append(int(on.sum()))
        for f in WALK_FIELDS[:9]:
            assert _rows_equal(getattr(walk, f), getattr(walk2, f), ~on), \
                (name, f)
        assert bool((walk2.track_med[~on] == -1).all()), name
        assert bool((walk2.track_t[~on] == 0.0).all()), name
        if walk.track_med is not None:
            for f in ("track_med", "track_t"):
                assert _rows_equal(getattr(walk, f), getattr(walk2, f), ~on)
        # the next round's list: the lanes still walking or folding
        assert bool((vpt_shade.round_list(walk2) <= on).all()), name
    assert sizes and max(sizes) < walk.flags.numel(), (name, sizes)


def test_dead_lanes_with_credit_stay_listed(path_calls):
    """A lane that dies in step s with the credit of step s's walk pending
    is on step s + 1's list (`shade_list` of the state after the walk),
    or, after the last step, settled by `finish_torch`; some of those
    credits add radiance, so a list of the alive lanes alone would lose
    it."""
    name, calls, _, _ = path_calls
    steps = [c for c in calls if c[0] == "shade"]
    fin = next(c for c in calls if c[0] == "finish")
    died_total, added = 0, 0
    for s, (_, lane, _, _, (lane2, walk2)) in enumerate(steps):
        died = ((lane.flags & vpt_shade.ALIVE) != 0) \
            & ((lane2.flags & vpt_shade.ALIVE) == 0) \
            & ((walk2.flags & vpt_shade.CREDIT) != 0)
        died_total += int(died.sum())
        if s + 1 < len(steps):   # step s + 1 settles it
            _, lane_n, walk_n, walk_out_n, (lane_n2, _) = steps[s + 1]
            assert bool(vpt_shade.shade_list(lane_n, walk_n)[died].all()), \
                (name, s)
            li = lane_n.li
            settled = vpt_shade._settle(walk_n, walk_out_n, li)
        else:   # finish settles it
            _, li, walk_f, walk_out_f, out = fin
            assert walk_f is walk2 or bool(
                (walk_f.flags[died] & vpt_shade.CREDIT != 0).all()), name
            settled = vpt_shade._settle(walk_f, walk_out_f, li)
            assert _rows_equal(vpt_shade.finish_torch(li, walk_f, walk_out_f),
                               out, torch.ones_like(died))
        added += int((settled[died] != li[died]).any(1).sum())
    assert died_total > 0 and added > 0, (name, died_total, added)


def _listed(fn_list, new, old, fields):
    """`new` with the lanes off the boolean list `fn_list` taken from
    `old`, field by field (a field `old` lacks is kept)."""
    import dataclasses
    keep = {}
    for f in fields:
        a, b = getattr(new, f), getattr(old, f)
        if a is None or b is None:
            continue
        m = fn_list if a.dim() == 1 else fn_list[:, None]
        keep[f] = torch.where(m, a, b)
    return dataclasses.replace(new, **keep)


def test_listed_steps_give_the_same_paths(scene, monkeypatch):
    """The kernels' contract, modelled on the CPU: each step changes only
    the rows of `shade_list` and each round only those of `round_list`,
    in place; of a lane dead at the step's start only li; a walk row
    whole only where a credit starts, its flags and tmax where one starts
    or ends; the last round's track call reset where it folded, its
    origin written only where it walks (the rows off the lists, and the
    walk fields no credit holds, keep what an older launch left). After
    each step the walk equals the plain step's under `live_walk`, and
    whole paths through this model give `render_lanes`' radiance and rays
    bit for bit."""
    import dataclasses
    sc, st, name = scene
    px, py = _pixels(st)
    ref, rays_ref = vpt.render_lanes(sc, st, 3, 1, px, py, True)
    shade, tr_round = vpt_shade.shade, vpt_shade.tr_round
    state = {}

    def shade_listed(scene_, static, step, seed, iteration, lanes, t, prim,
                     lane, found_t=None, walk=None, walk_out=None, rays=None,
                     plain=False):
        on = vpt_shade.shade_list(lane, walk)
        lane2, walk2 = shade(scene_, static, step, seed, iteration, lanes, t,
                             prim, lane, found_t, walk, walk_out, rays, plain)
        # a lane dead at the step's start changes li alone
        lane2 = _listed(on, lane2, lane, ("li",))
        lane2 = _listed(on & ((lane.flags & vpt_shade.ALIVE) != 0), lane2,
                        lane, LANE_FIELDS[:2] + LANE_FIELDS[3:])
        n = on.numel()
        prev = walk if walk is not None else vpt_shade.Walk(
            torch.full((n, 3), 7.0), torch.full((n, 3), -7.0),
            torch.full((n,), 7.0), torch.zeros(n, dtype=torch.int32),
            torch.full((n, 3), 7.0), torch.zeros(n, dtype=torch.int32),
            torch.full((n,), 9, dtype=torch.int32),
            torch.full((n, vpt_shade.PEND), 7.0), torch.zeros(n),
            torch.full((n,), -1, dtype=torch.int32), torch.zeros(n),
            torch.full((n, 3), 7.0))
        # the walk's row where a credit starts, its flags and tmax where one
        # starts or ends; the last round's track call reset where it folded
        full = walk2
        credit = (walk2.flags & vpt_shade.CREDIT) != 0
        walk2 = _listed(on & ((walk2.flags != 0) | (prev.flags != 0)), walk2,
                        prev, ("flags", "tmax"))
        walk2 = _listed(credit, walk2, prev, ("o", "d", "rem", "med", "tr",
                                              "sites", "pending"))
        # the walk as later launches read it is the plain step's
        live, live_full = vpt_shade.live_walk(walk2), vpt_shade.live_walk(full)
        for f in WALK_FIELDS[:9]:
            assert _bitwise(getattr(live, f), getattr(live_full, f)), (step, f)
        reset = (prev.flags & vpt_shade.FOLD) != 0
        walk2 = dataclasses.replace(
            walk2, track_med=torch.where(reset, -1, prev.track_med),
            track_t=torch.where(reset, 0.0, prev.track_t),
            track_o=prev.track_o)
        return lane2, walk2

    def round_listed(scene_, static, t, prim, walk, walk_out=None, rays=None,
                     plain=False):
        on = vpt_shade.round_list(walk)
        walk2 = tr_round(scene_, static, t, prim, walk, walk_out, rays, plain)
        walk2 = _listed(on, walk2, walk, WALK_FIELDS)
        folds = walk2.track_med >= 0
        return dataclasses.replace(walk2, track_o=torch.where(
            folds[:, None], walk.o, walk.track_o))

    monkeypatch.setattr(vpt_shade, "shade", shade_listed)
    monkeypatch.setattr(vpt_shade, "tr_round", round_listed)
    got, rays = vpt.render_lanes(sc, st, 3, 1, px, py, True)
    assert _bitwise(got, ref), name
    assert int(rays) == int(rays_ref), name
