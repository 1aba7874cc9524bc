"""The PT wavefront's shading step (integrators/pt_shade.py) on the CPU.

`shade_torch`, the plain version of csrc/pt_shade.cu, is the wavefront's
bounce regrouped: its NEE credit waits for the shadow ray's verdict and
is added at the start of the next bounce. These tests hold it, bit for
bit, to the same estimator written with the any-hit query inside the
bounce and the credit added at once (`_reference_bounce`:
pt._arrival_credit, bsdf.gather_materials, common.sample_light +
bsdf.eval_bsdf with the any-hit query in between, bsdf.sample_bsdf, the
roulette), bounce by bounce and over whole paths with the coherence
sorts (`_reference_trace_paths`), on small scenes: cornell_port, its 72
lights, a knot of 2,000 triangles at 64^2 (the sorted regime),
bssrdf.json and a sky scene. The wavefront's lane records
(`pt_shade.Wave`): the sorted wavefront, its records read through the
sort's order, equals the unsorted one lane for lane; the int32 keys
sort as the int64 keys did; a lane that finishes writes its radiance to
its caller's slot once; chip_smoke.py's recounted bound charges no lane
the bounce does not visit and no word left as it was. The kernel's
light pick, a binary search, is held to lights.pick_light at the CDF's
steps. The kernel itself runs only on the card (chip_smoke.py phase S
holds it to `shade_wave_torch`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu_torch.core.rng import (
    PSS_BOUNCE_DIMS, PSS_CAM_DIMS, lane_stream,
)
from gpu_pathtracer_tpu_torch.core.sampling import power_heuristic
from gpu_pathtracer_tpu_torch.core.vecmath import dot, is_black, luminance
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.geom.dense import DENSE_MAX
from gpu_pathtracer_tpu_torch.integrators import common, pt, pt_shade
from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
from gpu_pathtracer_tpu_torch.scene.parse import load_scene
from gpu_pathtracer_tpu_torch.shade import bsdf as bsdf_mod
from gpu_pathtracer_tpu_torch.shade import lights as lights_mod

SCENES = {
    "cornell": tp.PORT_SCENES["cornell"],
    "many_lights": tp.MANY_LIGHTS,
    "bssrdf": tp.BSSRDF_SCENE,
    "sky": tp.REPO / "scenes" / "env_port" / "mixed.json",
}


@pytest.fixture(scope="module")
def knot_path(tmp_path_factory):
    return tp.write_knot_scene(tmp_path_factory.mktemp("knot"))


@pytest.fixture(params=[*SCENES, "knot"])
def scene(request, knot_path):
    """(DeviceScene, StaticConfig) on the CPU: 32^2, the knot 64^2."""
    path = knot_path if request.param == "knot" else SCENES[request.param]
    host = load_scene(str(path))
    host.width = host.height = 64 if request.param == "knot" else 32
    sc, st = flatten_scene(host, torch.device("cpu"))
    if request.param == "knot":
        assert st.n_primitives > DENSE_MAX   # the sorted regime
    return sc, st


def _psample(static, n, seed):
    d = PSS_CAM_DIMS + static.max_depth * PSS_BOUNCE_DIMS
    return torch.as_tensor(
        np.random.default_rng(seed).random((d, n), dtype=np.float32))


def _primary(sc, st, seed, it, psample):
    n = st.width * st.height
    ids = torch.arange(n)
    px, py = ids % st.width, ids // st.width
    lanes = pt.lane_ids_of(st, px, py)
    rng0 = lane_stream(seed, it, lanes, psample, 0, PSS_CAM_DIMS, plain=True)
    ro, rd = common.primary_rays(sc, st, rng0, px, py)
    return lanes, ro, rd


def _reference_bounce(sc, st, b, seed, it, lanes, ro, rd, li, beta, pdf,
                   specular, alive, psample):
    """Bounce b of the wavefront with NEE's shadow ray inside it: closest
    hit, arrival credit, the BSSRDF lanes' end (their radiance is the
    subsurface hook's, run alike by both), NEE with its any-hit query and
    credit in place, BSDF sample, roulette. Returns the next state and
    what the shading step must reproduce."""
    eps = sc.epsilon
    rng = lane_stream(seed, it, lanes, psample,
                      PSS_CAM_DIMS + b * PSS_BOUNCE_DIMS, PSS_BOUNCE_DIMS,
                      plain=True)
    n_closest = alive.sum()
    t, prim, found = traverse.closest_prim(
        sc, st, ro, rd, eps, torch.where(alive, torch.inf, 0.0), True)
    hit = traverse._hit_attributes(sc, st, ro, rd, t, prim, found)
    li, alive = pt._arrival_credit(sc, st, hit, ro, rd, li, beta, specular,
                                   pdf, alive, b == 0)
    sss = torch.zeros_like(alive)
    if st.has_bssrdf:
        sss = alive & (hit.bssrdf_idx >= 0)
        alive = alive & ~sss
    mat = bsdf_mod.gather_materials(sc, st, hit.mat_idx, hit.uv)
    wi = -rd
    u_pick = rng.uniform()
    idx, choice_pdf = lights_mod.pick_light(sc, u_pick)
    u1, u2 = rng.uniform2()
    rad, sd, stmax, light_pdf = common.sample_light(sc, st, hit.pos, hit.nor,
                                                    idx, u1, u2)
    cand = alive & ~bsdf_mod.is_delta(mat.type) & ~is_black(rad) \
        & (light_pdf > 0.0)
    occluded = common._occluded_sorted(sc, st, hit.pos, sd, stmax, cand, eps,
                                       True)
    lit = cand & ~occluded
    fr, sample_pdf = bsdf_mod.eval_bsdf(mat, wi, sd, hit.nor, hit.dpdu,
                                        st.material_types)
    denom = light_pdf * choice_pdf
    weight = power_heuristic(denom, sample_pdf)
    contrib = weight[:, None] * fr * rad * \
        torch.abs(dot(hit.nor, sd))[:, None] \
        / torch.clamp_min(denom, 1e-30)[:, None]
    ld = torch.where(lit[:, None], contrib, 0.0)
    li = li + torch.where(lit[:, None], beta * ld, 0.0)
    u1, u2, u3 = rng.uniform3()
    wo, fr, spdf = bsdf_mod.sample_bsdf(mat, wi, hit.nor, hit.dpdu, u1, u2,
                                        u3, st.material_types)
    alive = alive & ~(is_black(fr) | (spdf <= 0.0))
    beta_next = beta * fr * torch.abs(dot(hit.nor, wo))[:, None] \
        / torch.clamp_min(spdf, 1e-30)[:, None]
    beta = torch.where(alive[:, None], beta_next, beta)
    specular = torch.where(alive, bsdf_mod.is_delta(mat.type), specular)
    pdf = torch.where(alive, spdf, pdf)
    ro = torch.where(alive[:, None], hit.pos, ro)
    rd = torch.where(alive[:, None], wo, rd)
    u_rr = rng.uniform()
    if b > 3:
        illumate = torch.clamp(1.0 - luminance(beta), 0.0, 1.0)
        alive = alive & ~(u_rr < illumate)
        beta = torch.where(
            alive[:, None],
            beta * (1.0 / torch.clamp_min(1.0 - illumate, 1e-30))[:, None],
            beta)
    return dict(
        t=t, prim=prim, hit=hit, ro=ro, rd=rd, li=li, beta=beta, pdf=pdf,
        specular=specular, alive=alive, sss=sss,
        rays=torch.stack([n_closest, cand.sum()]),
        key=pt._sort_key(sc, ro, rd, alive),
        shadow_key=common._shadow_sort_key(
            sc, hit.pos, cand & (torch.where(cand, stmax, 0.0) > 0.0)))


def _flags(specular, alive):
    return specular.to(torch.int32) | (alive.to(torch.int32) << 1)


def _bitwise(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("sample", ["philox", "psample"])
@pytest.mark.parametrize("bounce", [0, 1, 4])
def test_shade_torch_is_reference_bounce(scene, bounce, sample):
    sc, st = scene
    n = st.width * st.height
    psample = _psample(st, n, 17) if sample == "psample" else None
    lanes, ro, rd = _primary(sc, st, 7, 2, psample)
    li = torch.zeros((n, 3))
    beta = torch.ones((n, 3))
    pdf = torch.ones(n)
    specular = torch.zeros(n, dtype=torch.bool)
    alive = torch.ones(n, dtype=torch.bool)
    for b in range(bounce):   # the state at the start of bounce `bounce`
        s = _reference_bounce(sc, st, b, 7, 2, lanes, ro, rd, li, beta,
                              pdf, specular, alive, psample)
        ro, rd, li, beta, pdf = s["ro"], s["rd"], s["li"], s["beta"], \
            s["pdf"]
        specular, alive = s["specular"], s["alive"]
    ref = _reference_bounce(sc, st, bounce, 7, 2, lanes, ro, rd, li, beta,
                            pdf, specular, alive, psample)
    lanes32 = lanes.to(torch.int32)
    got = pt_shade.shade_torch(
        sc, st, bounce, 7, 2, lanes32, ref["t"], ref["prim"], ro, rd, li,
        beta, pdf, _flags(specular, alive), None, psample, True, True)
    # the shadow rays' verdicts, then the credit the next bounce adds
    occ = common._occluded_sorted(sc, st, got.shadow_o, got.shadow_d,
                                  got.shadow_t, got.shadow_t > 0.0,
                                  sc.epsilon, True, got.shadow_key)
    li_next = got.li + torch.where(occ[:, None], 0.0, got.pending)
    assert _bitwise(li_next, ref["li"])
    for f, g in (("ro", got.ro), ("rd", got.rd), ("beta", got.beta),
                 ("pdf", got.prev_pdf)):
        assert _bitwise(g, ref[f]), f
    want = _flags(ref["specular"], ref["alive"]) \
        | (ref["sss"].to(torch.int32) << 3)
    assert torch.equal(got.flags, want)
    assert torch.equal(got.rays, ref["rays"])
    assert torch.equal(got.key, ref["key"])
    assert torch.equal(got.shadow_key, ref["shadow_key"])
    # the shadow rays leave from the hits
    cand = got.shadow_t > 0.0
    assert torch.equal(got.shadow_o[cand], ref["hit"].pos[cand])
    if st.has_bssrdf and bounce == 0:
        assert ref["sss"].any()


def _reference_trace_paths(sc, st, seed, it, lanes, ro, rd, psample):
    """pt.trace_paths over `_reference_bounce` (all-plain): the bounces
    with the subsurface hook, the coherence sorts above DENSE_MAX prims,
    the epilogue's arrival credit."""
    n = ro.shape[0]
    sort = psample is None and st.n_primitives > DENSE_MAX
    slot = torch.arange(n)
    if sort:
        order = torch.sort(pt._pixel_key(st, lanes), stable=True).indices
        (ro, rd), (lanes, slot) = common.permute_lanes(order, (ro, rd),
                                                       (lanes, slot))
    li = torch.zeros((n, 3))
    beta = torch.ones((n, 3))
    pdf = torch.ones(n)
    specular = torch.zeros(n, dtype=torch.bool)
    alive = torch.ones(n, dtype=torch.bool)
    rays = torch.zeros((), dtype=torch.int64)
    for b in range(st.max_depth):
        s = _reference_bounce(sc, st, b, seed, it, lanes, ro, rd, li, beta,
                              pdf, specular, alive, psample)
        li = s["li"]
        rays = rays + s["rays"].sum()
        if st.has_bssrdf:
            li, r = pt._subsurface(sc, st, seed, it, lanes, b, s["hit"], rd,
                                   li, beta, s["sss"], True)
            rays = rays + r
        ro, rd, beta, pdf = s["ro"], s["rd"], s["beta"], s["pdf"]
        specular, alive = s["specular"], s["alive"]
        if sort:
            order = torch.sort(s["key"], stable=True).indices
            flags = _flags(specular, alive)
            (ro, rd, li, beta, pdf), (lanes, slot, flags) = \
                common.permute_lanes(order, (ro, rd, li, beta, pdf),
                                     (lanes, slot, flags))
            specular, alive = (flags & 1) != 0, (flags & 2) != 0
    rays = rays + alive.sum()
    hit = traverse.intersect_closest(
        sc, st, ro, rd, sc.epsilon, torch.where(alive, torch.inf, 0.0), True)
    li, _ = pt._arrival_credit(sc, st, hit, ro, rd, li, beta, specular, pdf,
                               alive, False)
    if sort:
        li = torch.empty_like(li).index_put_((slot.long(),), li)
    li = torch.where(~torch.isfinite(li).all(-1)[:, None], 0.0, li)
    return li, rays


@pytest.mark.parametrize("shadow_sort", [False, True])
@pytest.mark.parametrize("sample", ["philox", "psample"])
def test_wavefront_is_the_reference_wavefront(scene, sample, shadow_sort,
                                              monkeypatch):
    """Whole paths over the shading step (pending credits, flags, sorts
    and the epilogue) give the reference's radiance and rays bit for
    bit; on CPU tensors the shading step never counts a launch."""
    sc, st = scene
    monkeypatch.setattr(common, "FORCE_SHADOW_SORT", shadow_sort)
    n = st.width * st.height
    psample = _psample(st, n, 23) if sample == "psample" else None
    lanes, ro, rd = _primary(sc, st, 5, 3, psample)
    ref, rays_ref = _reference_trace_paths(sc, st, 5, 3, lanes, ro, rd,
                                           psample)
    pt_shade.STATS.launches = pt_shade.STATS.plain_cuda = 0
    got, rays = pt.trace_paths(sc, st, 5, 3, lanes, ro, rd, True, psample)
    assert _bitwise(got, ref) and int(rays) == int(rays_ref)
    assert pt_shade.STATS.launches == 0 and pt_shade.STATS.plain_cuda == 0
    assert got.mean() > 0.0


def _kernel_pick(cdf, u):
    """csrc/pt_shade.cu's pick_light, line for line: the first i with
    cdf[i] > u by binary search over the n_rows + 2 entries, minus one,
    clamped to [0, n_rows]."""
    n_rows = cdf.shape[0] - 2
    lo, hi = 0, n_rows + 2
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        if not cdf[mid] > u:
            lo = mid + 1
        else:
            hi = mid
    return min(max(lo - 1, 0), n_rows)


def test_light_pick_at_cdf_steps():
    sc, st = flatten_scene(load_scene(str(tp.MANY_LIGHTS)),
                           torch.device("cpu"))
    assert st.n_lights == 72
    cdf = sc.light_cdf.numpy()
    steps = cdf[:-1]
    below = np.nextafter(steps, np.float32(-1.0))
    above = np.nextafter(steps, np.float32(2.0))
    rng = np.random.default_rng(3)
    u = np.concatenate([steps, below, above, [0.0, np.float32(1.0) -
                                              np.float32(2.0 ** -24)],
                        rng.random(4096, dtype=np.float32)])
    u = np.clip(u, 0.0, np.float32(1.0) - np.float32(2.0 ** -24)) \
        .astype(np.float32)
    idx, pdf = lights_mod.pick_light(sc, torch.as_tensor(u))
    want = np.array([_kernel_pick(cdf, x) for x in u])
    assert np.array_equal(idx.numpy(), want)
    # the last i with cdf[i] <= u: at a step u = cdf[i], the light that
    # starts there
    n_rows = cdf.size - 2
    assert all(cdf[i] <= x and (i == n_rows or x < cdf[i + 1])
               for i, x in zip(idx.numpy(), u))
    assert (pdf.numpy() >= 0.0).all()


def test_shade_cuda_refuses_cpu_tensors(scene):
    """The kernel's wrapper takes CUDA tensors only: no fallback."""
    sc, st = scene
    n = st.width * st.height
    lanes = torch.arange(n, dtype=torch.int32)
    w = pt_shade.start(st, lanes, lanes, torch.zeros((n, 3)),
                       torch.zeros((n, 3)), False, False, st.max_depth)
    with pytest.raises(ValueError, match="CUDA"):
        pt_shade.shade_cuda(sc, st, 0, 1, 1, w, torch.zeros(n), lanes - 1)


def _trace(sc, st, lanes, ro, rd, sort, monkeypatch):
    """pt.trace_paths (with its ray count) with the coherence sort on or
    off: pt.DENSE_MAX set below or at the scene's prim count."""
    monkeypatch.setattr(pt, "DENSE_MAX", -1 if sort else st.n_primitives)
    return pt.trace_paths(sc, st, 5, 3, lanes, ro, rd, True)


@pytest.mark.parametrize("shadow_sort", [False, True])
def test_sorted_wavefront_is_the_unsorted_one(scene, shadow_sort,
                                              monkeypatch):
    """The records moving with the coherence sort (read through the
    sort's order, the dead lanes owed a credit through the list) give
    the unsorted wavefront's radiance and rays bit for bit, lane for
    lane, on every scene; at 30^2 the wave is padded to a multiple of 4
    lanes."""
    sc, st = scene
    monkeypatch.setattr(common, "FORCE_SHADOW_SORT", shadow_sort)
    for side in (st.width, 30):
        n = side * side
        ids = torch.arange(n)
        px, py = ids % side, ids // side
        lanes = pt.lane_ids_of(st, px, py)
        rng0 = lane_stream(5, 3, lanes, None, 0, PSS_CAM_DIMS, plain=True)
        ro, rd = common.primary_rays(sc, st, rng0, px, py)
        got = {srt: _trace(sc, st, lanes, ro, rd, srt, monkeypatch)
               for srt in (True, False)}
        assert _bitwise(got[True][0], got[False][0])
        assert int(got[True][1]) == int(got[False][1])
        assert got[True][0].mean() > 0.0


def _int64_sort_key(scene, ro, rd, alive):
    """pt._sort_key as it was in int64."""
    q = torch.clamp(((ro - scene.world_center)
                     / (2.0 * max(scene.world_radius, 1e-6)) + 0.5)
                    * 15.999, 0.0, 15.0).to(torch.int64)
    octant = ((rd > 0.0).to(torch.int64) << torch.arange(3)).sum(-1)
    return torch.where(alive, (octant << 12) | _int64_morton(q, 4), 1 << 20)


def _int64_shadow_key(scene, pos, active):
    """common._shadow_sort_key as it was in int64."""
    q = torch.clamp(((pos - scene.world_center) / (2.0 * scene.world_radius)
                     + 0.5) * 63.999, 0.0, 63.0).to(torch.int64)
    return torch.where(active, _int64_morton(q, 6), 1 << 24)


def _int64_morton(q, bits):
    shift = torch.arange(q.shape[1])
    m = torch.zeros(q.shape[0], dtype=torch.int64)
    for b in range(bits):
        m = m | (((q >> b) & 1) << (q.shape[1] * b + shift)).sum(-1)
    return m


def test_int32_keys_keep_the_int64_order(scene):
    """The wavefront's keys are int32 with the int64 keys' values, so a
    stable sort of either gives the same order (rays from inside and
    outside the scene's sphere, a third of the lanes dead)."""
    sc, st = scene
    rng = np.random.default_rng(11)
    n = 8192
    r = 1.5 * sc.world_radius
    pos = sc.world_center + torch.as_tensor(
        rng.uniform(-r, r, (n, 3)), dtype=torch.float32)
    rd = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    alive = torch.as_tensor(rng.random(n) < 0.67)
    for got, want in ((pt._sort_key(sc, pos, rd, alive),
                       _int64_sort_key(sc, pos, rd, alive)),
                      (common._shadow_sort_key(sc, pos, alive),
                       _int64_shadow_key(sc, pos, alive)),
                      (pt._pixel_key(st, torch.arange(st.width * st.height,
                                                      dtype=torch.int32)),
                       _int64_morton(torch.stack(
                           [torch.arange(st.width * st.height) % st.width,
                            torch.arange(st.width * st.height) // st.width],
                           -1), 10))):
        assert got.dtype == torch.int32
        assert torch.equal(got.long(), want)
        assert torch.equal(torch.sort(got, stable=True).indices,
                           torch.sort(want, stable=True).indices)


@pytest.mark.parametrize("sort", [False, True])
def test_finished_lane_writes_its_slot_once(scene, sort, monkeypatch):
    """A lane with nothing left to add writes its final radiance to its
    caller's slot once, at the bounce it finishes: its slot is unwritten
    (NaN on the CPU) before, holds the radiance the wave ends with after,
    and no later bounce changes it; some lanes finish before the
    epilogue."""
    sc, st = scene
    n = st.width * st.height
    lanes, ro, rd = _primary(sc, st, 5, 3, None)
    snaps = []
    shade = pt_shade.shade

    def spy(scene_, static, b, seed, it, w, *args, **kwargs):
        shade(scene_, static, b, seed, it, w, *args, **kwargs)
        snaps.append(w.out[:n].clone())
    monkeypatch.setattr(pt_shade, "shade", spy)
    _trace(sc, st, lanes, ro, rd, sort, monkeypatch)
    final = snaps[-1]
    assert len(snaps) == st.max_depth + 1
    assert not torch.isnan(final).any()   # every lane wrote its slot
    written = torch.zeros(n, dtype=torch.bool)
    for snap in snaps:
        now = ~torch.isnan(snap).all(-1)
        assert (now | ~written).all() and _bitwise(snap[written],
                                                   final[written])
        written = now
    early = ~torch.isnan(snaps[-2]).all(-1)
    assert early.any() and not early.all()


def _waves(sc, st, sort, monkeypatch):
    """The arguments of every shading step of one spp, the Wave a copy of
    the state before it: {bounce: kwargs}."""
    import chip_smoke
    n = st.width * st.height
    lanes, ro, rd = _primary(sc, st, 5, 3, None)
    got = {}
    shade = pt_shade.shade

    def spy(scene_, static, b, seed, it, w, t, prim, occ=None, psample=None,
            plain=False):
        got[b] = dict(scene=scene_, static=static, b=b, seed=seed,
                      iteration=it, w=chip_smoke.wave_copy(w), t=t,
                      prim=prim, occ=occ, psample=psample)
        return shade(scene_, static, b, seed, it, w, t, prim, occ, psample,
                     plain)
    monkeypatch.setattr(pt_shade, "shade", spy)
    _trace(sc, st, lanes, ro, rd, sort, monkeypatch)
    monkeypatch.undo()
    assert len(got) == st.max_depth + 1 and n > 0
    return got


def test_shade_bound_charges_no_dead_lane(scene, monkeypatch):
    """chip_smoke.py's recounted bound of pt_shade charges a lane only
    where the bounce visits it: at every bounce of the unsorted rows, the
    bound over every lane equals the bound over a wave of the visited
    lanes alone; and a word only where its value changes: with the state
    left as it was, nothing is written but the finished lanes' radiance;
    on the sorted rows, the lanes read are the visited ones."""
    import chip_smoke
    sc, st = scene
    for b, kw in _waves(sc, st, False, monkeypatch).items():
        after = chip_smoke.wave_copy(kw["w"])
        done = pt_shade.shade_wave_torch(**{**kw, "w": after})
        full = chip_smoke.shade_work(kw, after, done)
        _, _, vis = pt_shade.visits(kw["w"], b)
        w = kw["w"]
        sub = dataclasses.replace(
            w, rec=w.rec[vis], ray=w.ray[:, vis], tmax=w.tmax[vis],
            shadow_o=w.shadow_o[vis], shadow_d=w.shadow_d[vis],
            shadow_t=w.shadow_t[vis],
            shadow_key=None if w.shadow_key is None else w.shadow_key[vis])
        kws = {**kw, "w": sub, "t": kw["t"][vis], "prim": kw["prim"][vis],
               "occ": None if kw["occ"] is None else kw["occ"][vis]}
        after_s = chip_smoke.wave_copy(sub)
        done_s = pt_shade.shade_wave_torch(**{**kws, "w": after_s})
        part = chip_smoke.shade_work(kws, after_s, done_s)
        assert (full["read"], full["write"], full["bytes"]) == (
            part["read"], part["write"], part["bytes"]), b
        assert full["visited"] == int(vis.sum()) > 0
        same = chip_smoke.shade_work(kw, kw["w"], done)
        assert same["write"] == int(done.sum()) * 12, b
    for b, kw in _waves(sc, st, True, monkeypatch).items():
        after = chip_smoke.wave_copy(kw["w"])
        done = pt_shade.shade_wave_torch(**{**kw, "w": after})
        work = chip_smoke.shade_work(kw, after, done)
        _, front, vis = pt_shade.visits(kw["w"], b)
        assert work["visited"] == int(vis.sum()) \
            and work["alive"] == int(front.sum()), b
