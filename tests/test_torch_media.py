"""Media parity: the port's density tables, majorants, phase functions,
homogeneous media and tracking walk against the JAX package's, on
scenes/smoke_port (a 100x100x40 smoke grid and a homogeneous HG fog).

The JAX package runs its CPU route (no lane compaction; its K5 lookup
goes through jnp.take). Deterministic functions are held to the JAX
results exactly or at atol 1e-6; the tracking walk draws from other
random numbers than the JAX package's threefry and Poisson counts, so
its means are held to the JAX means within 5 standard errors; and the
lock-step plain walk is held bit for bit to a per-lane loop of the walk
as csrc/track.cu runs it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu_torch.core import rng as trng
from gpu_pathtracer_tpu_torch.core import sampling as ts
from gpu_pathtracer_tpu_torch.scene.flatten import (
    flatten_scene, media_table, replace_media,
)
from gpu_pathtracer_tpu_torch.scene.parse import load_scene
from gpu_pathtracer_tpu_torch.shade import media as tm

SMOKE, FOG = 0, 1   # the media of smoke_port, in file order


@pytest.fixture(scope="module")
def scenes():
    """(port scene, port static, JAX scene, JAX static) of smoke_port."""
    mp = pytest.MonkeyPatch()
    try:
        jd, js = tp.jax_flatten(tp.SMOKE_SCENE, mp)
        td, ts_ = flatten_scene(load_scene(str(tp.SMOKE_SCENE)), "cpu")
    finally:
        mp.undo()
    return td, ts_, jd, js


def _box(td):
    return (td.med_p0[SMOKE].numpy().astype(np.float64),
            td.med_p1[SMOKE].numpy().astype(np.float64))


def _box_rays(td, rng, n, reach=1.0):
    """n rays from outside the smoke box aimed at points inside it, with
    tmax `reach` times the distance to their target's far side."""
    p0, p1 = _box(td)
    c = 0.5 * (p0 + p1)
    target = rng.uniform(p0 + 0.05 * (p1 - p0), p1 - 0.05 * (p1 - p0), (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = target - d * 1.5
    tmax = np.full(n, 1.5 + np.linalg.norm(p1 - c) * reach)
    return (ro.astype(np.float32), d.astype(np.float32),
            tmax.astype(np.float32))


def test_read_density_file_matches_jax():
    from gpu_pathtracer_tpu.film.imageio import read_density_file as jread
    from gpu_pathtracer_tpu_torch.film.imageio import read_density_file
    path = str(tp.SMOKE_SCENE.parent / "density.d")
    got = read_density_file(path, 100, 100, 40)
    ref = jread(path, 100, 100, 40)
    assert got.shape == (40, 100, 100) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert 0.04 < got.mean() < 0.06 and got.max() == 1.0


def test_media_tables_match_jax(scenes):
    td, ts_, jd, js = scenes
    names = [n for n in dir(td) if n.startswith("med_") and n != "med_table"]
    assert len(names) == 12
    for name in names:
        got = getattr(td, name).numpy()
        ref = np.asarray(getattr(jd, name))
        assert got.shape == ref.shape, name
        if name == "med_density_oct4":   # compare the carriers' bits
            got, ref = got.view(np.uint32), ref.view(np.uint32)
        np.testing.assert_array_equal(got, ref.astype(got.dtype),
                                      err_msg=name)
    assert td.med_density_oct4.shape == (2, 41, 101, 101, 4)
    assert td.med_sv_max.shape == (2 * 25 ** 3,)
    # the packed med_table gives the JAX package's per-lane records
    idx = np.array([FOG, SMOKE, -1], np.int32)
    got = tm.gather_medium(td, torch.as_tensor(idx))
    for key, ref in _jax_med(jd, idx).items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref),
                                      err_msg=key)
    for name in ("has_media", "has_hetero", "camera_medium",
                 "med_iter_max"):
        assert getattr(ts_, name) == getattr(js, name), name
    assert ts_.has_hetero and ts_.camera_medium == -1


def _jax_med(jd, idx):
    from gpu_pathtracer_tpu.shade import media as jm
    return jm.gather_medium(jd, jnp.asarray(idx))


def test_density_oct_matches_jax(scenes):
    """4,096 points in and around the grid box, both media."""
    from gpu_pathtracer_tpu.shade import media as jm
    td, _, jd, _ = scenes
    rng = np.random.default_rng(11)
    n = 4096
    pos = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    idx = rng.integers(0, 2, n).astype(np.int32)
    med_n = td.med_n.numpy()[idx]
    got = tm._density_oct(td, torch.as_tensor(idx), torch.as_tensor(med_n),
                          torch.as_tensor(pos))
    ref = jm._density_oct(jd, jnp.asarray(idx), jnp.asarray(med_n),
                          jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    assert (got.numpy() > 0).mean() > 0.2


def test_box_clip_and_segment_majorants_match_jax(scenes):
    """_box_clip and K5's function (_segment_majorants) at 4,096 rays;
    half of them reach well past the box, so segments span more than
    one supervoxel and the global-majorant fallback runs."""
    from gpu_pathtracer_tpu.shade import media as jm
    td, _, jd, _ = scenes
    rng = np.random.default_rng(12)
    n = 4096
    ro, rd, tmax = _box_rays(td, rng, n)
    tmax[n // 2:] *= 6.0
    idx = np.zeros(n, np.int32)
    med = tm.gather_medium(td, torch.as_tensor(idx))
    jmed = _jax_med(jd, idx)
    t0, ln = tm._box_clip(med, torch.as_tensor(ro), torch.as_tensor(rd),
                          torch.as_tensor(tmax))
    jt0, jln = jm._box_clip(jmed, jnp.asarray(ro), jnp.asarray(rd),
                            jnp.asarray(tmax))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(jt0))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jln))
    assert (ln.numpy() > 0).mean() > 0.9

    # from the box entry over the clipped length (local majorants), and
    # over the raw tmax (mostly the global majorant, 1 here)
    ro_h = ro + rd * t0.numpy()[:, None]
    fallback = []
    for o, t in ((ro_h, ln.numpy()), (ro, tmax)):
        got = tm._segment_majorants(td, med, torch.as_tensor(o),
                                    torch.as_tensor(rd), torch.as_tensor(t))
        ref = jm._segment_majorants(jd, jmed, jnp.asarray(o),
                                    jnp.asarray(rd), jnp.asarray(t))
        assert got.shape == (n, tm.NSEG)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        fallback.append((got.numpy() == 1.0).all(1).mean())
    assert fallback[0] < 0.01 and fallback[1] > 0.5, fallback


def _dirs_close(x, y, u2):
    """Directions at atol 1e-6 plus the sine's conditioning, as
    tests/test_torch_core.py::test_sampling_matches_jax: the azimuth's
    sine is +-sqrt(1 - cos^2) in both packages, which turns their 1-ulp
    cosine differences into up to 2.4e-7 |cos / sin| of 2 pi u2."""
    u = u2.astype(np.float64)
    tol = 1e-6 + 2.4e-7 * np.abs(np.cos(2 * np.pi * u) / np.sin(2 * np.pi * u))
    err = np.abs(x.numpy() - np.asarray(y)).max(axis=1)
    assert np.all(err <= tol), err.max()


@pytest.mark.parametrize("g", [0.0, 0.6, -0.3])
def test_phase_functions_match_jax(g):
    from gpu_pathtracer_tpu.core import sampling as js
    from gpu_pathtracer_tpu.shade import media as jm
    from gpu_pathtracer_tpu_torch.shade import media as pm
    rng = np.random.default_rng(13)
    n = 4096
    u1, u2 = rng.random((2, n), dtype=np.float32)
    gg = np.full(n, g, np.float32)
    d, ph = ts.hg_sample(torch.as_tensor(u1), torch.as_tensor(u2),
                         torch.as_tensor(gg))
    jd_, jph = js.hg_sample(jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(gg))
    _dirs_close(d, jd_, u2)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jph), atol=1e-6)
    cos = rng.uniform(-1, 1, n).astype(np.float32)
    np.testing.assert_allclose(
        ts.hg_phase(torch.as_tensor(cos), torch.as_tensor(gg)).numpy(),
        np.asarray(js.hg_phase(jnp.asarray(cos), jnp.asarray(gg))),
        atol=1e-6)

    # sample_phase / phase through a one-medium table with this g
    class Med:   # the two fields sample_phase and phase read
        pass
    _, wi = tp.random_rays(rng, n)
    wo = tp.random_rays(rng, n)[1]
    tmed, jmed = Med(), Med()
    tmed.med_type = torch.zeros(1, dtype=torch.int32)
    tmed.med_g = torch.full((1,), g)
    zeros3 = torch.zeros((1, 3))
    for f in ("med_sigma_a", "med_sigma_s", "med_sigma_t", "med_p0",
              "med_p1"):
        setattr(tmed, f, zeros3)
    tmed.med_n = torch.ones((1, 3), dtype=torch.int32)
    tmed.med_inv_max_density = torch.ones(1)
    tmed.med_eval_tr_type = torch.ones(1, dtype=torch.int32)
    tmed.med_table = media_table(vars(tmed))
    for f in dir(tmed):
        if f.startswith("med_"):
            setattr(jmed, f, jnp.asarray(getattr(tmed, f).numpy()))
    idx = np.zeros(n, np.int32)
    d, ph = pm.sample_phase(tmed, torch.as_tensor(idx), torch.as_tensor(wi),
                            torch.as_tensor(u1), torch.as_tensor(u2))
    jd_, jph = jm.sample_phase(jmed, jnp.asarray(idx), jnp.asarray(wi),
                               jnp.asarray(u1), jnp.asarray(u2))
    _dirs_close(d, jd_, u2)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jph), atol=1e-6)
    np.testing.assert_allclose(
        pm.phase(tmed, torch.as_tensor(idx), torch.as_tensor(wi),
                 torch.as_tensor(wo)).numpy(),
        np.asarray(jm.phase(jmed, jnp.asarray(idx), jnp.asarray(wi),
                            jnp.asarray(wo))), atol=1e-6)


def _key(n, tag=trng.track_tag(0, trng.TRACK_SAMPLE)):
    return tm.TrackKey(5, 1, torch.arange(n), tag)


def test_homogeneous_media_match_jax(scenes):
    """Distance sampling and Tr in the fog, fed the JAX package's own u0
    (drawn as at media.py:519)."""
    from gpu_pathtracer_tpu.shade import media as jm
    td, tst, jd, jst = scenes
    rng = np.random.default_rng(14)
    n = 4096
    ro, rd = tp.random_rays(rng, n)
    tmax = rng.uniform(0.0, 3.0, n).astype(np.float32)
    idx = np.where(rng.random(n) < 0.8, FOG, -1).astype(np.int32)
    act = rng.random(n) < 0.9
    key = jax.random.PRNGKey(9)
    u0 = np.array(jax.random.uniform(jax.random.fold_in(key, 0), (n,)))
    args = [torch.as_tensor(a) for a in (idx, ro, rd, tmax)]
    jargs = [jnp.asarray(a) for a in (idx, ro, rd, tmax)]
    w, t, smp = tm.medium_sample(td, tst, *args, torch.as_tensor(u0),
                                 _key(n), torch.as_tensor(act))
    jw, jt, jsmp = jm.medium_sample(jd, jst, *jargs, key, jnp.asarray(act))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(smp.numpy(), np.asarray(jsmp))
    assert 0.2 < smp.numpy().mean() < 0.8
    tr = tm.medium_tr_segment(td, tst, *args, _key(n),
                              torch.as_tensor(act))
    jtr = jm.medium_tr_segment(jd, jst, *jargs, key, jnp.asarray(act))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), atol=1e-6)


def _plume_rays(td, n):
    """n copies of one ray through the plume's lower part."""
    p0, p1 = _box(td)
    a = p0 + (p1 - p0) * np.array([0.0, 0.25, 0.5])
    b = p0 + (p1 - p0) * np.array([1.0, 0.35, 0.5])
    d = (b - a) / np.linalg.norm(b - a)
    ro = np.broadcast_to(a - 0.2 * d, (n, 3)).astype(np.float32)
    rd = np.broadcast_to(d, (n, 3)).astype(np.float32)
    return ro, rd, np.full(n, np.linalg.norm(b - a) + 0.4, np.float32)


def _with_ett(scene, ett, jax_side):
    if jax_side:
        return scene.replace(med_eval_tr_type=jnp.full_like(
            scene.med_eval_tr_type, ett))
    return replace_media(scene, med_eval_tr_type=torch.full_like(
        scene.med_eval_tr_type, ett))


def _mean_se(x):
    x = np.asarray(x, np.float64)
    return x.mean(), x.std() / np.sqrt(x.size)


def test_heterogeneous_tr_and_escape_match_jax(scenes):
    """Mean Tr by delta, ratio and residual-ratio tracking, and the
    escape probability of distance sampling, on 16,384 lanes, each
    within 5 standard errors of the JAX package's."""
    from gpu_pathtracer_tpu.shade import media as jm
    td, tst, jd, jst = scenes
    n = 16384
    ro, rd, tmax = _plume_rays(td, n)
    idx = np.full(n, SMOKE, np.int32)
    act = np.ones(n, bool)
    args = [torch.as_tensor(a) for a in (idx, ro, rd, tmax)]
    jargs = [jnp.asarray(a) for a in (idx, ro, rd, tmax)]
    means = {}
    for ett in (0, 1, 2):
        tr = tm.medium_tr_segment(
            _with_ett(td, ett, False), tst, *args,
            _key(n, trng.track_tag(0, trng.TRACK_SURFACE)),
            torch.as_tensor(act))[:, 0].numpy()
        jtr = np.asarray(jm.medium_tr_segment(
            _with_ett(jd, ett, True), jst, *jargs,
            jax.random.PRNGKey(20 + ett), jnp.asarray(act)))[:, 0]
        (m, se), (jmn, jse) = _mean_se(tr), _mean_se(jtr)
        means[ett] = m
        assert abs(m - jmn) <= 5 * np.hypot(se, jse) + 1e-7, (ett, m, jmn)
    assert 0.05 < means[1] < 0.9, means   # the ray sees real smoke
    _, _, smp = tm.medium_sample(td, tst, *args, torch.zeros(n), _key(n),
                                 torch.as_tensor(act))
    _, _, jsmp = jm.medium_sample(jd, jst, *jargs, jax.random.PRNGKey(30),
                                  jnp.asarray(act))
    (e, se), (je, jse) = _mean_se(~smp.numpy()), _mean_se(~np.asarray(jsmp))
    assert abs(e - je) <= 5 * np.hypot(se, jse), (e, je)
    assert abs(e - means[1]) <= 5 * se + 0.01, (e, means)


def test_missed_box_is_free(scenes):
    """Rays that miss the smoke box: Tr exactly 1, no candidate drawn."""
    td, tst, _, _ = scenes
    n = 1024
    p0, p1 = _box(td)
    ro = np.broadcast_to(np.array([0.5, 1.0, 0.5]), (n, 3)).astype(np.float32)
    rd = np.broadcast_to(np.array([0.0, 1.0, 0.0]), (n, 3)).astype(np.float32)
    for mode in (tm.MODE_SAMPLE, tm.MODE_TR):
        out, cand = tm.track(td, tst, mode, torch.zeros(n, dtype=torch.int32),
                             torch.as_tensor(ro), torch.as_tensor(rd),
                             torch.full((n,), 5.0), _key(n))
        assert (cand == 0).all()
        assert (out == (torch.inf if mode == tm.MODE_SAMPLE else 1.0)).all()


def _scalar_walk(td, iter_max, mode, k, ro, rd, tmax, key, lane):
    """One lane's walk as csrc/track.cu runs it, every operation on
    float32 scalars: one exponential optical depth per candidate (draw 0
    at the start, draw j right after candidate j - 1), carried across
    segment boundaries. Returns (out, candidates, draws)."""
    f = lambda x: torch.tensor([x], dtype=torch.float32)  # noqa: E731
    med = tm.gather_medium(td, torch.tensor([k]))
    inf_or_one = torch.inf if mode == tm.MODE_SAMPLE else 1.0
    if k < 0 or int(med["type"]) != tm.HETEROGENEOUS:
        return inf_or_one, 0, 0
    ro, rd = ro[None], rd[None]
    t0, ln = tm._box_clip(med, ro, rd, tmax[None])
    ro_h = ro + rd * t0[:, None]
    maj = tm._segment_majorants(td, med, ro_h, rd, ln)[0]
    maxd = 1.0 / torch.clamp_min(med["inv_max_density"], 1e-30)
    ce = 0.5 * maxd
    sigma, ett = med["sigma"], int(med["ett"])
    span = torch.clamp_min(med["p1"] - med["p0"], 1e-30)
    residual = mode == tm.MODE_TR and ett == 2
    seg_len = tm._seg_len(ln)
    out, tr, nc, j = inf_or_one, f(1.0), 0, 0

    def draw(j):
        w = trng.track_words(key.seed, key.iteration, torch.tensor([lane]),
                             key.tag, j)
        return (-torch.log(1.0 - trng.bits_to_uniform(w[0])),
                trng.bits_to_uniform(w[1]), trng.bits_to_uniform(w[2]))

    if ln.item() > 0.0:
        t, s = f(0.0), 0
        (tau, u_acc, u_rr), j = draw(0), 1
        while True:
            m = maj[s:s + 1]
            rate = torch.maximum(m, ce) if residual else m
            lam = sigma * rate
            s_end = f(float(s + 1)) * seg_len
            depth = lam * (s_end - t)
            if not tau.item() < depth.item():
                tau, t, s = tau - depth, s_end, s + 1
                if s == tm.NSEG:
                    break
                continue
            t = torch.minimum(t + tau / lam, s_end)
            nc += 1
            pos_norm = (ro_h + rd * t[:, None] - med["p0"]) / span
            dens = tm._density_oct(td, torch.tensor([k], dtype=torch.int32),
                                   med["n"], pos_norm)
            hit = (dens > u_acc * m).item()
            if mode == tm.MODE_SAMPLE:
                if hit:
                    out = (t0 + t).item()
                    break
            else:
                if ett == 0:
                    tr = f(0.0) if hit else tr
                elif ett == 1:
                    tr = tr * (1.0 - dens / torch.clamp_min(m, 1e-30))
                else:
                    tr = tr * (1.0 - (dens - ce)
                               / torch.clamp_min(rate, 1e-30))
                if ett != 0 and 0.0 <= tr.item() < f(0.1).item():
                    tr = f(0.0) if (u_rr < 1.0 - tr).item() else f(1.0)
                if tr.item() == 0.0:
                    break
            if j >= iter_max:
                break
            (tau, u_acc, u_rr), j = draw(j), j + 1
    if mode == tm.MODE_TR:
        out = (tr * torch.exp(-ln * ce * sigma)).item() if residual \
            else tr.item()
    return out, nc, j


@pytest.mark.parametrize("cap", [None, 1, 3])
@pytest.mark.parametrize("mode, ett", [(tm.MODE_SAMPLE, 1), (tm.MODE_TR, 0),
                                       (tm.MODE_TR, 1), (tm.MODE_TR, 2)])
def test_lockstep_walk_equals_scalar_walk(scenes, mode, ett, cap):
    """The plain lock-step walk equals the per-lane scalar walk (the one
    csrc/track.cu mirrors) bit for bit on 64 lanes: rays through the
    plume, rays that miss the box, lanes in the fog, vacuum lanes; under
    the scene's candidate cap (med_iter_max) and under caps of 1 and 3,
    which no lane passes."""
    td, tst, _, _ = scenes
    td = _with_ett(td, ett, False)
    if cap is not None:
        tst = dataclasses.replace(tst, med_iter_max=cap)
    rng = np.random.default_rng(40 + ett)
    n = 64
    ro, rd, tmax = _box_rays(td, rng, n)
    ro[:8] = ro[:8] + np.array([0.0, 0.0, 3.0], np.float32)   # misses
    tmax[8:16] *= 0.5                                          # stops inside
    idx = np.full(n, SMOKE, np.int32)
    idx[16:20], idx[20:24] = FOG, -1
    key = tm.TrackKey(3, 2, torch.arange(100, 100 + n),
                      trng.track_tag(4, trng.TRACK_SCATTER, 2))
    out, cand = tm.track(td, tst, mode, torch.as_tensor(idx),
                         torch.as_tensor(ro), torch.as_tensor(rd),
                         torch.as_tensor(tmax), key)
    for i in range(n):
        ref, nc, nj = _scalar_walk(td, tst.med_iter_max, mode, int(idx[i]),
                                   torch.as_tensor(ro[i]),
                                   torch.as_tensor(rd[i]),
                                   torch.as_tensor(tmax[i]), key, 100 + i)
        assert out[i].item() == ref or (np.isnan(ref) and
                                        np.isnan(out[i].item())), (i, ref)
        assert cand[i].item() == nc, (i, nc)
        # one draw per candidate, plus at most the one that outlasts the
        # last segment
        assert nc <= nj <= nc + 1, (i, nc, nj)
    assert int(cand.max()) <= tst.med_iter_max
    if cap is not None:   # the cap is reached
        assert int(cand.max()) == cap
    assert (cand[24:] > 0).float().mean() > 0.5
    if mode == tm.MODE_SAMPLE:
        assert torch.isfinite(out).any()


@pytest.mark.parametrize("mode, ett", [(tm.MODE_SAMPLE, 1), (tm.MODE_TR, 0),
                                       (tm.MODE_TR, 1), (tm.MODE_TR, 2)])
def test_per_lane_sites_merge_single_tag_walks(scenes, mode, ett):
    """A walk with a per-lane call site (TrackKey.sites: the VPT step's
    one walk for its scatter, surface and emitter lanes) equals, lane for
    lane and bit for bit, the walks of each call site alone merged by
    lane: lane i draws at tag | (sites[i] << 4)."""
    td, tst, _, _ = scenes
    td = _with_ett(td, ett, False)
    rng = np.random.default_rng(70 + ett)
    n = 96
    ro, rd, tmax = _box_rays(td, rng, n)
    idx = np.full(n, SMOKE, np.int32)
    idx[:8] = -1
    ro, rd, tmax, idx = (torch.as_tensor(x) for x in (ro, rd, tmax, idx))
    lanes = torch.arange(500, 500 + n)
    sites = torch.as_tensor(rng.choice(
        [trng.TRACK_SCATTER, trng.TRACK_SURFACE, trng.TRACK_EMITTER], n)
        .astype(np.int32))
    base = trng.track_tag(3, 0, 2)
    out, cand = tm.track(td, tst, mode, idx, ro, rd, tmax,
                         tm.TrackKey(7, 4, lanes, base, sites))
    for site in (trng.TRACK_SCATTER, trng.TRACK_SURFACE, trng.TRACK_EMITTER):
        o1, c1 = tm.track(td, tst, mode, idx, ro, rd, tmax,
                          tm.TrackKey(7, 4, lanes, trng.track_tag(3, site, 2)))
        sel = sites == site
        assert torch.equal(out[sel].view(torch.int32),
                           o1[sel].view(torch.int32)), site
        assert torch.equal(cand[sel], c1[sel]), site
    assert int(cand.sum()) > 0 and int(cand[:8].sum()) == 0


def _constant_smoke(td, ett, dens, maj=0.25, imd=8.0):
    """smoke_port's media at a constant density `dens` under a constant
    supervoxel majorant `maj` (both exact in bf16), global majorant
    1 / imd (the residual-ratio control ce = 0.5 / imd), estimator
    `ett`."""
    bits = int(np.float32(dens).view(np.uint32)) >> 16
    carrier = float(np.uint32((bits << 16) | bits).view(np.float32))
    return replace_media(
        td, med_density_oct4=torch.full_like(td.med_density_oct4, carrier),
        med_sv_max=torch.full_like(td.med_sv_max, maj),
        med_inv_max_density=torch.full_like(td.med_inv_max_density, imd),
        med_eval_tr_type=torch.full_like(td.med_eval_tr_type, ett))


@pytest.mark.parametrize("mode, ett", [(tm.MODE_SAMPLE, 1), (tm.MODE_TR, 0),
                                       (tm.MODE_TR, 1), (tm.MODE_TR, 2)])
def test_carried_depth_walk_matches_closed_forms(scenes, mode, ett):
    """The walk's Poisson process (one exponential per candidate, carried
    across the 42 segment boundaries) against closed forms, on 8,192 rays
    through the smoke box at constant density d = 1/32 under majorant
    1/4, sigma 15, chords L up to 2.3:
    - Tr of delta, ratio and residual-ratio tracking: Beer-Lambert
      exp(-sigma d L);
    - candidates of ratio and residual ratio (no early stop: their
      factors stay >= 0.875^n, roulette below 0.1 takes n >= 18 at a mean
      of at most 8.6): sigma rate L, rate the majorant (residual ratio:
      max(majorant, ce));
    - delta and sample mode, which stop at the first real collision:
      candidates (rate / d)(1 - exp(-sigma d L)), and in sample mode the
      free path min(x, L) from the box entry (1 - exp(-sigma d L)) /
      (sigma d).
    Tolerance: the mean over lanes of (lane value - its lane's closed
    form) within 5 standard errors of 0."""
    td, tst, _, _ = scenes
    d = 1.0 / 32.0
    sc = _constant_smoke(td, ett, d)
    rng = np.random.default_rng(50 + 4 * mode + ett)
    n = 8192
    ro, rd, tmax = _box_rays(td, rng, n)
    idx = torch.full((n,), SMOKE, dtype=torch.int32)
    ro, rd, tmax = (torch.as_tensor(a) for a in (ro, rd, tmax))
    key = tm.TrackKey(7, 3, torch.arange(n),
                      trng.track_tag(1, trng.TRACK_SURFACE))
    out, cand = tm.track(sc, tst, mode, idx, ro, rd, tmax, key)
    med = tm.gather_medium(sc, idx)
    t0, ln = tm._box_clip(med, ro, rd, tmax)
    maj = tm._segment_majorants(sc, med, ro + rd * t0[:, None], rd, ln)
    assert (maj == maj[:, :1]).all()   # one majorant per lane
    rate = maj[:, 0]
    if mode == tm.MODE_TR and ett == 2:
        rate = torch.maximum(rate, 0.5 / med["inv_max_density"])
    f64 = lambda x: x.numpy().astype(np.float64)  # noqa: E731
    sigma, L, rate = f64(med["sigma"]), f64(ln), f64(rate)
    beer = np.exp(-sigma * d * L)
    assert (L > 0).mean() > 0.99 and 0.3 < beer.mean() < 0.9

    def close(x, ref, what):
        m, se = _mean_se(np.asarray(x, np.float64) - ref)
        assert abs(m) <= 5 * se, (what, m, se)

    cand = f64(cand)
    if mode == tm.MODE_TR:
        close(f64(out), beer, "Tr")
    if mode == tm.MODE_TR and ett != 0:
        close(cand, sigma * rate * L, "candidates")
    else:
        close(cand, rate / d * (1.0 - beer), "candidates")
    if mode == tm.MODE_SAMPLE:
        out = f64(out)
        free = np.where(np.isfinite(out), out - f64(t0), L)
        close(free, (1.0 - beer) / (sigma * d), "free path")
        assert 0.1 < np.isfinite(out).mean() < 0.7
