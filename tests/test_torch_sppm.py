"""SPPM: the port's integrators/sppm.py against the JAX package's, on the
CPU, cornell_port at 32x32, depth 5.

Each pass is fed the same inputs in both packages: the eye pass and the
photon pass draw rows of one explicit matrix (the JAX module's `jax` and
`RngStream` names replaced as in test_torch_ir.py), and the later passes
start from the JAX package's state carried across
(`sppm.state_from_numpy`).
- The eye pass lane by lane: every visible-point field within atol
  1e-5 + rtol 1e-4 on >= 99% of pixels, the same pixels valid; on
  materials.json, where paths walk through delta and glossy hits, within
  atol 1e-4 + rtol 1e-3.
- `build_grid`: sorted_vp and bucket_start exactly equal, at the first
  radius and at scattered radii.
- The photon pass (8,192 photons) at scattered radii (0.05-0.2): phi
  and m within rtol 1e-4 on >= 99% of the visible points (the JAX
  package adds a point's deposits in another order: photons sorted by
  bucket length). At the first radius (0.5) the grid is 6 x 6 x 5
  cells of 0.5 from bmin = -1.5, so the walls at x = +-1 and the floor
  lie exactly on cell boundaries, where a last-bit difference of the
  two packages' float32 (their sin, cos and sqrt) puts a photon in the
  neighbouring cell: 5 of 7,121 depositing photons at bounce 1, each
  then sampling K_CAP other entries of a bucket of up to 398. That
  moves m on about a third of the points, so there the totals of phi
  and m are held, within 2e-3.
- `density_pass` lane by lane within atol 1e-6 + rtol 1e-5.
- 8 iterations at 8,192 photons against the port's own path tracer: the
  image mean within 0.8-1.2 of PT's, and the radius shrinking, as
  tests/test_integrators.py holds the JAX package's SPPM.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.integrators import sppm as jsppm
from gpu_pathtracer_tpu_torch.core.rng import PSS_CAM_DIMS
from gpu_pathtracer_tpu_torch.integrators import sppm as tsppm
from gpu_pathtracer_tpu_torch.run.renderer import Renderer
from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
from test_torch_ir import row_streams
from test_torch_vpt import _host

SIZE = 32
N_PIX = SIZE * SIZE
N_PHOTONS = 8192
VP_FIELDS = ("ld", "beta", "dir", "pos", "nor", "uv", "dpdu")


def _numpy(state):
    return {f: np.asarray(getattr(state, f))
            for f in state.__dataclass_fields__}


@pytest.fixture(scope="module")
def passes():
    """The JAX package's eye pass and photon pass of iteration 1 from
    explicit matrices, and the port's eye pass on the same rows."""
    mp = pytest.MonkeyPatch()
    try:
        jd, js = tp.jax_flatten(tp.PORT_SCENES["cornell"], mp, size=SIZE)
        td, ts = tp.port_scene_from_jax(jd, js)
        rng = np.random.default_rng(31)
        u_eye = rng.random((PSS_CAM_DIMS + tsppm.SPPM_EYE_DIMS
                            * js.max_depth, N_PIX), dtype=np.float32)
        u_ph = rng.random((tsppm.PHOTON_EMIT_DIMS + tsppm.PHOTON_BOUNCE_DIMS
                           * js.max_depth, N_PHOTONS), dtype=np.float32)
        px = np.arange(N_PIX, dtype=np.int32) % SIZE
        py = np.arange(N_PIX, dtype=np.int32) // SIZE
        s0 = jsppm.init_state(N_PIX, js.init_radius)
        fake_jax, stream = row_streams(u_eye, PSS_CAM_DIMS,
                                       tsppm.SPPM_EYE_DIMS)
        mp.setattr(jsppm, "jax", fake_jax)
        mp.setattr(jsppm, "RngStream", stream)
        sj = jsppm.eye_pass(jd, js, 0, jnp.asarray(px), jnp.asarray(py), s0,
                            jnp.int32(1))
        grid = jsppm.build_grid(sj, N_PIX)
        fake_jax, stream = row_streams(u_ph, tsppm.PHOTON_EMIT_DIMS,
                                       tsppm.PHOTON_BOUNCE_DIMS)
        mp.setattr(jsppm, "jax", fake_jax)
        mp.setattr(jsppm, "RngStream", stream)
        phi, m = jsppm.photon_pass(jd, js, 0, sj, grid, N_PHOTONS, N_PIX)
    finally:
        mp.undo()
    st0 = tsppm.init_state(N_PIX, ts.init_radius, "cpu")
    st, rays = tsppm.eye_pass(td, ts, 0, 1, torch.as_tensor(px),
                              torch.as_tensor(py), st0,
                              psample=torch.as_tensor(u_eye))
    return dict(td=td, ts=ts, td_j=jd, ts_j=js, sj=sj, st=st, rays=rays,
                phi=np.asarray(phi), m=np.asarray(m), u_ph=u_ph)


def test_eye_pass_matches_jax(passes):
    sj, st = _numpy(passes["sj"]), passes["st"]
    np.testing.assert_array_equal(st.valid.numpy(), sj["valid"])
    assert sj["valid"].mean() > 0.9
    for name in VP_FIELDS:
        ok = tp.close_lanes(getattr(st, name).numpy(), sj[name], atol=1e-5,
                            rtol=1e-4)
        assert ok.mean() >= 0.99, (name, ok.mean())
    assert (st.mat_idx.numpy() == sj["mat_idx"]).mean() >= 0.99
    assert np.all(st.radius.numpy() == np.float32(passes["ts"].init_radius))
    assert sj["ld"].mean() > 0.01
    # closest hits, NEE shadow rays and BSDF-sample hits
    assert 3 * N_PIX * passes["ts"].max_depth >= int(passes["rays"]) > N_PIX


def test_eye_pass_walks_like_jax(monkeypatch):
    """materials.json (mirror, glass, rough metal and substrate spheres):
    the eye pass walks through delta and low-alpha glossy hits before it
    parks; the visible points within atol 1e-4 + rtol 1e-3 on >= 99% of
    pixels (a float32 difference through a delta bounce moves a lane
    more)."""
    jd, js = tp.jax_flatten(tp.PORT_SCENES["materials"], monkeypatch,
                            size=SIZE)
    td, ts = tp.port_scene_from_jax(jd, js)
    u = np.random.default_rng(33).random(
        (PSS_CAM_DIMS + tsppm.SPPM_EYE_DIMS * js.max_depth, N_PIX),
        dtype=np.float32)
    px = np.arange(N_PIX, dtype=np.int32) % SIZE
    py = np.arange(N_PIX, dtype=np.int32) // SIZE
    fake_jax, stream = row_streams(u, PSS_CAM_DIMS, tsppm.SPPM_EYE_DIMS)
    monkeypatch.setattr(jsppm, "jax", fake_jax)
    monkeypatch.setattr(jsppm, "RngStream", stream)
    sj = _numpy(jsppm.eye_pass(jd, js, 0, jnp.asarray(px), jnp.asarray(py),
                               jsppm.init_state(N_PIX, js.init_radius),
                               jnp.int32(1)))
    st, _ = tsppm.eye_pass(td, ts, 0, 1, torch.as_tensor(px),
                           torch.as_tensor(py),
                           tsppm.init_state(N_PIX, ts.init_radius, "cpu"),
                           psample=torch.as_tensor(u))
    assert (st.valid.numpy() == sj["valid"]).mean() >= 0.99
    both = st.valid.numpy() & sj["valid"]
    for name in VP_FIELDS:
        ok = tp.close_lanes(getattr(st, name).numpy()[both], sj[name][both],
                            atol=1e-4, rtol=1e-3)
        assert ok.mean() >= 0.99, (name, ok.mean())
    # some paths walked: their throughput is not 1
    assert (np.abs(sj["beta"][both] - 1.0) > 1e-3).any()


def _radii(arrays, radii):
    """The visible points' radii: the first (as the eye pass leaves
    them) or scattered over 0.05-0.2."""
    if radii == "scattered":
        arrays["radius"] = np.random.default_rng(32).uniform(
            0.05, 0.2, N_PIX).astype(np.float32)
    return arrays


@pytest.mark.parametrize("radii", ["first", "scattered"])
def test_build_grid_matches_jax(passes, radii):
    arrays = _radii(_numpy(passes["sj"]), radii)
    grid_j = jsppm.build_grid(jsppm.SppmState(
        **{k: jnp.asarray(v) for k, v in arrays.items()}), N_PIX)
    grid_t = tsppm.build_grid(tsppm.state_from_numpy(arrays, "cpu"), N_PIX)
    for name, a, b in zip(("sorted_vp", "bucket_start", "bmin", "bmax",
                           "res"), grid_t, grid_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    n_entries = int(np.asarray(grid_j[1])[-1])   # entries before the pad
    assert N_PIX <= n_entries <= 27 * N_PIX
    if radii == "scattered":
        assert int(np.asarray(grid_j[4]).min()) > 8


@pytest.mark.parametrize("radii", ["first", "scattered"])
def test_photon_pass_matches_jax(passes, radii, monkeypatch):
    arrays = _radii(_numpy(passes["sj"]), radii)
    sj = jsppm.SppmState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    grid_j = jsppm.build_grid(sj, N_PIX)
    fake_jax, stream = row_streams(passes["u_ph"], tsppm.PHOTON_EMIT_DIMS,
                                   tsppm.PHOTON_BOUNCE_DIMS)
    monkeypatch.setattr(jsppm, "jax", fake_jax)
    monkeypatch.setattr(jsppm, "RngStream", stream)
    pj, mj = (np.asarray(x) for x in jsppm.photon_pass(
        passes["td_j"], passes["ts_j"], 0, sj, grid_j, N_PHOTONS, N_PIX))
    state = tsppm.state_from_numpy(arrays, "cpu")
    grid = tuple(torch.as_tensor(np.array(g)) for g in grid_j)
    phi, m, rays = tsppm.photon_pass(
        passes["td"], passes["ts"], 0, 1, state, grid, N_PHOTONS, N_PIX,
        psample=torch.as_tensor(passes["u_ph"]))
    valid = state.valid.numpy()
    pj, mj = pj[valid], mj[valid]
    pt_, mt = phi.numpy()[valid], m.numpy()[valid]
    assert (mj > 0).mean() > 0.9
    assert N_PHOTONS <= int(rays) <= N_PHOTONS * passes["ts"].max_depth
    if radii == "first":
        np.testing.assert_allclose(mt.sum(), mj.sum(), rtol=2e-3)
        np.testing.assert_allclose(pt_.sum(0), pj.sum(0), rtol=2e-3)
        return
    ok = np.all(np.abs(pt_ - pj) <= 1e-4 * np.abs(pj), axis=1) \
        & (np.abs(mt - mj) <= 1e-4 * np.abs(mj))
    assert ok.mean() >= 0.99, ok.mean()


def test_density_pass_matches_jax(passes):
    arrays = _numpy(passes["sj"])
    phi, m = np.array(passes["phi"]), np.array(passes["m"])
    sj, lj = jsppm.density_pass(passes["sj"], jnp.asarray(phi),
                                jnp.asarray(m), jnp.int32(1), N_PHOTONS)
    st, lt = tsppm.density_pass(tsppm.state_from_numpy(arrays, "cpu"),
                                torch.as_tensor(phi), torch.as_tensor(m), 1,
                                N_PHOTONS)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-6,
                               rtol=1e-5)
    for name in ("radius", "tau", "n", "ind"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), atol=1e-6,
                                   rtol=1e-5, err_msg=name)
    assert (st.radius < passes["ts"].init_radius).any()


def test_sppm_matches_pt():
    host = _host(tp.PORT_SCENES["cornell"], SIZE)
    r = Renderer(host, device="cpu", integrator=IntegratorType.SPPM,
                 max_depth=5, photons_per_iteration=N_PHOTONS)
    r.render(8)
    b = r.radiance()
    valid = r._sppm_state.valid
    radius = r._sppm_state.radius
    r_pt = Renderer(host, seed=1, device="cpu", integrator=IntegratorType.PT,
                    max_depth=5)
    r_pt.render(16)
    a = r_pt.radiance()
    assert r.kind == "sppm" and np.isfinite(b).all()
    assert 0.8 < b.mean() / a.mean() < 1.2, b.mean() / a.mean()
    assert (radius[valid] < r.static.init_radius).any()
    assert (radius > 0).all()
    assert r.image().shape == (SIZE, SIZE, 3)
