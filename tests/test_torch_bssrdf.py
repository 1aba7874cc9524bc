"""Dipole BSSRDF: the port's shade/bssrdf.py and the path tracer's
subsurface hook against the JAX package, on the CPU.

- The host-side conversion (`fdr`, `convert_from_diffuse`) and the
  batched pieces (`dipole_A`, `rd`, `sample_probe_ray`, the exponential
  and Gaussian-disk warps) on numpy-seeded inputs: atol 1e-6 + rtol
  1e-5 (float32 with the same formulas: a few ulp of exp / log apart).
- `single_scatter` and `multiple_scatter` lane by lane on the hits of
  cornell_port/bssrdf.json's primary rays, both packages drawing rows of
  one explicit matrix: atol 1e-4 + rtol 1e-3 on >= 99% of lanes.
- The path tracer on bssrdf.json as a whole within 5 standard errors
  (the two packages draw from different generators; the rule of
  test_torch_vpt.py).
The flattened BSSRDF table and prim column 32 are held equal to the JAX
package's in test_torch_scene.py (the "bssrdf" scene).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.core import sampling as jsampling
from gpu_pathtracer_tpu.core.rng import PrimarySampleStream as JStream
from gpu_pathtracer_tpu.geom import traverse as jtraverse
from gpu_pathtracer_tpu.shade import bssrdf as jb
from gpu_pathtracer_tpu_torch.core import sampling as tsampling
from gpu_pathtracer_tpu_torch.core.rng import PrimarySampleStream as TStream
from gpu_pathtracer_tpu_torch.geom import traverse as ttraverse
from gpu_pathtracer_tpu_torch.shade import bssrdf as tb
from test_torch_vpt import _assert_same_estimate, _frames_jax, _frames_port

N = 4096
SIZE = 32


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    nor = rng.normal(size=(N, 3))
    nor /= np.linalg.norm(nor, axis=1, keepdims=True)
    return dict(
        u1=rng.random(N, dtype=np.float32), u2=rng.random(N, dtype=np.float32),
        d2=rng.uniform(0.0, 0.05, N).astype(np.float32),
        sa=rng.uniform(0.1, 3.0, (N, 3)).astype(np.float32),
        sp=rng.uniform(5.0, 60.0, (N, 3)).astype(np.float32),
        eta=rng.uniform(0.7, 1.8, N).astype(np.float32),
        fall=rng.uniform(1.0, 40.0, N).astype(np.float32),
        x=rng.uniform(0.0, 0.3, N).astype(np.float32),
        pos=rng.uniform(-1, 1, (N, 3)).astype(np.float32),
        nor=nor.astype(np.float32))


def _rmax(d):
    return np.sqrt(np.log(0.01) / -d["fall"]).astype(np.float32)


CASES = {
    "dipole_A": lambda m, d, a: m.dipole_A(a(d["eta"])),
    "rd": lambda m, d, a: m.rd(a(d["d2"]), a(d["sa"]), a(d["sp"]),
                               m.dipole_A(a(d["eta"]))[:, None]),
    "sample_probe_ray": lambda m, d, a: m.sample_probe_ray(
        a(d["pos"]), a(d["nor"]), a(d["u1"]), a(d["u2"]), a(d["fall"]),
        a(_rmax(d))),
}
WARPS = {
    "exponential": lambda m, d, a: m.exponential(a(d["u1"]), a(d["fall"])),
    "exponential_pdf": lambda m, d, a: m.exponential_pdf(a(d["x"]),
                                                         a(d["fall"])),
    "gaussian_disk": lambda m, d, a: m.gaussian_disk(
        a(d["u1"]), a(d["u2"]), a(d["fall"]), a(_rmax(d))),
    "gaussian_disk_pdf": lambda m, d, a: m.gaussian_disk_pdf(
        a(d["x"]), a(d["x"][::-1].copy()), a(d["fall"]), a(_rmax(d))),
    "gaussian_disk_infinity": lambda m, d, a: m.gaussian_disk_infinity(
        a(d["u1"]), a(d["u2"]), a(d["fall"])),
    "gaussian_disk_infinity_pdf": lambda m, d, a: m.gaussian_disk_infinity_pdf(
        a(d["x"]), a(d["x"][::-1].copy()), a(d["fall"])),
}


def _close(t, j):
    if isinstance(t, tuple):
        for x, y in zip(t, j):
            _close(x, y)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bssrdf_pieces_match_jax(case, data):
    _close(CASES[case](tb, data, torch.as_tensor),
           CASES[case](jb, data, jnp.asarray))


@pytest.mark.parametrize("case", sorted(WARPS))
def test_bssrdf_warps_match_jax(case, data):
    _close(WARPS[case](tsampling, data, torch.as_tensor),
           WARPS[case](jsampling, data, jnp.asarray))


@pytest.mark.parametrize("eta", [0.8, 1.3, 1.5])
def test_convert_from_diffuse_matches_jax(eta):
    kd = np.array([0.85, 0.4, 0.05], np.float32)
    assert tb.fdr(eta) == jb.fdr(eta)
    t = tb.convert_from_diffuse(kd, 0.05, eta, 0.2)
    j = jb.convert_from_diffuse(kd, 0.05, eta, 0.2)
    np.testing.assert_array_equal(t.sigmaA, j.sigmaA)
    np.testing.assert_array_equal(t.sigmaSP, j.sigmaSP)
    assert (t.eta, t.g) == (j.eta, j.g) and (t.sigmaSP > 0).all()


@pytest.fixture(scope="module")
def bssrdf_hits():
    """Both packages' closest hits of bssrdf.json's 32x32 pixel-centre
    primary rays on the JAX package's tables."""
    from gpu_pathtracer_tpu.shade import camera as jcam
    mp = pytest.MonkeyPatch()
    try:
        jd, js = tp.jax_flatten(tp.BSSRDF_SCENE, mp, size=SIZE)
    finally:
        mp.undo()
    td, ts = tp.port_scene_from_jax(jd, js)
    ids = np.arange(SIZE * SIZE)
    x = (ids % SIZE + 0.5).astype(np.float32)
    y = (ids // SIZE + 0.5).astype(np.float32)
    ro, rd = jcam.generate_primary_ray(jd.camera, jnp.asarray(x),
                                       jnp.asarray(y),
                                       jnp.zeros((ids.size, 2)), False)
    ro, rd = np.array(ro), np.array(rd)   # writable copies
    tmax = np.full(ids.size, np.inf, np.float32)
    jh = jtraverse.intersect_closest(jd, js, jnp.asarray(ro), jnp.asarray(rd),
                                     jd.epsilon, jnp.asarray(tmax))
    th = ttraverse.intersect_closest(td, ts, torch.as_tensor(ro),
                                     torch.as_tensor(rd), td.epsilon,
                                     torch.as_tensor(tmax))
    return jd, js, td, ts, jh, th, rd


@pytest.mark.parametrize("which", ["single_scatter", "multiple_scatter"])
def test_scatter_matches_jax_lane_by_lane(which, bssrdf_hits):
    jd, js, td, ts, jh, th, rd = bssrdf_hits
    np.testing.assert_array_equal(th.bssrdf_idx.numpy(),
                                  np.asarray(jh.bssrdf_idx))
    active = th.bssrdf_idx >= 0
    assert 0.05 < active.float().mean() < 0.5
    assert set(th.bssrdf_idx.unique().tolist()) == {-1, 0, 1}
    u = np.random.default_rng(5).random((5, rd.shape[0]), dtype=np.float32)
    wi = -rd
    j = getattr(jb, which)(jd, js, JStream(jnp.asarray(u)), jh.pos, jh.nor,
                           jh.bssrdf_idx, jnp.asarray(wi),
                           jnp.asarray(active.numpy()))
    t, rays = getattr(tb, which)(td, ts, TStream(torch.as_tensor(u)), th.pos,
                                 th.nor, th.bssrdf_idx, torch.as_tensor(wi),
                                 active)
    t, j = t.numpy(), np.asarray(j)
    assert np.isfinite(t).all() and (t[~active.numpy()] == 0).all()
    assert tp.close_lanes(t, j).mean() >= 0.99
    assert abs(t.sum() / j.sum() - 1.0) <= 1e-3
    assert (t.sum(1) > 0).sum() >= 4   # lanes the estimate reaches
    assert int(active.sum()) <= int(rays) <= 4 * int(active.sum())


def test_bssrdf_pt_matches_jax():
    """The path tracer on bssrdf.json at 16x16, 16 spp each."""
    from test_torch_vpt import _host
    a, r = _frames_port(_host(tp.BSSRDF_SCENE, 16), 16)
    b = _frames_jax(_host(tp.BSSRDF_SCENE, 16, "jax"), 16)
    _assert_same_estimate(a, b)
    assert r.static.has_bssrdf and np.isfinite(a).all() and a.mean() > 0.01


def test_bssrdf_pt_tiling_independent():
    from test_torch_vpt import _host
    host = _host(tp.BSSRDF_SCENE, 8)
    a, _ = _frames_port(host, 2, tile_size=64)
    b, _ = _frames_port(host, 2, tile_size=24)
    np.testing.assert_array_equal(a, b)
    assert a.sum() > 0
