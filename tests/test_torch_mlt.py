"""PSSMLT: the port's integrators/mlt.py against the JAX package's, on the
CPU, cornell_port at 32x32, depth 5.

The JAX module's `jax.random` is replaced by a stand-in whose `split`
is JAX's and whose `uniform` serves given numpy matrices in call order;
the port takes the same matrices through `draws=`.
- The bootstrap (4,096 candidate chains): the chosen candidates equal
  on >= 99.9% of the chains (the JAX package resamples over a float32
  cumulative sum, the port over a float64 one, so a chain at a boundary
  may take its neighbour).
- One mutation step chain by chain from one carried-across state (the
  JAX package's, through `mlt.state_from_numpy`): the proposal u within
  atol 1e-6, the luminance within atol 1e-4 + rtol 1e-3 and the pixel
  equal on >= 99% of chains, the film on >= 99% of the pixels either
  touched, and the image's sum within 1e-3.
- 48 steps against the port's own path tracer: the image mean within
  0.7-1.4 of PT's, the band tests/test_integrators.py holds the JAX
  package's MLT to.
- scenes/cornell_port/mlt_slit.json (the slit scene on in-repo meshes)
  renders a few steps at 16x16 with its 10 bounces; that both packages
  load it alike is held by test_torch_scene.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.integrators import mlt as jmlt
from gpu_pathtracer_tpu_torch.integrators import mlt as tmlt
from gpu_pathtracer_tpu_torch.run.renderer import Renderer
from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
from test_torch_vpt import _host

SIZE = 32
N_CHAINS = 4096


def _served(mats):
    """A stand-in `jax` whose random.uniform hands out `mats` in order."""
    queue = list(mats)

    def uniform(key, shape):
        m = queue.pop(0)
        assert m.shape == tuple(shape), (m.shape, shape)
        return jnp.asarray(m)

    return types.SimpleNamespace(random=types.SimpleNamespace(
        split=jax.random.split, uniform=uniform))


@pytest.fixture(scope="module")
def boot():
    """Both packages' bootstrap from the same candidate matrix."""
    mp = pytest.MonkeyPatch()
    try:
        jd, js = tp.jax_flatten(tp.PORT_SCENES["cornell"], mp, size=SIZE)
        td, ts = tp.port_scene_from_jax(jd, js)
        d = tmlt.n_dims(ts)
        rng = np.random.default_rng(41)
        u = rng.random((d, N_CHAINS), dtype=np.float32)
        u_r = rng.random(N_CHAINS, dtype=np.float32)
        mp.setattr(jmlt, "jax", _served([u, u_r]))
        sj = jmlt.bootstrap(jd, js, jax.random.PRNGKey(0), N_CHAINS)
    finally:
        mp.undo()
    st, rays = tmlt.bootstrap(td, ts, 0, N_CHAINS,
                              draws=(torch.as_tensor(u), torch.as_tensor(u_r)))
    sj = {k: np.asarray(v) for k, v in sj.items()}
    return dict(jd=jd, js=js, td=td, ts=ts, sj=sj, st=st, rays=rays, d=d)


def test_bootstrap_matches_jax(boot):
    sj, st = boot["sj"], boot["st"]
    same = np.all(st["u"].numpy() == sj["u"], axis=0)
    assert same.mean() >= 0.999, same.mean()
    assert len(np.unique(sj["u"][0])) < N_CHAINS   # resampled, not copied
    np.testing.assert_allclose(float(st["b_sum"]), float(sj["b_sum"]),
                               rtol=1e-5)
    assert tp.close_lanes(st["li"].numpy()[same], sj["li"][same]).all()
    assert (sj["lum"] > 0).all() and int(boot["rays"]) > N_CHAINS


def test_step_matches_jax(boot, monkeypatch):
    """One mutation of every chain from the JAX package's bootstrap."""
    sj, d = boot["sj"], boot["d"]
    rng = np.random.default_rng(42)
    sel = rng.random((1, N_CHAINS), dtype=np.float32)
    fresh, mag, sign = (rng.random((d, N_CHAINS), dtype=np.float32)
                        for _ in range(3))
    acc = rng.random(N_CHAINS, dtype=np.float32)
    monkeypatch.setattr(jmlt, "jax", _served([sel, fresh, mag, sign, acc]))
    state_j = {k: jnp.asarray(v) for k, v in sj.items()}
    nj, img_j = jmlt.render_iteration(boot["jd"], boot["js"],
                                      jax.random.PRNGKey(1), state_j)
    nj = {k: np.asarray(v) for k, v in nj.items()}
    img_j = np.asarray(img_j)
    state_t = tmlt.state_from_numpy(sj, "cpu")
    nt, img_t, rays = tmlt.render_iteration(
        boot["td"], boot["ts"], 0, 1, state_t, True, draws=tuple(
            torch.as_tensor(x) for x in (sel[0], acc, fresh, mag, sign)))
    np.testing.assert_allclose(nt["u"].numpy(), nj["u"], atol=1e-6)
    assert tp.close_lanes(nt["lum"].numpy()[:, None],
                          nj["lum"][:, None]).mean() >= 0.99
    pix = (nt["px"].numpy() == nj["px"]) & (nt["py"].numpy() == nj["py"])
    assert pix.mean() >= 0.99
    film_t, film_j = nt["film"].numpy(), nj["film"]
    touched = (film_t != 0).any(1) | (film_j != 0).any(1)
    assert touched.mean() > 0.5
    assert tp.close_lanes(film_t[touched], film_j[touched]).mean() >= 0.99
    assert abs(img_t.numpy().sum() / img_j.sum() - 1.0) <= 1e-3
    for k in ("b_sum", "b_cnt", "steps"):
        np.testing.assert_allclose(float(nt[k]), float(nj[k]), rtol=1e-5)
    assert 0 < int(rays) <= 2 * 5 * N_CHAINS


def test_mlt_matches_pt():
    host = _host(tp.PORT_SCENES["cornell"], SIZE)
    r = Renderer(host, device="cpu", integrator=IntegratorType.MLT,
                 max_depth=5)
    r.render(48)
    b = r.radiance()
    r_pt = Renderer(host, seed=1, device="cpu", integrator=IntegratorType.PT,
                    max_depth=5)
    r_pt.render(16)
    a = r_pt.radiance()
    assert r.kind == "mlt" and np.isfinite(b).all()
    assert 0.7 < b.mean() / a.mean() < 1.4, b.mean() / a.mean()
    assert r.image().shape == (SIZE, SIZE, 3)


def test_mlt_slit_renders():
    host = _host(tp.REPO / "scenes" / "cornell_port" / "mlt_slit.json", 16)
    r = Renderer(host, device="cpu")
    assert r.kind == "mlt" and r.static.max_depth == 10
    assert r._mlt_state["u"].shape == (tmlt.n_dims(r.static), 16 * 16)
    r.render(4)
    rad = r.radiance()
    assert np.isfinite(rad).all() and rad.mean() > 0.0
