"""Bidirectional path tracing: the port's integrators/bdpt.py against the
JAX package's, on the CPU.

- `_convert_pdf`, `_mis_tables` and `_mis_weight` on given (numpy-seeded)
  vertex tables and override pdfs, for each connection case's index
  forms: atol 1e-6 + rtol 1e-5 (the same float32 formulas).
- Whole images within 5 standard errors of the JAX package's
  (test_torch_vpt.py's rule) on cornell_port and on smoke_port. The two
  draw from different generators, and the port's connection roulette
  thins against the lane's own mean (the JAX package's against the
  round's), both unbiased.
- Against the port's own path tracer: the image means within 10%, as
  tests/test_integrators.py holds the JAX package's. Not within 5
  standard errors: with max_depth D, BDPT's strategies reach paths of up
  to 2 D + 1 segments with MIS weights that sum to one only up to D, and
  its s = 1 splats carry the raster mapping of test_torch_lt.py.
- The image does not depend on the tile size: the per-lane radiance bit
  for bit, the splat film within float32 summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.integrators import bdpt as jb
from gpu_pathtracer_tpu_torch.integrators import bdpt as tb
from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
from test_torch_vpt import _assert_same_estimate, _frames_jax, _frames_port, \
    _host

N, K = 512, 6
G = K - 1


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                               rtol=1e-5)


def test_convert_pdf_matches_jax():
    rng = np.random.default_rng(1)
    pdf = rng.uniform(0, 3, N).astype(np.float32)
    a, b = (rng.uniform(-1, 1, (N, 3)).astype(np.float32) for _ in range(2))
    nor = rng.normal(size=(N, 3))
    nor /= np.linalg.norm(nor, axis=1, keepdims=True)
    nor[::4] = 0.0   # medium vertices: no cosine
    nor = nor.astype(np.float32)
    _close(tb._convert_pdf(*map(torch.as_tensor, (pdf, a, b, nor))),
           jb._convert_pdf(*map(jnp.asarray, (pdf, a, b, nor))))


def _tables(seed):
    """A camera and a light side's (fwd, rev, delta) tables [N, K] with
    delta vertices (pdf 0) among them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        fwd = rng.uniform(0.01, 5, (N, K)).astype(np.float32)
        rev = rng.uniform(0.01, 5, (N, K)).astype(np.float32)
        delta = rng.random((N, K)) < 0.15
        fwd[delta] = 0.0
        rev[rng.random((N, K)) < 0.1] = 0.0
        out.append((fwd, rev, delta))
    return out


def _verts_t(fwd, rev, delta):
    v = tb.empty_vertices(N, K, "cpu")
    v.fwd, v.rev, v.delta = (torch.as_tensor(x) for x in (fwd, rev, delta))
    return v


def _verts_j(fwd, rev, delta):
    v = jb._empty_vertices(N, K)
    return v.replace(fwd=jnp.asarray(fwd), rev=jnp.asarray(rev),
                     delta=jnp.asarray(delta))


@pytest.mark.parametrize("lo", [0, 1])
def test_mis_tables_match_jax(lo):
    (fwd, rev, delta), _ = _tables(2)
    t = tb._mis_tables(_verts_t(fwd, rev, delta), lo)
    j = jb._mis_tables(_verts_j(fwd, rev, delta), lo)
    _close(t[0], j[0])
    _close(t[1], j[1])


# (s, t) index forms of the four connection cases: "col" is the
# strategy column vector 2 .. G + 1
MIS_CASES = {"s1": (1, "col"), "t0": ("col", 0), "t1": ("col", 1),
             "gen_s2": (2, "col"), "gen_s4": (4, "col"),
             "gen_s6": (6, "col")}


@pytest.mark.parametrize("case", sorted(MIS_CASES))
def test_mis_weight_matches_jax(case):
    (cf, cr, cd), (lf, lr, ld) = _tables(3)
    rng = np.random.default_rng(4)
    over = [rng.uniform(0.0, 4.0, (N, G)).astype(np.float32)
            for _ in range(5)]
    for o in over:
        o[rng.random((N, G)) < 0.1] = 0.0
    s, t = MIS_CASES[case]
    col = np.arange(2, G + 2, dtype=np.int32)[None, :]
    # the overrides a case leaves out are NaN, as each round passes them
    nan = np.full((N, G), np.nan, np.float32)
    if case == "s1":
        over[0] = over[1] = over[4] = nan
    elif case == "t0":
        over[2] = over[3] = over[4] = nan
    elif case == "t1":
        over[3] = nan
    else:
        over[4] = nan
    cam_t, light_t = _verts_t(cf, cr, cd), _verts_t(lf, lr, ld)
    cam_j, light_j = _verts_j(cf, cr, cd), _verts_j(lf, lr, ld)
    args_t = (cam_t.fwd, *tb._mis_tables(cam_t, 1), light_t.fwd,
              *tb._mis_tables(light_t, 0))
    args_j = (cam_j.fwd, *jb._mis_tables(cam_j, 1), light_j.fwd,
              *jb._mis_tables(light_j, 0))
    ts_, tt_ = (torch.as_tensor(col) if x == "col" else x for x in (s, t))
    js_, jt_ = (col if x == "col" else x for x in (s, t))
    w_t = tb._mis_weight(*args_t, ts_, tt_, *map(torch.as_tensor, over))
    w_j = jb._mis_weight(*args_j, js_, jt_, *map(jnp.asarray, over))
    assert w_t.shape == (N, G) and torch.isfinite(w_t).all()
    assert ((w_t > 0) & (w_t <= 1)).all()
    _close(w_t, w_j)


def _bdpt_host(path, size, loader="port"):
    host = _host(path, size, loader)
    if loader == "port":
        host.integrator.type = IntegratorType.BDPT
    else:
        from gpu_pathtracer_tpu.scene.model import IntegratorType as JI
        host.integrator.type = JI.BDPT
    return host


@pytest.mark.parametrize("scene", ["cornell", "smoke"])
def test_bdpt_matches_jax(scene):
    """cornell_port and smoke_port at 16x16, 16 spp each."""
    path = tp.PORT_SCENES["cornell"] if scene == "cornell" else tp.SMOKE_SCENE
    a, r = _frames_port(_bdpt_host(path, 16), 16)
    b = _frames_jax(_bdpt_host(path, 16, "jax"), 16)
    _assert_same_estimate(a, b)
    assert r.kind == "hybrid" and np.isfinite(a).all() and a.mean() > 0.01


def test_bdpt_matches_pt():
    """cornell_port at 32x32: BDPT 8 spp against PT 16 spp, means
    within 10% (module docstring)."""
    host = _host(tp.PORT_SCENES["cornell"], 32)
    a, _ = _frames_port(host, 8, integrator=IntegratorType.BDPT)
    b, _ = _frames_port(host, 16, integrator=IntegratorType.PT)
    assert 0.9 < a.mean() / b.mean() < 1.1, a.mean() / b.mean()


@pytest.mark.parametrize("scene", ["cornell", "smoke"])
def test_bdpt_tiling_independent(scene):
    """One 8x8 sample as one tile of 64 lanes and as tiles of 24: the
    per-lane radiance bit for bit, the s == 1 film within float32
    summation order."""
    path = tp.PORT_SCENES["cornell"] if scene == "cornell" else tp.SMOKE_SCENE
    host = _bdpt_host(path, 8)
    sc, st = flatten_scene(host, "cpu", cache=False)
    ids = torch.arange(64, dtype=torch.int32)
    px, py = ids % 8, ids // 8
    li, film, rays = tb.render_lanes(sc, st, 7, 3, px, py, True)
    parts = [tb.render_lanes(sc, st, 7, 3, px[i:i + 24], py[i:i + 24], True)
             for i in range(0, 64, 24)]
    assert torch.equal(li, torch.cat([p[0] for p in parts]))
    torch.testing.assert_close(film, sum(p[1] for p in parts), rtol=1e-5,
                               atol=1e-6)
    assert int(rays) == sum(int(p[2]) for p in parts)
    assert li.sum() > 0 and film.sum() > 0
