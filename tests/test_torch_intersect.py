"""Intersection parity: the port's dense-hit plain version (the CUDA
kernel's reference) and hit record vs the JAX package.

Rays come from numpy; both packages run on the JAX package's flattened
tables. `prim` must agree on >= 99.9% of lanes (a ray through a shared
edge may pick either triangle in float32) and t, pos, nor, uv, dpdu
within 1e-4 where it does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.geom import dense as jdense
from gpu_pathtracer_tpu.geom import traverse as jtrav
from gpu_pathtracer_tpu_torch.geom import dense, traverse

N = 8192
ATOL = 1e-4


@pytest.fixture(params=["cornell", "materials", "sphere_line"])
def scenes(request, tmp_path, monkeypatch):
    path = (tp.write_sphere_line_scene(tmp_path)
            if request.param == "sphere_line"
            else tp.PORT_SCENES[request.param])
    jd, js = tp.jax_flatten(path, monkeypatch)
    td, ts = tp.port_scene_from_jax(jd, js)
    rng = np.random.default_rng(11)
    ro, rd = tp.random_rays(rng, N)
    tmax = np.where(rng.random(N) < 0.5, np.inf,
                    rng.uniform(0.2, 2.0, N)).astype(np.float32)
    return jd, js, td, ts, ro, rd, tmax


def test_dense_closest_matches_jax(scenes):
    jd, js, td, ts, ro, rd, tmax = scenes
    eps = float(jd.epsilon)
    jt, jp, jf = jdense.dense_closest(jd, js, jnp.asarray(ro),
                                      jnp.asarray(rd), eps,
                                      jnp.asarray(tmax))
    tt, tprim, tf = dense.dense_closest(td, ts, torch.as_tensor(ro),
                                        torch.as_tensor(rd), eps,
                                        torch.as_tensor(tmax))
    same = tprim.numpy() == np.asarray(jp)
    assert same.mean() >= 0.999
    assert np.array_equal(tf.numpy()[same], np.asarray(jf)[same])
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(jt)[same],
                               atol=ATOL, rtol=ATOL)
    assert 0.2 < tf.numpy().mean() <= 1.0


def test_dense_any_matches_jax(scenes):
    jd, js, td, ts, ro, rd, tmax = scenes
    eps = float(jd.epsilon)
    tmax = np.where(np.isinf(tmax), 1.0, tmax).astype(np.float32)
    jf = np.asarray(jdense.dense_any(jd, js, jnp.asarray(ro),
                                     jnp.asarray(rd), eps,
                                     jnp.asarray(tmax)))
    tf = dense.dense_any(td, ts, torch.as_tensor(ro), torch.as_tensor(rd),
                         eps, torch.as_tensor(tmax)).numpy()
    assert (tf == jf).mean() >= 0.999
    assert 0.05 < tf.mean() < 0.95


def test_hit_attributes_match_jax_oracle(scenes):
    jd, js, td, ts, ro, rd, _ = scenes
    eps = float(jd.epsilon)
    inf = np.full(N, np.inf, np.float32)
    jh = jtrav.brute_force_closest(jd, js, jnp.asarray(ro), jnp.asarray(rd),
                                   eps, jnp.asarray(inf))
    th = traverse.intersect_closest(td, ts, torch.as_tensor(ro),
                                    torch.as_tensor(rd), eps,
                                    torch.as_tensor(inf))
    same = th.prim_idx.numpy() == np.asarray(jh.prim_idx)
    assert same.mean() >= 0.999
    m = same & th.valid.numpy()
    assert m.mean() > 0.5
    for name in ("t", "pos", "nor", "uv", "dpdu"):
        np.testing.assert_allclose(getattr(th, name).numpy()[m],
                                   np.asarray(getattr(jh, name))[m],
                                   atol=ATOL, rtol=ATOL, err_msg=name)
    for name in ("mat_idx", "light_idx"):
        assert np.array_equal(getattr(th, name).numpy()[same],
                              np.asarray(getattr(jh, name))[same]), name


def test_port_oracle_matches_dense(scenes):
    _, _, td, ts, ro, rd, tmax = scenes
    eps = float(td.epsilon)
    args = (torch.as_tensor(ro), torch.as_tensor(rd), eps,
            torch.as_tensor(tmax))
    bf = traverse.brute_force_closest(td, ts, *args)
    hd = traverse.intersect_closest(td, ts, *args)
    same = bf.prim_idx == hd.prim_idx
    assert same.float().mean() >= 0.999
    assert torch.equal(bf.t[same], hd.t[same])


def test_plain_flag_and_size_limit(scenes):
    """`plain` gives the same hits; past DENSE_MAX prims there is no size
    limit any more: the same query takes the block-culled regime and
    finds the same hits (ties between equal-t prims may pick another)."""
    _, _, td, ts, ro, rd, tmax = scenes
    args = (torch.as_tensor(ro), torch.as_tensor(rd), float(td.epsilon),
            torch.as_tensor(tmax))
    a = traverse.intersect_closest(td, ts, *args)
    b = traverse.intersect_closest(td, ts, *args, plain=True)
    assert torch.equal(a.prim_idx, b.prim_idx) and torch.equal(a.t, b.t)
    import dataclasses
    big = dataclasses.replace(ts, n_primitives=dense.DENSE_MAX + 1)
    assert traverse.regime(big) == "blocked"
    c = traverse.intersect_closest(td, big, *args)
    assert torch.equal(a.valid, c.valid) and torch.equal(a.t, c.t)
    assert (a.prim_idx == c.prim_idx).float().mean() >= 0.999
    assert torch.equal(traverse.intersect_any(td, big, *args),
                       traverse.intersect_any(td, ts, *args))


def test_empty_intervals_miss(scenes):
    """dense_closest / dense_any give a miss (prim -1, t = tmax, not
    found) on every lane whose interval is empty (tmax < tmin and <= 0,
    empty for spheres too), mixed with live lanes."""
    _, _, td, ts, ro, rd, tmax = scenes
    eps = float(td.epsilon)
    rng = np.random.default_rng(6)
    empty = torch.as_tensor(rng.random(N) < 0.4)
    dead = torch.as_tensor(rng.choice(np.float32([0.0, -1.0, -np.inf]), N))
    tm = torch.where(empty, dead, torch.as_tensor(tmax))
    args = (torch.as_tensor(ro), torch.as_tensor(rd), eps, tm)
    t, p, f = dense.dense_closest(td, ts, *args)
    assert bool((p[empty] == -1).all()) and not bool(f[empty].any())
    assert torch.equal(t[empty], tm[empty])
    assert f[~empty].float().mean() > 0.2
    found = dense.dense_any(td, ts, *args)
    assert not bool(found[empty].any()) and torch.equal(found, f)
