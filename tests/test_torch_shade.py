"""Shading parity: camera, area lights, tonemap and the six BSDF models
vs the JAX package, on the same numpy inputs.

BSDF tolerances follow tests/test_pt_fused.py:153-170: wo atol 1e-5,
fr atol and rtol 1e-4, pdf atol 1e-5, with np.allclose's rtol 1e-5
where that test leaves rtol at its default. That test compares two XLA
programs; here the frameworks' transcendentals (cos, tan, atan) differ
by an ulp, which a few ill-conditioned lanes amplify (a sine taken as
sqrt(1 - cos^2) near 0, a GGX lobe near grazing). So those tolerances
must hold on >= 99% of lanes, and every lane must agree within ten
times the atol and a relative 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.film import film as jfilm
from gpu_pathtracer_tpu.shade import bsdf as jbsdf
from gpu_pathtracer_tpu.shade import camera as jcam
from gpu_pathtracer_tpu.shade import lights as jlights
from gpu_pathtracer_tpu_torch.film import film as tfilm
from gpu_pathtracer_tpu_torch.scene.model import MaterialType
from gpu_pathtracer_tpu_torch.shade import bsdf as tbsdf
from gpu_pathtracer_tpu_torch.shade import camera as tcam
from gpu_pathtracer_tpu_torch.shade import lights as tlights

N = 4096


@pytest.fixture(scope="module")
def cornell():
    mp = pytest.MonkeyPatch()
    try:
        jd, js = tp.jax_flatten(tp.PORT_SCENES["materials"], mp, size=64)
    finally:
        mp.undo()
    td, ts = tp.port_scene_from_jax(jd, js)
    return jd, js, td, ts


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _agree(t, j, atol, rtol):
    """The BSDF agreement rule of the module docstring."""
    t, j = _np(t).reshape(N, -1), _np(j).reshape(N, -1)
    err = np.abs(t - j)
    lanes = np.all(err <= atol + rtol * np.abs(j), axis=1)
    assert lanes.mean() >= 0.99, lanes.mean()
    np.testing.assert_allclose(t, j, atol=10 * atol, rtol=1e-3)


@pytest.mark.parametrize("lens", ["pinhole", "thin_lens", "environment"])
def test_primary_rays_match_jax(cornell, lens):
    jd, _, td, _ = cornell
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 64, N).astype(np.float32)
    y = rng.uniform(0, 64, N).astype(np.float32)
    ap = rng.uniform(-0.7, 0.7, (N, 2)).astype(np.float32)
    jc, tc = jd.camera, td.camera
    if lens == "thin_lens":
        jc = jc.replace(aperture=jnp.float32(0.05), focal=jnp.float32(6.0))
        tc = dataclasses.replace(tc, aperture=torch.tensor(0.05),
                                 focal=torch.tensor(6.0))
    env = lens == "environment"
    jo, jdir = jcam.generate_primary_ray(jc, jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(ap), env)
    to, tdir = tcam.generate_primary_ray(tc, torch.as_tensor(x),
                                         torch.as_tensor(y),
                                         torch.as_tensor(ap), env)
    np.testing.assert_allclose(_np(to), _np(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tdir), _np(jdir), atol=1e-5, rtol=1e-5)


def test_lights_match_jax(cornell):
    jd, _, td, ts = cornell
    rng = np.random.default_rng(2)
    u = rng.random(N, dtype=np.float32)
    ji, jc = jlights.pick_light(jd, jnp.asarray(u))
    ti, tc = tlights.pick_light(td, torch.as_tensor(u))
    assert np.array_equal(_np(ti), _np(ji))
    np.testing.assert_allclose(_np(tc), _np(jc), atol=1e-6)
    assert set(np.unique(_np(ti))) == set(range(ts.n_lights))

    pos, _ = tp.random_rays(rng, N)
    u1 = rng.random(N, dtype=np.float32)
    u2 = rng.random(N, dtype=np.float32)
    eps = float(jd.epsilon)
    js_ = jlights.sample_area_light(jd, ji, jnp.asarray(pos), jnp.asarray(u1),
                                    jnp.asarray(u2), eps)
    ts_ = tlights.sample_area_light(td, ti, torch.as_tensor(pos),
                                    torch.as_tensor(u1), torch.as_tensor(u2),
                                    eps)
    for name, a, b in zip(("radiance", "origin", "dir", "tmax", "nor", "pdf"),
                          ts_, js_):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    assert (_np(ts_[5]) > 0).mean() > 0.5

    d = _np(ts_[2])
    nor = _np(ts_[4])
    jpa, jpw = jlights.area_light_pdf(jd, ji, jnp.asarray(d), jnp.asarray(nor))
    tpa, tpw = tlights.area_light_pdf(td, ti, torch.as_tensor(d),
                                      torch.as_tensor(nor))
    np.testing.assert_allclose(_np(tpa), _np(jpa), rtol=1e-6)
    np.testing.assert_allclose(_np(tpw), _np(jpw), atol=1e-6)
    idx = np.where(rng.random(N) < 0.2, -1, _np(ti)).astype(np.int32)
    jle = jlights.area_light_le(jd, jnp.asarray(idx), jnp.asarray(nor),
                                jnp.asarray(-d))
    tle = tlights.area_light_le(td, torch.as_tensor(idx),
                                torch.as_tensor(nor), torch.as_tensor(-d))
    assert np.array_equal(_np(tle), _np(jle))


@pytest.mark.parametrize("filmic", [False, True])
def test_tonemap_matches_jax(filmic):
    rng = np.random.default_rng(3)
    acc = (rng.exponential(2.0, (N, 3)) * 8).astype(np.float32)
    acc[:16] = 0.0
    j = jfilm.tonemap(jnp.asarray(acc), jnp.float32(8), filmic)
    t = tfilm.tonemap(torch.as_tensor(acc), 8, filmic)
    np.testing.assert_allclose(_np(t), _np(j), atol=1e-6, rtol=1e-6)


def _frame(rng):
    nor = rng.normal(size=(N, 3))
    nor /= np.linalg.norm(nor, axis=1, keepdims=True)
    t = np.cross(nor, rng.normal(size=(N, 3)))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    return nor.astype(np.float32), t.astype(np.float32)


def _unit(rng):
    v = rng.normal(size=(N, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _materials(rng, mtype, aniso):
    au = rng.uniform(0.05, 0.5, N).astype(np.float32)
    av = np.where(rng.random(N) < 0.5, au,
                  rng.uniform(0.05, 0.5, N)).astype(np.float32) \
        if aniso else au
    f = dict(type=np.full(N, mtype, np.int32), alpha_u=au, alpha_v=av,
             inside_ior=rng.uniform(1.3, 1.8, N).astype(np.float32),
             outside_ior=rng.uniform(1.0, 1.1, N).astype(np.float32),
             k=rng.uniform(1.0, 4.0, (N, 3)).astype(np.float32),
             eta=rng.uniform(0.1, 1.5, (N, 3)).astype(np.float32),
             specular=rng.uniform(0.04, 1.0, (N, 3)).astype(np.float32),
             diffuse=rng.uniform(0.0, 0.9, (N, 3)).astype(np.float32))
    jm = jbsdf.MatParams(**{k: jnp.asarray(v) for k, v in f.items()},
                         aniso=aniso)
    tm = tbsdf.MatParams(**{k: torch.as_tensor(v) for k, v in f.items()},
                         aniso=aniso)
    return jm, tm


MODELS = [(int(m), aniso) for m in MaterialType for aniso in (False, True)
          if aniso is False or m in (MaterialType.ROUGHCONDUCTOR,
                                     MaterialType.SUBSTRATE,
                                     MaterialType.ROUGHDIELECTRIC)]


@pytest.mark.parametrize("mtype, aniso", MODELS)
def test_sample_and_eval_bsdf_match_jax(mtype, aniso):
    rng = np.random.default_rng(100 + mtype + 10 * aniso)
    jm, tm = _materials(rng, mtype, aniso)
    nor, dpdu = _frame(rng)
    wi = _unit(rng)
    u = [rng.random(N, dtype=np.float32) for _ in range(3)]
    j = jbsdf.sample_bsdf(jm, jnp.asarray(wi), jnp.asarray(nor),
                          jnp.asarray(dpdu), *map(jnp.asarray, u), (mtype,))
    t = tbsdf.sample_bsdf(tm, torch.as_tensor(wi), torch.as_tensor(nor),
                          torch.as_tensor(dpdu), *map(torch.as_tensor, u),
                          (mtype,))
    _agree(t[0], j[0], 1e-5, 1e-5)
    _agree(t[1], j[1], 1e-4, 1e-4)
    _agree(t[2], j[2], 1e-5, 1e-5)
    assert (_np(t[2]) > 0).mean() > 0.3

    wo = _unit(rng)
    je = jbsdf.eval_bsdf(jm, jnp.asarray(wi), jnp.asarray(wo),
                         jnp.asarray(nor), jnp.asarray(dpdu), (mtype,))
    te = tbsdf.eval_bsdf(tm, torch.as_tensor(wi), torch.as_tensor(wo),
                         torch.as_tensor(nor), torch.as_tensor(dpdu),
                         (mtype,))
    _agree(te[0], je[0], 1e-4, 1e-4)
    _agree(te[1], je[1], 1e-5, 1e-5)
