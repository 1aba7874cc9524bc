"""Light tracing and its pieces: the port against the JAX package, on
the CPU.

- `sample_camera` and `pdf_camera` on numpy-seeded inputs: atol 1e-5 +
  rtol 1e-4 (float32, the same formulas; the importance goes as
  1 / cos^4), the raster pixels equal on >= 99.9% of points (a floor at
  a pixel edge can turn); `sample_area_light_emission` by
  test_torch_shade.py's BSDF rule (atol 1e-5 + rtol 1e-5 on >= 99% of
  lanes: the direction's small components cancel).
- `sample_bsdf` / `eval_bsdf` in IMPORTANCE mode for the two dielectric
  models, by test_torch_shade.py's BSDF rule.
- Light tracing in vacuum path by path: both packages trace the same
  1,024 light paths drawing rows of one explicit matrix (the JAX
  module's `RngStream` and key folding are replaced by a stream that
  serves the rows of the step it is made for); the splat films must
  agree within atol 1e-4 + rtol 1e-3 on >= 99% of the pixels either
  touched, and their sums within 1e-3.
- Light tracing on smoke_port within 5 standard errors of the JAX
  package's (test_torch_vpt.py's rule).
- Light tracing against the port's own path tracer on cornell_port
  within 5 standard errors, the light's own pixels left out (the
  emission-point splat there is the reference's quirk). `sample_camera`
  maps the film onto pixel centres 0 .. res - 1 (camera.h:86-114), while
  the path tracer's pixels tile it from -1/2 to res - 1/2: a light-
  tracing pixel gathers a window (res / (res - 1))^2 the area of a path-
  tracing pixel, up to half a pixel off. So the path tracer is run on
  the light tracer's windows (`_pt_on_lt_pixels`); the JAX package's
  light tracer maps pixels the same way (held path by path above).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.core.rng import PrimarySampleStream
from gpu_pathtracer_tpu.integrators import lt as jlt
from gpu_pathtracer_tpu.shade import bsdf as jbsdf
from gpu_pathtracer_tpu.shade import camera as jcam
from gpu_pathtracer_tpu.shade import lights as jlights
from gpu_pathtracer_tpu_torch.integrators import lt as tlt
from gpu_pathtracer_tpu_torch.run.renderer import Renderer
from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
from gpu_pathtracer_tpu_torch.shade import bsdf as tbsdf
from gpu_pathtracer_tpu_torch.shade import camera as tcam
from gpu_pathtracer_tpu_torch.shade import lights as tlights
from test_torch_shade import N, _agree, _frame, _materials, _unit
from test_torch_vpt import _assert_same_estimate, _frames_jax, _frames_port, \
    _host

SIZE = 32


@pytest.fixture(scope="module")
def cornell():
    mp = pytest.MonkeyPatch()
    try:
        jd, js = tp.jax_flatten(tp.PORT_SCENES["cornell"], mp, size=64)
    finally:
        mp.undo()
    td, ts = tp.port_scene_from_jax(jd, js)
    return jd, js, td, ts


def _close(t, j, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def test_sample_camera_matches_jax(cornell):
    jd, _, td, _ = cornell
    rng = np.random.default_rng(3)
    pos = rng.uniform((-1, 0, -1), (1, 2, 1.5), (N, 3)).astype(np.float32)
    j = jcam.sample_camera(jd.camera, jnp.asarray(pos), jd.epsilon)
    t = tcam.sample_camera(td.camera, torch.as_tensor(pos), td.epsilon)
    for a, b in zip(t[:5], j[:5]):
        _close(a, b, rtol=1e-4)   # we ~ 1 / cos^4: a few ulp magnified
    ok = np.asarray(j[4]) > 0
    assert 0.3 < ok.mean() < 1.0
    for a, b in zip(t[5:], j[5:]):
        assert (a.numpy()[ok] == np.asarray(b)[ok]).mean() >= 0.999
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = -np.abs(d[:, 2])   # toward the scene
    for a, b in zip(tcam.pdf_camera(td.camera, torch.as_tensor(d)),
                    jcam.pdf_camera(jd.camera, jnp.asarray(d))):
        _close(a, b, rtol=1e-4)


def test_sample_area_light_emission_matches_jax(cornell):
    jd, js, td, _ = cornell
    rng = np.random.default_rng(4)
    idx = rng.integers(0, js.n_lights, N).astype(np.int32)
    u = [rng.random(N, dtype=np.float32) for _ in range(4)]
    j = jlights.sample_area_light_emission(jd, jnp.asarray(idx),
                                           *map(jnp.asarray, u), jd.epsilon)
    t = tlights.sample_area_light_emission(td, torch.as_tensor(idx),
                                           *map(torch.as_tensor, u),
                                           td.epsilon)
    for a, b in zip(t, j):   # the direction's small components cancel
        _agree(a, b, 1e-5, 1e-5)
    assert (t[5].numpy() > 0).all() and (t[4].numpy() > 0).all()


@pytest.mark.parametrize("mtype", [int(tbsdf.DIELECTRIC),
                                   int(tbsdf.ROUGHDIELECTRIC)])
def test_importance_bsdf_matches_jax(mtype):
    """Importance transport drops the eta^2 of refraction; the sampled
    direction and pdf are the radiance mode's."""
    rng = np.random.default_rng(300 + mtype)
    jm, tm = _materials(rng, mtype, False)
    nor, dpdu = _frame(rng)
    wi = _unit(rng)
    u = [rng.random(N, dtype=np.float32) for _ in range(3)]
    args_j = (jnp.asarray(wi), jnp.asarray(nor), jnp.asarray(dpdu),
              *map(jnp.asarray, u), (mtype,))
    args_t = (torch.as_tensor(wi), torch.as_tensor(nor),
              torch.as_tensor(dpdu), *map(torch.as_tensor, u), (mtype,))
    j = jbsdf.sample_bsdf(jm, *args_j, mode=jbsdf.IMPORTANCE)
    t = tbsdf.sample_bsdf(tm, *args_t, mode=tbsdf.IMPORTANCE)
    _agree(t[0], j[0], 1e-5, 1e-5)
    _agree(t[1], j[1], 1e-4, 1e-4)
    _agree(t[2], j[2], 1e-5, 1e-5)
    rad = tbsdf.sample_bsdf(tm, *args_t)
    assert torch.equal(rad[0], t[0]) and torch.equal(rad[2], t[2])
    assert not torch.equal(rad[1], t[1])   # refracted lanes differ
    wo = _unit(rng)
    je = jbsdf.eval_bsdf(jm, jnp.asarray(wi), jnp.asarray(wo),
                         jnp.asarray(nor), jnp.asarray(dpdu), (mtype,),
                         mode=jbsdf.IMPORTANCE)
    te = tbsdf.eval_bsdf(tm, torch.as_tensor(wi), torch.as_tensor(wo),
                         torch.as_tensor(nor), torch.as_tensor(dpdu),
                         (mtype,), mode=tbsdf.IMPORTANCE)
    _agree(te[0], je[0], 1e-4, 1e-4)
    _agree(te[1], je[1], 1e-5, 1e-5)


def _row_streams(u):
    """Stand-ins for the JAX module's `jax` and `RngStream` names that
    make its light tracer read the rows of u [D, N] in the port's site
    layout: a key is an int32 whose folds encode the step, and the
    stream of step `it` starts at row LT_EMIT_DIMS + LT_STEP_DIMS it."""
    def fold_in(key, data):
        return key * 4096 + data + 1

    def stream(key):
        step = (key - 1) // 4096 - 101   # fold_in(fold_in(0, 100 + it), 0)
        base = jnp.where(key == 0, 0,
                         tlt.LT_EMIT_DIMS + step * tlt.LT_STEP_DIMS)
        return PrimarySampleStream(jnp.asarray(u), base)

    fake_jax = types.SimpleNamespace(
        random=types.SimpleNamespace(fold_in=fold_in), lax=jax.lax)
    return fake_jax, stream


def test_lt_matches_jax_path_by_path(monkeypatch):
    """cornell_port at 32x32, 1,024 light paths."""
    jd, js = tp.jax_flatten(tp.PORT_SCENES["cornell"], monkeypatch,
                            size=SIZE)
    td, ts = tp.port_scene_from_jax(jd, js)
    n = SIZE * SIZE
    u = np.random.default_rng(12).random(
        (tlt.LT_EMIT_DIMS + tlt.LT_STEP_DIMS * tlt.n_steps(ts), n),
        dtype=np.float32)
    fake_jax, stream = _row_streams(u)
    monkeypatch.setattr(jlt, "jax", fake_jax)
    monkeypatch.setattr(jlt, "RngStream", stream)
    fj = np.asarray(jlt.render_film(jd, js, jnp.int32(0), n))
    ft, rays = tlt.render_film(td, ts, 0, 1, torch.arange(n), True,
                               psample=torch.as_tensor(u))
    ft = ft.numpy()
    touched = (ft != 0).any(1) | (fj != 0).any(1)
    assert touched.mean() > 0.2 and np.isfinite(ft).all()
    assert tp.close_lanes(ft[touched], fj[touched]).mean() >= 0.99
    assert abs(ft.sum() / fj.sum() - 1.0) <= 1e-3
    assert int(rays) > 2 * n   # closest hits and camera connections


def test_lt_matches_jax_on_smoke():
    """smoke_port (smoke, fog, interfaces) at 16x16, 24 spp each."""
    host = _host(tp.SMOKE_SCENE, 16)
    host.integrator.type = IntegratorType.LT
    a, r = _frames_port(host, 24)
    hj = _host(tp.SMOKE_SCENE, 16, "jax")
    from gpu_pathtracer_tpu.scene.model import IntegratorType as JI
    hj.integrator.type = JI.LT
    b = _frames_jax(hj, 24)
    _assert_same_estimate(a, b)
    assert r.kind == "film" and np.isfinite(a).all()


def _light_pixels(size):
    """The pixels the light quad of cornell_port covers at size x size,
    grown by one: where light tracing's emission-point splat lands."""
    host = _host(tp.PORT_SCENES["cornell"], size)
    r = Renderer(host, device="cpu", integrator=IntegratorType.LT,
                 cache=False)
    sc = r.device_scene
    g = torch.linspace(0.0, 1.0, 64)
    u1, u2 = (x.reshape(-1) for x in torch.meshgrid(g, g, indexing="ij"))
    mask = np.zeros((size, size), bool)
    for li in range(r.static.n_lights):
        idx = torch.full_like(u1, li, dtype=torch.int32)
        p, *_ = tlights.sample_area_light_emission(sc, idx, u1, u2, u1, u2,
                                                   sc.epsilon)
        _, _, _, _, pdf, rx, ry = tcam.sample_camera(sc.camera, p,
                                                     sc.epsilon)
        ok = pdf > 0
        mask[ry[ok].numpy(), rx[ok].numpy()] = True
    grown = mask.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grown |= np.roll(np.roll(mask, dy, 0), dx, 1)
    return grown


def _pt_on_lt_pixels(host, spp):
    """[spp, H, W, 3] per-spp path-traced frames on light tracing's
    pixels: `sample_camera` maps the film [-1, 1]^2 onto pixel centres
    0 .. res - 1 (camera.h:86-114), so light-tracing pixel r gathers the
    film window x in [(r - 1/2), (r + 1/2)] res / (res - 1), clipped to
    [0, res], in the path tracer's pixel units. Each frame traces one
    path per pixel through a uniform point of that window and weighs it
    by the window's area (in path-tracer pixels)."""
    from gpu_pathtracer_tpu_torch.integrators import pt
    from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
    sc, st = flatten_scene(host, "cpu", cache=False)
    res = st.width
    ids = torch.arange(res * res)
    r = torch.stack([ids % res, ids // res], -1).double()
    lo = torch.clamp((r - 0.5) * res / (res - 1), 0, res)
    hi = torch.clamp((r + 0.5) * res / (res - 1), 0, res)
    area = ((hi - lo)[:, 0] * (hi - lo)[:, 1]).float()[:, None]
    gen = np.random.default_rng(8)
    out = []
    for it in range(1, spp + 1):
        u = torch.as_tensor(gen.random((ids.numel(), 2)))
        xy = (lo + u * (hi - lo)).float()
        ro, rd = tcam.generate_primary_ray(sc.camera, xy[:, 0], xy[:, 1],
                                           torch.zeros_like(xy), False)
        out.append((pt.trace_paths(sc, st, 5, it, ids, ro, rd)
                    * area).numpy())
    return np.stack(out).reshape(spp, res, res, 3)


def test_lt_matches_pt():
    """Adjoint and forward transport estimate the same image on light
    tracing's pixels (`_pt_on_lt_pixels`), away from the light's own
    pixels (the emission-point splat there is the reference's quirk):
    cornell_port at 16x16, 48 spp each, within 5 standard errors."""
    host = _host(tp.PORT_SCENES["cornell"], 16)
    a, _ = _frames_port(host, 48, integrator=IntegratorType.LT)
    b = _pt_on_lt_pixels(host, 48)
    light = _light_pixels(16)
    assert 0 < light.sum() < 40
    a[:, light] = 0.0
    b[:, light] = 0.0
    _assert_same_estimate(a, b)
    assert a.mean() > 0.01


def test_lt_tiling_independent():
    """The film depends on (seed, iteration, path index) only: tiles of
    64 and of 24 paths agree within float32 summation order."""
    host = _host(tp.SMOKE_SCENE, 8)
    a, _ = _frames_port(host, 2, tile_size=64, integrator=IntegratorType.LT)
    b, _ = _frames_port(host, 2, tile_size=24, integrator=IntegratorType.LT)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert a.sum() > 0
