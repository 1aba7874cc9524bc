"""Instant radiosity: the port's integrators/ir.py against the JAX
package's, on the CPU.

- The VPL store path by path: both packages walk the same 32 light
  paths on cornell_port, drawing rows of one explicit matrix (the JAX
  module's `jax` and `RngStream` names are replaced by stand-ins that
  serve the rows of the bounce a stream is made for, as
  test_torch_lt.py::_row_streams does): every path stores the same
  number of VPLs, each field within atol 1e-4 + rtol 1e-4 (the small
  components of a sampled direction cancel: 2e-5 apart seen).
- The camera pass lane by lane on one carried-across store (the JAX
  package's, through `ir.vpls_from_numpy`), gathering its fullest row:
  radiance within atol 1e-5 + rtol 1e-5 on >= 99% of lanes, means
  within 1e-4; on materials.json too (every material model: the delta
  chain and glossy gathers), within atol 1e-4 + rtol 1e-3.
- 8 iterations against the port's own path tracer: the image mean
  within 0.5-1.5 of PT's, the band tests/test_integrators.py holds the
  JAX package's IR to (the vplBias clamp biases it).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.core.rng import PrimarySampleStream
from gpu_pathtracer_tpu.integrators import ir as jir
from gpu_pathtracer_tpu_torch.core.rng import PSS_BOUNCE_DIMS, PSS_CAM_DIMS
from gpu_pathtracer_tpu_torch.integrators import ir as tir
from gpu_pathtracer_tpu_torch.run.renderer import Renderer
from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
from test_torch_vpt import _host

SIZE = 32
FIELDS = ("beta", "dir", "pos", "nor", "uv", "dpdu")


def row_streams(u, first: int, stride: int):
    """Stand-ins for a JAX module's `jax` and `RngStream` names: a key is
    an int whose folds encode the scope, the stream of
    fold_in(key, 0) reads rows from 0 and the stream of
    fold_in(key, 100 + b) rows from first + stride b."""
    def fold_in(key, data):
        return key * 4096 + data + 1

    def stream(key):
        base = jnp.where(key == 1, 0, first + (key - 101) * stride)
        return PrimarySampleStream(jnp.asarray(u), base)

    fake_jax = types.SimpleNamespace(
        random=types.SimpleNamespace(fold_in=fold_in), lax=jax.lax)
    return fake_jax, stream


@pytest.fixture(scope="module")
def cornell():
    mp = pytest.MonkeyPatch()
    try:
        jd, js = tp.jax_flatten(tp.PORT_SCENES["cornell"], mp, size=SIZE)
    finally:
        mp.undo()
    td, ts = tp.port_scene_from_jax(jd, js)
    return jd, js, td, ts


def _vpls(jd, js, monkeypatch, seed=21):
    """The JAX package's VPL store and the port's, from one matrix."""
    u = np.random.default_rng(seed).random(
        (tir.IR_EMIT_DIMS + tir.IR_BOUNCE_DIMS * js.max_depth,
         tir.IR_MAX_VPLS), dtype=np.float32)
    with monkeypatch.context() as m:
        fake_jax, stream = row_streams(u, tir.IR_EMIT_DIMS,
                                       tir.IR_BOUNCE_DIMS)
        m.setattr(jir, "jax", fake_jax)
        m.setattr(jir, "RngStream", stream)
        vj = jir.generate_vpls(jd, js, 0)
    return vj, u


def test_vpl_store_matches_jax(cornell, monkeypatch):
    jd, js, td, ts = cornell
    vj, u = _vpls(jd, js, monkeypatch)
    vt, rays = tir.generate_vpls(td, ts, 0, 1, True, psample=torch.as_tensor(u))
    count = np.asarray(vj.count)
    np.testing.assert_array_equal(vt.count.numpy(), count)
    assert count.min() >= 1 and count.max() == 1 + js.max_depth
    assert (count - 1).sum() <= int(rays) <= tir.IR_MAX_VPLS * js.max_depth
    np.testing.assert_allclose(vt.pdf0.numpy(), np.asarray(vj.pdf0),
                               rtol=1e-5)
    for p in range(tir.IR_MAX_VPLS):
        k = count[p]
        np.testing.assert_array_equal(vt.mat_idx[p, :k].numpy(),
                                      np.asarray(vj.mat_idx)[p, :k])
        for name in FIELDS:
            np.testing.assert_allclose(
                getattr(vt, name)[p, :k].numpy(),
                np.asarray(getattr(vj, name))[p, :k], atol=1e-4, rtol=1e-4,
                err_msg=f"path {p} {name}")


@pytest.mark.parametrize("scene", ["cornell", "materials"])
def test_camera_pass_matches_jax(cornell, scene, monkeypatch):
    """One carried-across store; its fullest row is gathered. On
    materials.json (every model: the delta chain, glossy gathers) within
    atol 1e-4 + rtol 1e-3 (a float32 difference through a delta bounce
    moves a lane more)."""
    jd, js, td, ts = cornell
    tol = dict(atol=1e-5, rtol=1e-5)
    if scene == "materials":
        jd, js = tp.jax_flatten(tp.PORT_SCENES["materials"], monkeypatch,
                                size=SIZE)
        td, ts = tp.port_scene_from_jax(jd, js)
        tol = dict(atol=1e-4, rtol=1e-3)
    vj, _ = _vpls(jd, js, monkeypatch)
    vt = tir.vpls_from_numpy({f: np.asarray(getattr(vj, f))
                              for f in vj.__dataclass_fields__}, "cpu")
    row = int(np.argmax(np.asarray(vj.count)))
    n = SIZE * SIZE
    px = np.arange(n, dtype=np.int32) % SIZE
    py = np.arange(n, dtype=np.int32) // SIZE
    u = np.random.default_rng(22).random(
        (PSS_CAM_DIMS + PSS_BOUNCE_DIMS * js.max_depth, n), dtype=np.float32)
    fake_jax, stream = row_streams(u, PSS_CAM_DIMS, PSS_BOUNCE_DIMS)
    monkeypatch.setattr(jir, "jax", fake_jax)
    monkeypatch.setattr(jir, "RngStream", stream)
    lj = np.asarray(jir.render_lanes(jd, js, 0, jnp.asarray(px),
                                     jnp.asarray(py), vj, row))
    lt, rays = tir.render_lanes(td, ts, 0, 1, torch.as_tensor(px),
                                torch.as_tensor(py), vt, row, True,
                                psample=torch.as_tensor(u))
    lt = lt.numpy()
    assert np.isfinite(lt).all() and lj.mean() > 0.01
    assert tp.close_lanes(lt, lj, **tol).mean() >= 0.99
    assert abs(lt.mean() / lj.mean() - 1.0) <= 1e-4
    # a closest hit a lane, and one shadow ray a gathering lane and slot
    assert n * (1 + int(vt.count[row])) >= int(rays) > n * 2


def test_gather_split_changes_nothing(cornell, monkeypatch):
    """The gather's shadow rays split into calls of at most
    GATHER_MAX_RAYS rays by slots: a split changes no lane's radiance."""
    _, _, td, ts = cornell
    vpls = tir.generate_vpls(td, ts, 3, 1)
    row = int(vpls.count.argmax())
    ids = torch.arange(SIZE * SIZE)
    px, py = ids % SIZE, ids // SIZE
    whole, rays = tir.render_lanes(td, ts, 3, 1, px, py, vpls, row, True)
    monkeypatch.setattr(tir, "GATHER_MAX_RAYS", 2 * SIZE * SIZE)
    split, rays_split = tir.render_lanes(td, ts, 3, 1, px, py, vpls, row, True)
    assert int(vpls.count[row]) > 2
    assert torch.equal(whole, split) and int(rays) == int(rays_split)


def test_ir_matches_pt():
    host = _host(tp.PORT_SCENES["cornell"], SIZE)
    r_ir = Renderer(host, device="cpu", integrator=IntegratorType.IR,
                    max_depth=5)
    r_ir.render(8)
    r_pt = Renderer(host, seed=1, device="cpu", integrator=IntegratorType.PT,
                    max_depth=5)
    r_pt.render(16)
    a, b = r_ir.radiance(), r_pt.radiance()
    assert r_ir.kind == "ir" and np.isfinite(a).all()
    assert 0.5 < a.mean() / b.mean() < 1.5, a.mean() / b.mean()
    assert int(r_ir.rays) > 8 * SIZE * SIZE
