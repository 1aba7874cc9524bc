"""The slice as a whole: path tracing, JAX package vs port, lane by lane.

Both packages trace the same 32x32 lanes on the same tables from the
same primary-sample matrix psample [4 + 8 * depth, N] (the JAX
wavefront's fixed-uniform input, integrators/pt.py:101-139). Radiance
must agree within atol 1e-4 + rtol 1e-3 on >= 99% of lanes (a float32
difference can flip a grazing hit and send one path elsewhere), and the
mean over lanes within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.integrators import pt as jpt
from gpu_pathtracer_tpu_torch.core.rng import PSS_BOUNCE_DIMS, PSS_CAM_DIMS
from gpu_pathtracer_tpu_torch.integrators import pt, pt_fused

SIZE = 32


@pytest.fixture(params=["cornell", "materials", "many_lights"])
def scenes(request, monkeypatch):
    path = tp.PORT_SCENES.get(request.param, tp.MANY_LIGHTS)
    jd, js = tp.jax_flatten(path, monkeypatch, size=SIZE)
    td, ts = tp.port_scene_from_jax(jd, js)
    n = SIZE * SIZE
    px = np.arange(n, dtype=np.int32) % SIZE
    py = np.arange(n, dtype=np.int32) // SIZE
    return jd, js, td, ts, px, py


def _psample(static, n, seed):
    d = PSS_CAM_DIMS + static.max_depth * PSS_BOUNCE_DIMS
    return np.random.default_rng(seed).random((d, n), dtype=np.float32)


def test_render_lanes_match_jax(scenes):
    jd, js, td, ts, px, py = scenes
    u = _psample(ts, px.size, 5)
    lj = np.asarray(jpt.render_lanes(jd, js, jax.random.PRNGKey(0),
                                     jnp.asarray(px), jnp.asarray(py),
                                     psample=jnp.asarray(u)))
    lt = pt.render_lanes(td, ts, 0, 1, torch.as_tensor(px),
                         torch.as_tensor(py), psample=torch.as_tensor(u))
    lt = lt.numpy()
    assert lt.shape == (px.size, 3) and np.isfinite(lt).all()
    assert tp.close_lanes(lt, lj).mean() >= 0.99
    assert abs(lt.mean() / lj.mean() - 1.0) <= 1e-3
    assert lj.mean() > 0.01


@pytest.mark.parametrize("sample", ["psample", "philox"])
def test_fused_on_cpu_is_the_plain_version(scenes, sample):
    _, _, td, ts, px, py = scenes
    px, py = torch.as_tensor(px), torch.as_tensor(py)
    u = (torch.as_tensor(_psample(ts, px.numel(), 6))
         if sample == "psample" else None)
    a, ra = pt_fused.render_lanes(td, ts, 3, 2, px, py, True, u)
    b, rb = pt_fused.render_lanes_torch(td, ts, 3, 2, px, py, True, u)
    c, rc = pt.render_lanes(td, ts, 3, 2, px, py, True, u)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert int(ra) == int(rb) == int(rc)
    # closest rays: one per lane and bounce at most, plus the epilogue;
    # shadow rays: one per lane and bounce at most
    n = px.numel()
    assert n < int(ra) <= n * (2 * ts.max_depth + 1)


def test_philox_render_is_keyed_by_pixel(scenes):
    """A lane's draws depend on (seed, iteration, pixel) only: rendering
    the lanes in two halves, in another order, gives the same radiance;
    another iteration gives other samples."""
    _, _, td, ts, px, py = scenes
    px, py = torch.as_tensor(px), torch.as_tensor(py)
    whole = pt.render_lanes(td, ts, 9, 4, px, py)
    perm = torch.randperm(px.numel(), generator=torch.Generator()
                          .manual_seed(0))
    half = px.numel() // 2
    parts = torch.empty_like(whole)
    for idx in (perm[:half], perm[half:]):
        parts[idx] = pt.render_lanes(td, ts, 9, 4, px[idx], py[idx])
    assert torch.equal(whole, parts)
    other = pt.render_lanes(td, ts, 9, 5, px, py)
    assert not torch.equal(whole, other)
