"""Ambient occlusion: the port's AO against the JAX package's, on the CPU.

Lane by lane: both packages trace the same 32x32 lanes on the same
tables, drawing from one explicit primary-sample matrix u [6, N] (rows
0-3 the camera, 4-5 the probe; the JAX module's `RngStream` is replaced
by a stream that serves the rows of u). AO must agree within atol 1e-4 +
rtol 1e-3 on >= 99% of lanes (a float32 difference can flip a grazing
probe), and the mean over lanes within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.core.rng import PrimarySampleStream
from gpu_pathtracer_tpu.integrators import ao as jao
from gpu_pathtracer_tpu_torch.integrators import ao as tao
from gpu_pathtracer_tpu_torch.run.renderer import Renderer
from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
from gpu_pathtracer_tpu_torch.scene.parse import load_scene
from test_torch_render import ENV, _decode_png

SIZE = 32


def _lanes(n):
    px = np.arange(n, dtype=np.int32) % SIZE
    py = np.arange(n, dtype=np.int32) // SIZE
    return px, py


@pytest.mark.parametrize("scene", ["cornell", "knot"])
def test_ao_matches_jax_lane_by_lane(scene, monkeypatch, tmp_path):
    """cornell_port (K1's regime) and a 2,000-triangle knot (K3's)."""
    path = tp.PORT_SCENES["cornell"] if scene == "cornell" else \
        tp.write_knot_scene(tmp_path, n_seg=50, n_ring=20)
    jd, js = tp.jax_flatten(path, monkeypatch, size=SIZE)
    td, ts = tp.port_scene_from_jax(jd, js)
    assert ts.max_dist == js.max_dist == 0.5
    px, py = _lanes(SIZE * SIZE)
    u = np.random.default_rng(11).random((tao.AO_DIMS, px.size),
                                         dtype=np.float32)
    monkeypatch.setattr(jao, "RngStream",
                        lambda key: PrimarySampleStream(jnp.asarray(u)))
    lj = np.asarray(jao.render_lanes(jd, js, jax.random.PRNGKey(0),
                                     jnp.asarray(px), jnp.asarray(py)))
    lt, rays = tao.render_lanes(td, ts, 0, 1, torch.as_tensor(px),
                                torch.as_tensor(py), True,
                                psample=torch.as_tensor(u))
    lt = lt.numpy()
    assert lt.shape == (px.size, 3) and np.isfinite(lt).all()
    assert tp.close_lanes(lt, lj).mean() >= 0.99
    assert abs(lt.mean() / lj.mean() - 1.0) <= 1e-3
    assert 0.1 < lj.mean() < 1.5
    assert px.size < int(rays) <= 2 * px.size   # a probe per hit lane


@pytest.mark.parametrize("max_dist", [0.05, 2.0])
def test_max_dist_bounds_the_probe(max_dist, tmp_path):
    """StaticConfig.max_dist is the scene's maxDist, and a longer probe
    finds more occluders: the image darkens."""
    import dataclasses
    host = load_scene(str(tp.PORT_SCENES["cornell"]))
    host.integrator.maxDist = max_dist
    host.width = host.height = 16
    scene, static = flatten_scene(host, "cpu")
    assert static.max_dist == np.float32(max_dist)
    ids = torch.arange(16 * 16, dtype=torch.int32)
    px, py = ids % 16, ids // 16
    short = tao.render_lanes(scene, dataclasses.replace(
        static, max_dist=max_dist / 10), 0, 1, px, py)
    full = tao.render_lanes(scene, static, 0, 1, px, py)
    assert (full <= short + 1e-6).all()
    assert full.mean() < short.mean()


def test_ao_tiling_independent():
    """The image depends on (seed, iteration, pixel) only: tiles of 64
    and of 24 lanes give the same film bit for bit."""
    host = load_scene(str(tp.PORT_SCENES["cornell"]))
    host.width = host.height = 16

    def frame(tile):
        r = Renderer(host, tile_size=tile, seed=3, device="cpu",
                     integrator=IntegratorType.AO, cache=False)
        r.render(2)
        return r.acc.numpy(), int(r.rays)

    (a, ra), (b, rb) = frame(64), frame(24)
    np.testing.assert_array_equal(a, b)
    assert ra == rb and a.mean() > 0.1


@pytest.mark.parametrize("integrator", ["ao", "lt", "bdpt"])
def test_cli_renders_new_integrators(tmp_path, integrator):
    """`--integrator ao|lt|bdpt` render through the CLI on the CPU."""
    import subprocess
    import sys
    out = tmp_path / "r.png"
    r = subprocess.run(
        [sys.executable, "-m", "gpu_pathtracer_tpu_torch.run.cli",
         str(tp.PORT_SCENES["cornell"]), "--integrator", integrator,
         "--device", "cpu", "--size", "8", "--spp", "2", "--out", str(out)],
        cwd=tmp_path, env=ENV, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert f"integrator={integrator.upper()}" in r.stdout
    assert "2 spp" in r.stdout and "Mrays/s" in r.stdout
    w, h, raw = _decode_png(out.read_bytes())
    assert (w, h) == (8, 8) and len(raw) == h * (1 + 3 * w)
