"""Volumetric path tracing: the port's VPT against the JAX package's, on
the CPU.

The two packages draw from different generators (Philox vs threefry and
jax.random.poisson), so images are compared as estimates: for every
compared quantity (the image mean per channel and the 4x4-pixel block
means per channel) each run gives one value per spp, and the two means
must agree within 5 standard errors of their difference, the standard
errors taken from the runs' own per-spp spread. Two unbiased estimators
of the same image pass that with near certainty; a biased one (a wrong
weight, a missed medium, a wrong crossing side) moves whole blocks by
many standard errors.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp
from test_torch_render import ENV, _decode_png

SPP = 32


def _frames_port(host, spp, **kw):
    """[spp, H, W, 3] per-spp radiance of the port's Renderer."""
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    r = Renderer(host, seed=1, device="cpu", **kw)
    out = []
    for _ in range(spp):
        prev = r.acc.clone()
        r.render_iteration()
        out.append((r.acc - prev).numpy())
    return np.stack(out).reshape(spp, r.height, r.width, 3), r


def _frames_jax(host, spp):
    from gpu_pathtracer_tpu.run.renderer import Renderer as JaxRenderer
    r = JaxRenderer(host, seed=1, cache=False)
    out = []
    for _ in range(spp):
        prev = np.asarray(r.acc)
        r.render_iteration()
        out.append(np.asarray(r.acc) - prev)
    return np.stack(out).reshape(spp, r.height, r.width, 3)


def _stats(frames):
    """Per-spp values [spp, Q]: the image mean per channel, then the 4x4
    block means per channel."""
    s, h, w, _ = frames.shape
    blocks = frames.reshape(s, h // 4, 4, w // 4, 4, 3).mean((2, 4))
    return np.concatenate([frames.mean((1, 2)), blocks.reshape(s, -1)], 1)


def _assert_same_estimate(a, b):
    """a, b: [spp, Q] per-spp values of two independent runs."""
    qa, qb = _stats(a), _stats(b)
    se = np.hypot(qa.std(0, ddof=1) / np.sqrt(len(qa)),
                  qb.std(0, ddof=1) / np.sqrt(len(qb)))
    z = np.abs(qa.mean(0) - qb.mean(0)) / np.maximum(se, 1e-12)
    assert z.max() <= 5.0, (z.max(), int(z.argmax()), qa.mean(0)[:3],
                            qb.mean(0)[:3])
    return z


def _host(path, size, loader="port", edit=None, tmp_path=None):
    """The scene at `path` at size x size, loaded by either package;
    with `edit`, after `edit(doc)` of its JSON, written to `tmp_path` with
    absolute mesh and density paths."""
    if loader == "port":
        from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    else:
        from gpu_pathtracer_tpu.scene.parse import load_scene
    if edit is not None:
        doc = json.loads(path.read_text())
        for unit in doc["scene"] + doc["light"]:
            if "mesh" in unit:
                unit["mesh"] = str(path.parent / unit["mesh"])
        for med in doc.get("medium", []):
            if "density" in med:
                med["density"] = str(path.parent / med["density"])
        edit(doc)
        path = tmp_path / f"edited_{loader}.json"
        path.write_text(json.dumps(doc))
    host = load_scene(str(path))
    host.width = host.height = size
    return host


def test_vpt_matches_jax_on_smoke():
    """smoke_port (heterogeneous smoke, HG fog, two interfaces) at 16x16,
    32 spp each."""
    a, r = _frames_port(_host(tp.SMOKE_SCENE, 16), SPP)
    b = _frames_jax(_host(tp.SMOKE_SCENE, 16, "jax"), SPP)
    z = _assert_same_estimate(a, b)
    assert np.isfinite(a).all() and a.mean() > 0.01
    assert int(r.rays) > SPP * 256   # closest hits and Tr-walk segments
    assert np.median(z) < 2.0


def test_vpt_without_media_matches_pt():
    """On the media-free Cornell box VPT estimates the same image as PT."""
    host = _host(tp.PORT_SCENES["cornell"], 16)
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    a, _ = _frames_port(host, SPP, integrator=IntegratorType.VPT)
    b, _ = _frames_port(host, SPP, integrator=IntegratorType.PT)
    _assert_same_estimate(a, b)
    assert not np.array_equal(a, b)   # two estimators, other draws


def _fog_camera(doc):
    """smoke_port without the smoke, the camera inside the fog sphere
    looking at the back wall (pathtracer.cu:1043)."""
    doc["medium"] = [m for m in doc["medium"] if m["name"] == "fog"]
    doc["scene"] = [u for u in doc["scene"] if u.get("inside") != "smoke"]
    doc["camera"].update(position=[0.5, 0.45, 0.7], lookat=[0.0, 1.0, -1.0],
                         fov=60, medium="fog")


def test_vpt_camera_inside_fog_matches_jax(tmp_path):
    a, r = _frames_port(_host(tp.SMOKE_SCENE, 8, edit=_fog_camera,
                              tmp_path=tmp_path), SPP)
    assert r.static.camera_medium == 0 and not r.static.has_hetero
    b = _frames_jax(_host(tp.SMOKE_SCENE, 8, "jax", _fog_camera, tmp_path),
                    SPP)
    _assert_same_estimate(a, b)
    assert np.isfinite(a).all() and a.mean() > 0.01


def test_vpt_tiling_independent():
    """The image depends on (seed, iteration, pixel) only: tiles of 64
    and of 24 lanes give the same film bit for bit."""
    host = _host(tp.SMOKE_SCENE, 8)
    a, _ = _frames_port(host, 2, tile_size=64)
    b, _ = _frames_port(host, 2, tile_size=24)
    np.testing.assert_array_equal(a, b)
    assert a.sum() > 0 and torch.isfinite(torch.as_tensor(a)).all()


def test_cli_vpt_writes_png(tmp_path):
    out = tmp_path / "v.png"
    r = subprocess.run(
        [sys.executable, "-m", "gpu_pathtracer_tpu_torch.run.cli",
         str(tp.SMOKE_SCENE), "--integrator", "vpt", "--device", "cpu",
         "--size", "8", "--spp", "2", "--out", str(out)],
        cwd=tmp_path, env=ENV, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "integrator=VPT" in r.stdout and "2 spp" in r.stdout
    w, h, raw = _decode_png(out.read_bytes())
    assert (w, h) == (8, 8) and len(raw) == h * (1 + 3 * w)


@pytest.mark.parametrize("integrator", ["sppm", "mlt"])
def test_cli_refuses_unported_integrators(tmp_path, integrator):
    """The CLI refused SPPM and MLT until they were ported: it now renders
    them, and, since multi-GPU rendering was ported, renders them with
    `--shard` too (a world of 1 without torchrun)."""
    args = [sys.executable, "-m", "gpu_pathtracer_tpu_torch.run.cli",
            str(tp.PORT_SCENES["cornell"]), "--integrator", integrator,
            "--device", "cpu", "--size", "8", "--spp", "1", "--out",
            str(tmp_path / "r.png")]
    r = subprocess.run(args, cwd=tmp_path, env=ENV, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert f"integrator={integrator.upper()}" in r.stdout
    r = subprocess.run(args + ["--shard"], cwd=tmp_path, env=ENV,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "[shard] 1 rank" in r.stdout and "[out] wrote" in r.stdout
