"""End to end on the CPU: the port's CLI and Renderer, its independence
from JAX, and chip_smoke.py's refusal to run without a GPU."""

import os
import struct
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest

import torch_parity as tp

ENV = dict(os.environ, PYTHONPATH=str(tp.REPO))


def _run(args, cwd, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


def _decode_png(data: bytes):
    """(width, height, rows) of an 8-bit RGB PNG, rows zlib-inflated."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc[0] == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + length
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2)
    return w, h, zlib.decompress(chunks[b"IDAT"])


def test_cli_writes_png(tmp_path):
    out = tmp_path / "r.png"
    exr = tmp_path / "r.exr"
    r = _run(["-m", "gpu_pathtracer_tpu_torch.run.cli",
              str(tp.PORT_SCENES["cornell"]), "--device", "cpu", "--size",
              "32", "--spp", "16", "--out", str(out), "--exr", str(exr)],
             tmp_path)
    assert r.returncode == 0, r.stderr
    assert "16 spp" in r.stdout and "Mrays/s" in r.stdout
    w, h, raw = _decode_png(out.read_bytes())
    assert (w, h) == (32, 32) and len(raw) == h * (1 + 3 * w)
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all() and rows[:, 1:].mean() > 20
    assert exr.read_bytes()[:4] == struct.pack("<i", 20000630)


@pytest.mark.parametrize("args, words", [
    (["--device", "cuda"], "CUDA"),
    pytest.param(["--device", "cpu", "--shard"], "[shard] 1 rank",
                 id="args1-ROADMAP"),
    pytest.param(["--device", "cpu", "--checkpoint", "c.npz"],
                 "[resume] c.npz @ 1", id="args2-ROADMAP"),
    pytest.param(["--device", "cpu", "--checkpoint", "ck"],
                 "[resume] ck @ 1 spp", id="checkpoint-without-suffix"),
])
def test_cli_refuses(tmp_path, args, words):
    """The CLI refuses a CUDA device that is absent. It refused
    `--shard` and `--checkpoint` until they were ported (the cases keep
    the ids of those refusals): without torchrun `--shard` renders as a
    world of 1, and a second run with `--checkpoint` resumes from the
    file the first wrote, under the name it was given (numpy adds no
    ".npz" to a path without it)."""
    if "cuda" in args:
        import torch
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA device")
    cmd = ["-m", "gpu_pathtracer_tpu_torch.run.cli",
           str(tp.PORT_SCENES["cornell"]), "--size", "8", "--spp", "1",
           *args]
    if "cuda" in args:
        r = _run(cmd, tmp_path)
        assert r.returncode != 0
        assert words in r.stderr
        return
    if "--checkpoint" in args:
        path = args[args.index("--checkpoint") + 1]
        r = _run(cmd, tmp_path)
        assert r.returncode == 0, r.stderr
        assert f"[out] checkpoint {path} @ 1 spp" in r.stdout
        cmd[cmd.index("--spp") + 1] = "2"
    r = _run(cmd, tmp_path)
    assert r.returncode == 0, r.stderr
    assert words in r.stdout and "[out] wrote" in r.stdout
    if "--checkpoint" in args:
        assert sorted(p.name for p in tmp_path.iterdir()
                      if p.suffix != ".png") == [path]


def test_cli_profile_and_hbm(tmp_path):
    """`--profile DIR` writes a torch.profiler Chrome trace of the render
    loop into DIR; the `[hbm]` line gives the scene tables' memory by
    category."""
    r = _run(["-m", "gpu_pathtracer_tpu_torch.run.cli",
              str(tp.PORT_SCENES["cornell"]), "--device", "cpu", "--size",
              "8", "--spp", "1", "--profile", "prof"], tmp_path)
    assert r.returncode == 0, r.stderr
    trace = tmp_path / "prof" / "trace_rank0.json"
    assert trace.exists() and "[profile] trace in prof" in r.stdout
    import json
    assert json.loads(trace.read_text())["traceEvents"]
    hbm = [ln for ln in r.stdout.splitlines() if ln.startswith("[hbm] ")]
    assert len(hbm) == 1
    mb = dict(part.rsplit(" ", 2)[:2] for part in hbm[0][6:].split(", "))
    assert list(mb) == ["geometry", "bvh", "materials", "lights",
                        "textures", "env", "media"]
    assert float(mb["geometry"]) > 0 and float(mb["bvh"]) > 0


def test_scene_bytes_cover_every_table():
    """The [hbm] categories add up to every tensor of the DeviceScene."""
    from gpu_pathtracer_tpu_torch.run import cli
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    r = Renderer(str(tp.PORT_SCENES["cornell"]), device="cpu", cache=False)
    got = cli.scene_bytes(r.device_scene)
    import dataclasses
    import torch
    total = sum(v.numel() * v.element_size()
                for f in dataclasses.fields(r.device_scene)
                if isinstance(v := getattr(r.device_scene, f.name),
                              torch.Tensor))
    assert sum(got.values()) == total
    assert got["lights"] == sum(
        t.numel() * t.element_size() for t in (
            r.device_scene.light_attrs, r.device_scene.light_cdf,
            *(getattr(r.device_scene, f"l_{k}") for k in (
                "v0", "v1", "v2", "n0", "n1", "n2", "radiance",
                "medium"))))


@pytest.mark.parametrize("integrator", ["ir", "sppm", "mlt"])
def test_cli_integrator_writes_png(tmp_path, integrator):
    """The last three integrators through the CLI, with SPPM's options."""
    out = tmp_path / "r.png"
    r = _run(["-m", "gpu_pathtracer_tpu_torch.run.cli",
              str(tp.PORT_SCENES["cornell"]), "--device", "cpu", "--size",
              "8", "--spp", "2", "--integrator", integrator, "--photons",
              "2048", "--init-radius", "0.3", "--out", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr
    assert f"integrator={integrator.upper()}" in r.stdout
    assert "2 spp" in r.stdout and "Mrays/s" in r.stdout
    w, h, raw = _decode_png(out.read_bytes())
    assert (w, h) == (8, 8)
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert rows[:, 1:].mean() > 5


@pytest.mark.parametrize("integrator", ["pt", "ir", "sppm", "mlt"])
def test_reset_restarts(integrator):
    """reset() restarts the film and every integrator's state (SPPM's
    visible points, IR's VPL store, MLT's chains): the next iterations
    repeat the first ones bit for bit."""
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    host = load_scene(str(tp.PORT_SCENES["cornell"]))
    host.width = host.height = 8
    r = Renderer(host, device="cpu", max_depth=3, photons_per_iteration=512,
                 integrator=IntegratorType[integrator.upper()])
    r.render(2)
    first = r.radiance()
    r.reset()
    assert r.iteration == 0 and not r.acc.any()
    r.render(2)
    np.testing.assert_array_equal(r.radiance(), first)
    assert first.sum() > 0


def test_renderer_matches_jax_statistically():
    """Radiance means at 64 spp within 5% per channel: the packages draw
    from different generators (threefry vs Philox), so this is a check
    of the estimator, not of the samples."""
    import torch

    from gpu_pathtracer_tpu.run.renderer import Renderer as JaxRenderer
    from gpu_pathtracer_tpu.scene.parse import load_scene as jload
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene

    path = str(tp.PORT_SCENES["cornell"])
    host = load_scene(path)
    host.width = host.height = 32
    r = Renderer(host, seed=1, device="cpu")
    r.render(64)
    jhost = jload(path)
    jhost.width = jhost.height = 32
    jr = JaxRenderer(jhost, seed=1, cache=False)
    jr.render(64)
    m = r.radiance().reshape(-1, 3).mean(0)
    jm = np.asarray(jr.radiance()).reshape(-1, 3).mean(0)
    assert np.all(np.abs(m / jm - 1.0) <= 0.05), (m, jm)
    assert int(r.rays) > 64 * 32 * 32
    assert r.image().shape == (32, 32, 3) and torch.isfinite(r.acc).all()


def test_port_runs_without_jax(tmp_path):
    """A meta-path hook refuses JAX, flax, ml_dtypes, PIL and the JAX
    package; the port still imports and renders one spp, and its bench
    (run/bench.py) runs a row in this process."""
    script = textwrap.dedent(f"""
        import sys
        BLOCKED = ("jax", "jaxlib", "flax", "ml_dtypes", "PIL",
                   "gpu_pathtracer_tpu")
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("refused: " + name)
                return None
        sys.meta_path.insert(0, Refuse())
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]
        from gpu_pathtracer_tpu_torch.run.renderer import Renderer
        from gpu_pathtracer_tpu_torch.scene.parse import load_scene
        host = load_scene({str(tp.PORT_SCENES['materials'])!r})
        host.width = host.height = 16
        r = Renderer(host, device="cpu")
        r.render(1)
        print("rendered", float(r.acc.mean()))
        from gpu_pathtracer_tpu_torch.run import bench
        bench.main(["--row", "cornell", "--device", "cpu", "--size", "8",
                    "--windows", "1", "--min-spp", "1", "--min-seconds",
                    "0"])
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    """)
    r = _run(["-c", script], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "rendered" in r.stdout
    import json
    (row,) = [json.loads(ln[4:]) for ln in r.stdout.splitlines()
              if ln.startswith("ROW ")]
    assert row["correct"] is True and row["value"] > 0


def test_chip_smoke_needs_a_gpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _run([str(tp.REPO / "chip_smoke.py")], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "chip_smoke.py").write_bytes(
        (tp.REPO / "chip_smoke.py").read_bytes())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                       capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
