"""The port's golden-image runner (gpu_pathtracer_tpu_torch/run/golden.py)
against the JAX package's (gpu_pathtracer_tpu/run/golden.py), both on
the CPU: the PNG read and the resample that replace PIL, the mask, the
light rescale, `run_one` end to end and `main`'s exit codes and JSON."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_parity as tp
from gpu_pathtracer_tpu.run import golden as jg
from gpu_pathtracer_tpu_torch.film.imageio import save_png
from gpu_pathtracer_tpu_torch.run import golden as tg

CORNELL = str(tp.PORT_SCENES["cornell"])
GRAPH_PAPER = tp.REPO / "scenes" / "teapot" / "graph_paper.png"
# run_one's renders: the packages draw from different generators
# (threefry vs Philox), so their images differ by Monte Carlo noise
# alone; at 256 spp that is RMSE 0.0175 at 16^2 (0.14 at 4 spp)
E2E_SPP = 256


@pytest.mark.parametrize("shape, size", [
    ((64, 64), (64, 64)),       # identity
    ((128, 128), (64, 64)),     # integer factor 2
    ((256, 1024), (64, 256)),   # integer factor 4, not square
    ((720, 1280), (256, 455)),  # 16:9 at 256 high: PIL's BOX
    ((300, 500), (256, 256)),   # a factor per axis, neither an integer
    ((512, 512), (200, 200)),
])
def test_downsample_bit_equal(shape, size):
    img = np.random.default_rng(sum(shape)).random(
        (*shape, 3)).astype(np.float32)
    img[:4] *= 1.5   # values past 1 are clipped before the 8-bit resample
    got = tg._downsample(img, *size)
    ref = jg._downsample(img, *size)
    assert got.shape == ref.shape == (*size, 3) and got.dtype == ref.dtype
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "file"])
def test_load_png_equal(tmp_path, mode):
    """PNGs that PIL writes in each mode (P with a 256-colour palette,
    which PIL stores at 8 bits), and the repo's graph paper."""
    from PIL import Image
    if mode == "file":
        path = str(GRAPH_PAPER)
    else:
        rng = np.random.default_rng(7)
        bands = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2, "P": 1}[mode]
        data = rng.integers(0, 256, (21, 34, bands), dtype=np.uint8)
        if mode == "P":
            im = Image.fromarray(data[..., 0], "L").convert("P")
            im.putpalette(rng.integers(0, 256, 768, dtype=np.uint8)
                          .tobytes())
        else:
            im = Image.fromarray(data[..., 0] if bands == 1 else data, mode)
        path = str(tmp_path / f"{mode}.png")
        im.save(path)
    got = tg._load_png(path)
    ref = jg._load_png(path)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size", [64, 100, 256])
def test_smoke_mask_equal(size):
    np.testing.assert_array_equal(tg._smoke_mask(size), jg._smoke_mask(size))


def _quad(path, w, h):
    path.write_text(f"v 0 0 0\nv {w} 0 0\nv {w} {h} 0\nv 0 {h} 0\n"
                    "f 1 2 3 4\n")


def test_scale_vol_caustic_light(tmp_path, monkeypatch):
    """Each package's rescale on its own load of cornell_port, with the
    reference's two light meshes stood in by quads of known area."""
    from gpu_pathtracer_tpu.scene.parse import load_scene as jload
    from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    geo = tmp_path / "cornell_box" / "geometry"
    geo.mkdir(parents=True)
    _quad(geo / "light.obj", 0.5, 0.4)     # area 0.2
    _quad(geo / "mesh_6.obj", 0.1, 0.05)   # area 0.005
    for mod in (tg, jg):
        monkeypatch.setattr(mod, "REF_SCENES", str(tmp_path))
    before = [lt.radiance.copy() for lt in load_scene(CORNELL).lights]
    got = [lt.radiance for lt in tg._scale_vol_caustic_light(
        load_scene(CORNELL)).lights]
    ref = [np.asarray(lt.radiance) for lt in jg._scale_vol_caustic_light(
        jload(CORNELL)).lights]
    assert len(got) == len(ref) == len(before) > 0
    for g, r, b in zip(got, ref, before):
        np.testing.assert_allclose(g, r, rtol=1e-6)
        np.testing.assert_allclose(g / b, 40.0, rtol=1e-6)


def _wide_mask(size):
    """True = compare, over a 16:9 image `size` high: all but the middle
    third of the columns."""
    m = np.ones((size, size * 16 // 9), bool)
    w = m.shape[1]
    m[:, w // 3:2 * w // 3] = False
    return m


@pytest.mark.parametrize("size, aspect, mask", [
    (16, (1, 1), None), (9, (16, 9), _wide_mask)], ids=["square", "wide"])
def test_run_one_against_jax(tmp_path, monkeypatch, size, aspect, mask):
    """The JAX runner's image is the port's golden, and the port's image
    the JAX runner's: the port's RMSE under 0.02 and the two RMSEs
    within 0.01 of each other."""
    tp.numpy_bvh_builder(monkeypatch)
    monkeypatch.setenv("GPT_TPU_CACHE_DIR", str(tmp_path / "jax_cache"))
    w = size * aspect[0] // aspect[1]
    cfg = dict(scene=CORNELL, integrator="pt", gate=0.02, aspect=aspect)
    if mask is not None:
        cfg["mask"] = mask
    blank = str(tmp_path / "blank.png")
    save_png(blank, np.zeros((size, w, 3), np.float32))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jg.run_one("c", dict(cfg, golden=blank), E2E_SPP, size, str(jdir))
    rmse, ok = tg.run_one("c", dict(cfg, golden=str(jdir / "c.png")),
                          E2E_SPP, size, str(pdir), device="cpu")
    rmse_j, _ = jg.run_one("c", dict(cfg, golden=str(pdir / "c.png")),
                           E2E_SPP, size)
    assert tg._load_png(str(pdir / "c.png")).shape == (size, w, 3)
    assert ok and rmse < 0.02, rmse
    assert abs(rmse - rmse_j) < 0.01, (rmse, rmse_j)


@pytest.mark.parametrize("case", ["pass", "fail", "no golden", "no scene"])
def test_main(tmp_path, monkeypatch, capsys, case):
    """Over a GOLDENS of cornell_port alone: a gate of 1.0 exits 0 and
    writes the JSON, a gate of 0.0 exits 1, and a missing golden or
    scene raises FileNotFoundError naming it."""
    golden = str(tmp_path / "cornell.png")
    save_png(golden, np.full((8, 8, 3), 0.5, np.float32))
    cfg = dict(scene=CORNELL, integrator="pt", golden=golden,
               gate=0.0 if case == "fail" else 1.0)
    if case == "no golden":
        cfg["golden"] = str(tmp_path / "absent.png")
    if case == "no scene":
        cfg["scene"] = str(tmp_path / "absent.json")
    monkeypatch.setattr(tg, "GOLDENS", {"cornell": cfg})
    out = tmp_path / "golden.json"
    argv = ["--spp", "1", "--size", "8", "--device", "cpu", "--json",
            str(out)]
    if case.startswith("no "):
        with pytest.raises(FileNotFoundError, match="absent"):
            tg.main(argv)
        assert not out.exists()
        return
    if case == "fail":
        with pytest.raises(SystemExit) as e:
            tg.main(argv)
        assert e.value.code == 1
    else:
        tg.main(argv)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    payload = json.loads(out.read_text())
    assert payload["device"] == "cpu" and "backend" not in payload
    assert payload["all_pass"] is (case == "pass")
    assert payload["results"] == summary
    assert summary["cornell"]["pass"] is (case == "pass")


def test_run_one_needs_the_card(tmp_path):
    """No fallback: device="cuda" without a card raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    golden = str(tmp_path / "g.png")
    save_png(golden, np.zeros((8, 8, 3), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.run_one("c", dict(scene=CORNELL, integrator="pt", golden=golden,
                             gate=1.0), 1, 8)


def test_golden_runs_without_jax_or_pil(tmp_path):
    """The module loads, reads a PNG and resamples with JAX, PIL and the
    JAX package unimportable."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "PIL", "gpu_pathtracer_tpu"):
            sys.modules[name] = None
        import numpy as np
        from gpu_pathtracer_tpu_torch.run import golden
        img = golden._load_png({str(GRAPH_PAPER)!r})
        small = golden._downsample(img[:720, :1280], 256, 455)
        assert small.shape == (256, 455, 3), small.shape
        assert golden.REPO_SCENES == {str(tp.REPO / "scenes")!r}
        print("loaded")
    """)
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=str(tp.REPO)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "loaded" in r.stdout
