"""Render checkpoints of the port (run/checkpoint.py) on the CPU,
cornell_port at 16x16, depth 3 (VPT on smoke_port):
- a render interrupted after 2 iterations, saved, and resumed by a new
  Renderer for 2 more equals the uninterrupted one bit for bit, for
  every integrator (IR resumed between two VPL regenerations: the
  store made at iteration 1 is restored, not drawn again);
- the fingerprint guard: a file of another depth or integrator raises
  ValueError;
- against the JAX package (both forced onto the numpy BVH builder,
  tests/torch_parity.py): the two `_fingerprint`s agree on the same
  scene and config, and a file written by either package's
  `save_checkpoint` loads into the other's Renderer with acc, the
  iteration and SPPM's, IR's and MLT's fields equal (the state is filled
  with seeded numpy arrays, not rendered).
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu_torch.run import checkpoint as ckpt
from gpu_pathtracer_tpu_torch.run.renderer import Renderer
from gpu_pathtracer_tpu_torch.scene.model import IntegratorType

SIZE = 16
DEPTH = 3
PHOTONS = 4096
SCENES = {"cornell": tp.PORT_SCENES["cornell"], "smoke": tp.SMOKE_SCENE}
RESUMED = {"ao": "cornell", "pt": "cornell", "vpt": "smoke", "lt": "cornell",
           "bdpt": "cornell", "ir": "cornell", "sppm": "cornell",
           "mlt": "cornell"}


def _host(scene="cornell", package="port"):
    if package == "port":
        from gpu_pathtracer_tpu_torch.scene.parse import load_scene
    else:
        from gpu_pathtracer_tpu.scene.parse import load_scene
    host = load_scene(str(SCENES[scene]))
    host.width = host.height = SIZE
    return host


def _port(integ, scene="cornell", depth=DEPTH, seed=4):
    return Renderer(_host(scene), seed=seed, device="cpu", cache=False,
                    integrator=IntegratorType[integ.upper()],
                    max_depth=depth, photons_per_iteration=PHOTONS)


def _jax(integ, scene="cornell", seed=4):
    from gpu_pathtracer_tpu.run.renderer import Renderer as JaxRenderer
    from gpu_pathtracer_tpu.scene.model import IntegratorType as JaxType
    return JaxRenderer(_host(scene, "jax"), seed=seed, cache=False,
                       integrator=JaxType[integ.upper()], max_depth=DEPTH,
                       photons_per_iteration=PHOTONS)


@pytest.mark.parametrize("integ", list(RESUMED))
def test_resume_bit_equal(tmp_path, integ):
    path = str(tmp_path / "ck.npz")
    a = _port(integ, RESUMED[integ])
    a.render(2)
    ckpt.save_checkpoint(a, path)
    a.render(2)

    b = _port(integ, RESUMED[integ])
    ckpt.load_checkpoint(b, path)
    assert b.iteration == 2
    b.render(2)
    np.testing.assert_array_equal(b.radiance(), a.radiance())
    assert np.isfinite(a.radiance()).all() and a.radiance().sum() > 0
    if integ == "ir":   # iterations 3 and 4 gathered the restored store
        for k in ckpt.VPL_FIELDS:
            assert torch.equal(getattr(b._vpls, k), getattr(a._vpls, k))
    if integ == "mlt":
        for k in ckpt.MLT_FIELDS:
            assert torch.equal(b._mlt_state[k], a._mlt_state[k]), k


def test_fingerprint_guard(tmp_path):
    path = str(tmp_path / "ck.npz")
    a = _port("pt")
    a.render(1)
    ckpt.save_checkpoint(a, path)
    for wrong in (_port("pt", depth=DEPTH + 1), _port("ao")):
        with pytest.raises(ValueError):
            ckpt.load_checkpoint(wrong, path)


@pytest.mark.parametrize("integ, scene", [("pt", "cornell"),
                                          ("sppm", "cornell"),
                                          ("vpt", "smoke")])
def test_fingerprint_matches_jax(integ, scene, monkeypatch):
    from gpu_pathtracer_tpu.run import checkpoint as jckpt
    tp.numpy_bvh_builder(monkeypatch)
    assert ckpt._fingerprint(_port(integ, scene)) \
        == jckpt._fingerprint(_jax(integ, scene))


def _state(integ, d):
    """Seeded numpy arrays of the kind's state: {field: array}."""
    rs = np.random.RandomState(11)
    n = SIZE * SIZE

    def f(*shape):
        return rs.uniform(-1, 1, shape).astype(np.float32)

    def i(hi, *shape):
        return rs.randint(-1, hi, shape).astype(np.int32)

    if integ == "sppm":
        out = {k: f(n, 3) for k in ("ld", "ind", "beta", "dir", "pos", "nor",
                                    "dpdu", "tau")}
        return dict(out, uv=f(n, 2), mat_idx=i(8, n), radius=f(n), n=f(n),
                    valid=rs.uniform(size=n) < 0.5)
    if integ == "ir":
        out = {k: f(32, 32, 3) for k in ("beta", "dir", "pos", "nor",
                                         "dpdu")}
        return dict(out, uv=f(32, 32, 2), mat_idx=i(8, 32, 32), pdf0=f(32),
                    count=i(33, 32))
    return dict(u=f(d, n), lum=f(n), li=f(n, 3), px=i(SIZE, n),
                py=i(SIZE, n), film=f(n, 3), b_sum=f(), b_cnt=f(),
                steps=f())


PREFIX = {"sppm": "sppm", "ir": "vpl", "mlt": "mlt"}


def _fill_jax(r, integ, arrays):
    import jax.numpy as jnp
    from gpu_pathtracer_tpu.integrators import ir as jir
    from gpu_pathtracer_tpu.integrators import sppm as jsppm
    state = {k: jnp.asarray(v) for k, v in arrays.items()}
    if integ == "sppm":
        r._sppm_state = jsppm.SppmState(**state)
    elif integ == "ir":
        r._vpls = jir.VplStore(**state)
    else:
        r._mlt_state = state


def _fill_port(r, integ, arrays):
    from gpu_pathtracer_tpu_torch.integrators import ir, mlt, sppm
    if integ == "sppm":
        r._sppm_state = sppm.state_from_numpy(arrays, "cpu")
    elif integ == "ir":
        r._vpls = ir.vpls_from_numpy(arrays, "cpu")
    else:
        r._mlt_state = mlt.state_from_numpy(arrays, "cpu")


def _read(r, integ) -> dict:
    """The kind's state of either package's Renderer as numpy arrays."""
    st = getattr(r, {"sppm": "_sppm_state", "ir": "_vpls",
                     "mlt": "_mlt_state"}[integ])
    return {k: np.asarray(st[k] if isinstance(st, dict) else getattr(st, k))
            for k in _fields(integ)}


def _fields(integ):
    return {"sppm": ckpt.SPPM_FIELDS, "ir": ckpt.VPL_FIELDS,
            "mlt": ckpt.MLT_FIELDS}[integ]


@pytest.mark.parametrize("integ", ["sppm", "ir", "mlt"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_loads_in_the_other_package(tmp_path, monkeypatch, writer,
                                         integ):
    """The npz layout is shared: a file of one package loads into the
    other's Renderer field for field, dtypes included."""
    from gpu_pathtracer_tpu.run import checkpoint as jckpt
    from gpu_pathtracer_tpu_torch.integrators import mlt
    tp.numpy_bvh_builder(monkeypatch)
    path = str(tmp_path / "ck.npz")
    src, dst = _jax(integ), _port(integ)
    if writer == "port":
        src, dst = dst, src
    arrays = _state(integ, mlt.n_dims(_port(integ).static))
    acc = np.random.RandomState(12).uniform(
        0, 2, (SIZE * SIZE, 3)).astype(np.float32)
    if writer == "jax":
        import jax.numpy as jnp
        _fill_jax(src, integ, arrays)
        src.acc, src.iteration = jnp.asarray(acc), 5
        jckpt.save_checkpoint(src, path)
        ckpt.load_checkpoint(dst, path)
        got, got_acc = _read(dst, integ), dst.acc.numpy()
    else:
        _fill_port(src, integ, arrays)
        src.acc, src.iteration = torch.as_tensor(acc), 5
        ckpt.save_checkpoint(src, path)
        jckpt.load_checkpoint(dst, path)
        got, got_acc = _read(dst, integ), np.asarray(dst.acc)
    with np.load(path) as f:
        assert {k[len(PREFIX[integ]) + 1:] for k in f.files
                if k.startswith(PREFIX[integ] + "_")} == set(arrays)
    assert dst.iteration == 5
    np.testing.assert_array_equal(got_acc, acc)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype, (k, got[k].dtype, v.dtype)
        np.testing.assert_array_equal(got[k], v, err_msg=k)
