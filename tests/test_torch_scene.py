"""Scene ingest parity: the port's parse + flatten vs the JAX package's.

Every DeviceScene field the port has must equal the JAX package's
`flatten_scene(host, cache=False)` field, both when the port flattens the
scene itself and when the JAX fields are carried across with
`device_scene_from_numpy`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu_torch.geom import bvh8
from gpu_pathtracer_tpu_torch.scene import flatten as tf
from gpu_pathtracer_tpu_torch.scene.parse import load_scene


SCENES = tp.REPO / "scenes"
# the scenes with textures and environment lights
SKY_SCENES = {
    "env": SCENES / "env_port" / "scene.json",
    "textured": SCENES / "cornell_port" / "textured.json",
    "mixed": SCENES / "env_port" / "mixed.json",
    "smoke_sky": SCENES / "smoke_port" / "sky.json",
}


@pytest.fixture(params=["cornell", "materials", "many_lights",
                        "sphere_line", "smoke", "bssrdf", "mlt_slit",
                        *SKY_SCENES])
def scene_path(request, tmp_path):
    if request.param == "mlt_slit":   # a mesh of another scene's folder
        return SCENES / "cornell_port" / "mlt_slit.json"
    if request.param == "sphere_line":
        return tp.write_sphere_line_scene(tmp_path)
    if request.param == "many_lights":
        return tp.MANY_LIGHTS
    if request.param == "smoke":
        return tp.SMOKE_SCENE
    if request.param == "bssrdf":   # the BSSRDF table, prim column 32
        return tp.BSSRDF_SCENE
    if request.param in SKY_SCENES:
        return SKY_SCENES[request.param]
    return tp.PORT_SCENES[request.param]


def _port_arrays(scene):
    """DeviceScene -> {field: numpy} (camera fields under "camera")."""
    out = {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if f.name == "camera":
            out[f.name] = {c.name: getattr(v, c.name).numpy()
                           for c in dataclasses.fields(v)}
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.numpy()
        elif f.name != "device":
            out[f.name] = np.float32(v)
    return out


def _assert_fields_equal(port, jax_arrays):
    for name, v in port.items():
        if name == "camera":
            for c, cv in v.items():
                np.testing.assert_array_equal(cv, jax_arrays["camera"][c],
                                              err_msg=f"camera.{c}")
            continue
        if name in ("med_table", "block_sub"):   # derived, the port's own
            continue
        ref = np.asarray(jax_arrays[name])
        assert v.shape == ref.shape, name
        np.testing.assert_array_equal(v, ref.astype(v.dtype), err_msg=name)


def test_flatten_matches_jax(scene_path, monkeypatch):
    jd, js = tp.jax_flatten(scene_path, monkeypatch)
    jax_arrays, jax_static = tp.jax_fields(jd, js)
    scene, static = tf.flatten_scene(load_scene(str(scene_path)), "cpu")
    assert scene.dense_prims.shape[0] >= static.n_primitives
    _assert_fields_equal(_port_arrays(scene), jax_arrays)
    # bvh8_stack is the port's own, derived from the JAX-equal table
    jax_static["bvh8_stack"] = bvh8.stack_bound(
        jax_arrays["bvh8_table"], jax_arrays["bvh8_aux"], js.bvh8_n_inst)
    for name, v in dataclasses.asdict(static).items():
        assert v == jax_static[name], name


def test_device_scene_from_numpy_matches_jax(scene_path, monkeypatch):
    jd, js = tp.jax_flatten(scene_path, monkeypatch)
    jax_arrays, _ = tp.jax_fields(jd, js)
    scene, static = tp.port_scene_from_jax(jd, js)
    _assert_fields_equal(_port_arrays(scene), jax_arrays)
    assert scene.device == torch.device("cpu")
    assert static.n_primitives == js.n_primitives
    assert static.material_types == js.material_types


def test_scenes_fit_the_megakernel():
    from gpu_pathtracer_tpu_torch.integrators import pt_fused
    for path in (*tp.PORT_SCENES.values(), tp.MANY_LIGHTS):
        _, static = tf.flatten_scene(load_scene(str(path)), "cpu")
        assert static.n_primitives <= 512
        assert static.max_depth == 5
        assert pt_fused.supports(static) == (path != tp.MANY_LIGHTS)
        assert static.n_lights == (72 if path == tp.MANY_LIGHTS else 2)


def test_sky_scenes_route():
    """The megakernel takes the scenes with a sky or a texture of <= 512
    prims, with or without area lights; the others take the wavefront."""
    from gpu_pathtracer_tpu_torch.integrators import pt_fused
    for name, path in SKY_SCENES.items():
        _, static = tf.flatten_scene(load_scene(str(path)), "cpu")
        assert static.has_infinite == (name != "textured")
        assert static.has_textures == (name in ("textured", "mixed"))
        assert static.textured_types == ((0,) if static.has_textures
                                         else ())
        assert pt_fused.supports(static)   # (VPT never takes K2)
        assert static.n_lights == {"env": 0, "textured": 2, "mixed": 2,
                                   "smoke_sky": 2}[name]
    # too many prims for it, and no light at all
    st = dataclasses.replace(static, n_primitives=513)
    assert not pt_fused.supports(st)
    st = dataclasses.replace(static, n_primitives=25, n_lights=0,
                             has_infinite=False)
    assert not pt_fused.supports(st)


@pytest.mark.parametrize("feature", ["sppm", "ir"])
def test_unported_features_raise(feature, capsys, tmp_path):
    """SPPM and IR raised here (NotImplementedError) until they were
    ported: the Renderer now builds each as its own kind. The CLI's
    checkpoints around them, refused until they were ported too, now
    save their state (SPPM's visible points, IR's VPL store) and resume
    from it."""
    from gpu_pathtracer_tpu_torch.run import cli
    from gpu_pathtracer_tpu_torch.run.renderer import Renderer
    from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
    host = load_scene(str(tp.PORT_SCENES["cornell"]))
    host.width = host.height = 8
    r = Renderer(host, device="cpu", integrator=IntegratorType[feature.upper()])
    assert r.kind == feature and r.acc.shape == (64, 3)
    path = tmp_path / "c.npz"
    args = [str(tp.PORT_SCENES["cornell"]), "--integrator", feature,
            "--device", "cpu", "--size", "8", "--photons", "1024",
            "--checkpoint", str(path), "--out", str(tmp_path / "r.png")]
    cli.main(args + ["--spp", "1"])
    with np.load(path) as f:
        key = {"sppm": "sppm_radius", "ir": "vpl_count"}[feature]
        assert int(f["iteration"]) == 1 and key in f.files
    res = cli.main(args + ["--spp", "2"])
    assert f"[resume] {path} @ 1 spp" in capsys.readouterr().out
    assert res["renderer"].iteration == 2 and res["spp"] == 1


def test_bssrdf_scene_routes_to_the_wavefront():
    """The megakernel has no subsurface hook: a scene with a BSSRDF
    (which it would otherwise fit) takes the wavefront."""
    from gpu_pathtracer_tpu_torch.integrators import pt_fused
    _, static = tf.flatten_scene(load_scene(str(tp.BSSRDF_SCENE)), "cpu")
    assert static.has_bssrdf and static.n_primitives <= 512
    assert not pt_fused.supports(static)
    assert pt_fused.supports(dataclasses.replace(static, has_bssrdf=False))
