"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages are given the same inputs, made with numpy from fixed
seeds. The port is held to the JAX package's numpy BVH builder: both
packages prefer their native C++ builders, which may pick other
(equally valid) splits, so `numpy_bvh_builder` (and `jax_flatten`,
which calls it) routes both packages to their numpy builders for the
comparison. The JAX package then never compiles its own native library.

The port's BVH disk cache of the test run lives in a temporary
directory (GPT_TORCH_CACHE_DIR, inherited by the CLI subprocesses).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile

import numpy as np
import torch

torch.set_num_threads(2)   # tier-1 runs the suite with 6 workers
os.environ.setdefault("GPT_TORCH_CACHE_DIR", os.path.join(
    tempfile.gettempdir(), "gpt_torch_test_bvh_cache"))

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_SCENES = {   # the two scenes inside the megakernel's scope
    "cornell": REPO / "scenes" / "cornell_port" / "scene.json",
    "materials": REPO / "scenes" / "cornell_port" / "materials.json",
}
# 72 area lights: outside the megakernel, it takes the wavefront
MANY_LIGHTS = REPO / "scenes" / "cornell_port" / "many_lights.json"
KNOT_SCENE = REPO / "scenes" / "knot_port" / "scene.json"
# heterogeneous smoke + homogeneous fog: volumetric path tracing
SMOKE_SCENE = REPO / "scenes" / "smoke_port" / "scene.json"
# cornell_port with its boxes in dipole BSSRDFs (sigma and kd forms)
BSSRDF_SCENE = REPO / "scenes" / "cornell_port" / "bssrdf.json"


def write_sphere_line_scene(dirpath) -> pathlib.Path:
    """A small test scene of spheres and line segments (no triangles but
    the light quad), with an anisotropic rough conductor."""
    light = REPO / "scenes" / "cornell_port" / "light.obj"
    scene = {
        "screen_width": 32, "screen_height": 32, "integrator": "pt",
        "maxDepth": 4, "epsilon": 0.001,
        "camera": {"position": [0, 1, 4], "lookat": [0, 1, 0], "fov": 40,
                   "filmicTonemap": False},
        "material": [
            {"name": "Grey", "bsdf": "lambertian",
             "diffuse": [0.6, 0.6, 0.6]},
            {"name": "Brushed", "bsdf": "roughconduct", "alphaU": 0.3,
             "alphaV": 0.05, "eta": [0.2, 0.9, 1.1], "k": [3.9, 2.4, 2.2]},
            {"name": "Emission", "bsdf": "lambertian", "diffuse": [0, 0, 0]},
        ],
        "scene": [
            {"sphere": True, "center": [0, -100, 0], "radius": 100,
             "material": "Grey"},
            {"sphere": True, "center": [-0.4, 0.5, 0], "radius": 0.5,
             "material": "Brushed"},
            {"sphere": True, "center": [0.6, 0.3, 0.3], "radius": 0.3,
             "material": "Grey"},
            {"line": True, "p0": [0.0, 0.0, 0.6], "p1": [0.1, 1.1, 0.5],
             "width0": 0.03, "width1": 0.01, "material": "Grey"},
            {"line": True, "p0": [0.9, 0.0, -0.3], "p1": [0.7, 1.5, -0.2],
             "width0": 0.02, "width1": 0.02, "material": "Brushed"},
        ],
        "light": [{"mesh": str(light), "material": "Emission",
                   "radiance": [10.0, 10.0, 10.0]}],
    }
    path = pathlib.Path(dirpath) / "sphere_line.json"
    path.write_text(json.dumps(scene))
    return path


def write_knot_scene(dirpath, n_seg=50, n_ring=20) -> pathlib.Path:
    """scenes/knot_port/scene.json with a small knot of the same generator
    (tools/gen_knot_port.py): 2 * n_seg * n_ring triangles in the
    12-triangle room, 32 x 32 pixels."""
    from tools.gen_knot_port import knot_mesh, obj_text
    dirpath = pathlib.Path(dirpath)
    (dirpath / "knot.obj").write_text(obj_text(*knot_mesh(n_seg, n_ring)))
    scene = json.loads((KNOT_SCENE).read_text())
    scene["screen_width"] = scene["screen_height"] = 32
    room = REPO / "scenes" / "cornell_port"
    for unit in scene["scene"] + scene["light"]:
        name = pathlib.Path(unit["mesh"]).name
        unit["mesh"] = str(dirpath / "knot.obj" if name.startswith("knot")
                           else room / name)
    path = dirpath / "knot.json"
    path.write_text(json.dumps(scene))
    return path


def instanced_scene(model, objloader):
    """The scene of tests/test_tlas.py built with either package's
    `model` and `objloader` modules: meshA 3 times (one non-uniform
    scale), meshB twice, a singleton meshC, a sphere and a line."""
    rs = np.random.RandomState(3)

    def mesh(n_tris, center, spread=0.6):
        v0 = rs.uniform(-1, 1, (n_tris, 3)) * spread + center
        e1 = rs.uniform(-0.3, 0.3, (n_tris, 3))
        e2 = rs.uniform(-0.3, 0.3, (n_tris, 3))
        pos = np.stack([v0, v0 + e1, v0 + e2], axis=1).astype(np.float32)
        nor = np.cross(e1, e2)
        nor /= np.maximum(np.linalg.norm(nor, axis=-1, keepdims=True), 1e-9)
        nor = np.repeat(nor[:, None, :], 3, axis=1).astype(np.float32)
        return pos, nor, rs.uniform(0, 1, (n_tris, 3, 2)).astype(np.float32)

    scene = model.HostScene()
    scene.materials.append(model.Material(
        type=model.MaterialType.LAMBERTIAN))

    def add(arrays, trs, key):
        m = objloader.transform_mesh(objloader.TriMesh(*arrays), trs)
        first = len(scene.primitives)
        for t in scene.append_triangles(m):
            scene.primitives.append(model.Primitive(
                type=model.GeometryType.TRIANGLE, tri_index=int(t),
                matIdx=0))
        scene.units.append(model.InstanceUnit(
            mesh_key=key, trs=trs,
            prim_ids=np.arange(first, len(scene.primitives))))

    trs = objloader.trs_matrix
    a = mesh(60, np.zeros(3))
    for t in (trs([0, 0, 0], [0, 0, 0], [1, 1, 1]),
              trs([1.5, 0.2, -0.4], [0, 40, 0], [0.7, 0.7, 0.7]),
              trs([-1.2, -0.3, 0.8], [20, 0, -15], [1.3, 0.9, 1.1])):
        add(a, t, "meshA")
    b = mesh(40, np.array([0, 2.0, 0]))
    for t in (trs([0, 0, 0], [0, 0, 0], [1, 1, 1]),
              trs([2.0, -1.0, 1.0], [0, 0, 70], [0.5, 0.5, 0.5])):
        add(b, t, "meshB")
    add(mesh(25, np.array([-2.0, 1.0, -1.0])),
        trs([0, 0, 0], [0, 0, 0], [1, 1, 1]), "meshC")
    scene.primitives.append(model.Primitive(
        type=model.GeometryType.SPHERE,
        center=np.array([0.5, -1.5, 0.5], np.float32), radius=0.4,
        matIdx=0))
    scene.primitives.append(model.Primitive(
        type=model.GeometryType.LINE, p0=np.array([-1, -1, -1], np.float32),
        p1=np.array([1, -1.2, 1], np.float32), width0=0.05, width1=0.08,
        matIdx=0))
    return scene


def numpy_bvh_builder(monkeypatch):
    """Make both packages build their BVHs with their numpy builders."""
    from gpu_pathtracer_tpu.geom import bvh_native
    from gpu_pathtracer_tpu_torch.geom import bvh as tbvh

    def refuse(*args, **kwargs):
        raise RuntimeError("parity tests use the numpy BVH builder")

    monkeypatch.setattr(bvh_native, "build_bvh_native", refuse)
    monkeypatch.setattr(tbvh, "NATIVE", False)


def jax_flatten(path, monkeypatch, size=None):
    """(DeviceScene, StaticConfig) of the JAX package, numpy BVH."""
    from gpu_pathtracer_tpu.scene.flatten import flatten_scene
    from gpu_pathtracer_tpu.scene.parse import load_scene
    numpy_bvh_builder(monkeypatch)
    host = load_scene(str(path))
    if size is not None:
        host.width = host.height = size
    return flatten_scene(host, cache=False)


def jax_fields(jd, js):
    """The port's DeviceScene / StaticConfig fields read out of the JAX
    package's, as numpy arrays and plain values."""
    from gpu_pathtracer_tpu_torch.scene import flatten as tf
    arrays = {f.name: np.asarray(getattr(jd, f.name))
              for f in dataclasses.fields(tf.DeviceScene)
              if f.name not in ("device", "camera", "med_table", "block_sub")}
    # (the port derives med_table from the med_* fields and block_sub,
    # its own, from dense_prims)
    arrays["camera"] = {f.name: np.asarray(getattr(jd.camera, f.name))
                        for f in dataclasses.fields(tf.DeviceCamera)}
    static = {f.name: getattr(js, f.name)
              for f in dataclasses.fields(tf.StaticConfig)
              if hasattr(js, f.name)}   # the port derives bvh8_stack
    return arrays, static


def port_scene_from_jax(jd, js, device="cpu"):
    """The port's (DeviceScene, StaticConfig) on the JAX package's tables."""
    from gpu_pathtracer_tpu_torch.scene.flatten import (
        device_scene_from_numpy,
    )
    arrays, static = jax_fields(jd, js)
    return device_scene_from_numpy(arrays, static, device)


def random_rays(rng, n, lo=(-0.95, 0.05, -0.95), hi=(0.95, 1.95, 0.95)):
    """n rays (numpy float32) with origins in a box, unit directions."""
    ro = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


def aimed_rays(rng, n, lo, hi, target_lo, target_hi):
    """Rays from the box [lo, hi] aimed at points of [target_lo,
    target_hi], with a tmax for any-hit queries."""
    ro = rng.uniform(lo, hi, (n, 3))
    rd = rng.uniform(target_lo, target_hi, (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (ro.astype(np.float32), rd.astype(np.float32),
            rng.uniform(0.2, 2.0, n).astype(np.float32))


def hits_agree(got, ref):
    """(t, prim, found) against a reference's: the same rays hit, t within
    rtol 2e-5, prim ids equal on > 99.5% (shared-edge ties)."""
    t, p, f = (np.asarray(x) for x in got)
    rt, rp, rf = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(f, rf)
    np.testing.assert_allclose(t[rf], rt[rf], rtol=2e-5)
    assert (p[rf] == rp[rf]).mean() > 0.995
    assert 0.2 < rf.mean() < 0.98


def brute_hits(td, ts, ro, rd, eps, tmax):
    """The port's brute force on numpy rays: (t, prim, found)."""
    from gpu_pathtracer_tpu_torch.geom import traverse
    h = traverse.brute_force_closest(td, ts, torch.as_tensor(ro),
                                     torch.as_tensor(rd), eps,
                                     torch.as_tensor(tmax))
    return h.t, h.prim_idx, h.valid


def plain_hits(kind, td, ts, ro, rd, eps, tmax, any_hit):
    """The port's K3 ("K3") or K4 ("K4") plain version on numpy rays:
    (t, prim, found), or found with `any_hit`."""
    from gpu_pathtracer_tpu_torch.geom import blocked, dense, packet
    args = (torch.as_tensor(ro), torch.as_tensor(rd), eps,
            torch.as_tensor(tmax), any_hit, dense.kinds_of(ts))
    if kind == "K3":
        out = blocked.blocked_hit_torch(td.dense_prims, td.block_bbox, *args)
    else:
        out = packet.walk_torch(td.bvh8_table, td.bvh8_aux, ts.bvh8_n_inst,
                                *args, ts.bvh8_stack)
    return out if any_hit else (*out, out[1] >= 0)


def close_lanes(a, b, atol=1e-4, rtol=1e-3):
    """Per-lane agreement of two [N, 3] arrays: |a - b| <= atol + rtol|b|."""
    a = np.asarray(a)
    b = np.asarray(b)
    return np.all(np.abs(a - b) <= atol + rtol * np.abs(b), axis=-1)
