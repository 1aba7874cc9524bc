"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages are given the same inputs, made with numpy from fixed
seeds. The port is held to the JAX package's numpy BVH builder: the JAX
package prefers its native C++ builder when the shared library loads,
and that builder may pick other (equally valid) splits, so `jax_flatten`
routes the JAX package to its numpy builder for the comparison.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

torch.set_num_threads(2)   # tier-1 runs the suite with 6 workers

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_SCENES = {   # the two scenes inside the megakernel's scope
    "cornell": REPO / "scenes" / "cornell_port" / "scene.json",
    "materials": REPO / "scenes" / "cornell_port" / "materials.json",
}
# 72 area lights: outside the megakernel, it takes the wavefront
MANY_LIGHTS = REPO / "scenes" / "cornell_port" / "many_lights.json"


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


def numpy_bvh_builder(monkeypatch):
    """Make the JAX package build its BVH with the numpy builder."""
    from gpu_pathtracer_tpu.geom import bvh_native

    def refuse(*args, **kwargs):
        raise RuntimeError("parity tests use the numpy BVH builder")

    monkeypatch.setattr(bvh_native, "build_bvh_native", refuse)


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
              if f.name not in ("device", "camera")}
    arrays["camera"] = {f.name: np.asarray(getattr(jd.camera, f.name))
                        for f in dataclasses.fields(tf.DeviceCamera)}
    static = {f.name: getattr(js, f.name)
              for f in dataclasses.fields(tf.StaticConfig)}
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


def close_lanes(a, b, atol=1e-4, rtol=1e-3):
    """Per-lane agreement of two [N, 3] arrays: |a - b| <= atol + rtol|b|."""
    a = np.asarray(a)
    b = np.asarray(b)
    return np.all(np.abs(a - b) <= atol + rtol * np.abs(b), axis=-1)
