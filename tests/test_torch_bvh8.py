"""The port's BVH8 and TLAS tables vs the JAX package's, array for array.

Both packages build the same tables from the same scene (numpy SAH
builder on both sides): the unified BVH8 table of a flat scene
(geom/bvh8.py), the instance plan and the instanced table of a
tests/test_tlas.py-style scene (geom/tlas.py, JAX side instanced under
PTPU_FORCE_INSTANCING with MIN_INSTANCED_PRIMS lowered as test_tlas.py
does, nothing in the package changed), and every field flatten derives
from them. Then the port's instanced and flat flattens of one scene
must find the same hit geometry (t within rtol 2e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.geom import bvh8 as jbvh8
from gpu_pathtracer_tpu.geom import bvh as jbvh
from gpu_pathtracer_tpu.geom import tlas as jtlas
from gpu_pathtracer_tpu.scene import flatten as jflatten
from gpu_pathtracer_tpu.scene import model as jmodel
from gpu_pathtracer_tpu.scene import objloader as jobj
from gpu_pathtracer_tpu_torch.geom import bvh as tbvh
from gpu_pathtracer_tpu_torch.geom import bvh8 as tbvh8
from gpu_pathtracer_tpu_torch.geom import packet, traverse
from gpu_pathtracer_tpu_torch.geom import tlas as ttlas
from gpu_pathtracer_tpu_torch.scene import flatten as tflatten
from gpu_pathtracer_tpu_torch.scene import model as tmodel
from gpu_pathtracer_tpu_torch.scene import objloader as tobj


@pytest.fixture
def instancing(monkeypatch):
    """Both packages plan instances for meshes of >= 8 triangles; the JAX
    package on its numpy BVH builder, instanced off the TPU."""
    tp.numpy_bvh_builder(monkeypatch)
    monkeypatch.setenv("PTPU_FORCE_INSTANCING", "1")
    monkeypatch.setattr(jtlas, "MIN_INSTANCED_PRIMS", 8)
    monkeypatch.setattr(ttlas, "MIN_INSTANCED_PRIMS", 8)
    return (tp.instanced_scene(jmodel, jobj),
            tp.instanced_scene(tmodel, tobj))


def _assert_fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(np.asarray(x), np.asarray(y)), f.name


def test_build_bvh8_matches_jax():
    """The binary BVH and the flat unified table of 3,000 random boxes,
    and the constants the two packages share."""
    rng = np.random.default_rng(4)
    c = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    bmin, bmax = c - 0.02, c + 0.02
    jb = jbvh._build_bvh_numpy(bmin, bmax)
    tb = tbvh.build_bvh_numpy(bmin, bmax)
    _assert_fields_equal(jb, tb)
    recs = rng.normal(size=(3000, 16)).astype(np.float32)
    jt, jn8 = jbvh8.build_bvh8(jb, recs)
    tt, tn8 = tbvh8.build_bvh8(tb, recs)
    assert jn8 == tn8 and np.array_equal(jt, tt)
    for name in ("INST_STRIDE", "MAX_INSTANCES", "MIN_INSTANCED_PRIMS",
                 "AUX_COLS"):
        assert getattr(jtlas, name) == getattr(ttlas, name), name
    assert (jbvh8.MAX_LEAF_RUN, jbvh8.ROW_W) == (tbvh8.MAX_LEAF_RUN,
                                                 tbvh8.ROW_W)


def test_instance_plan_and_table_match_jax(instancing):
    jscene, tscene = instancing
    bmin, bmax = jflatten._prim_bboxes(jscene)
    tb = tflatten._prim_bboxes(tscene, tflatten._prim_fields(tscene))
    assert np.array_equal(bmin, tb[0]) and np.array_equal(bmax, tb[1])
    jplan = jtlas.plan_instances(jscene, bmin, bmax, cache=False)
    tplan = ttlas.plan_instances(tscene, bmin, bmax)
    assert tplan.n_inst == jplan.n_inst == 6
    for name in ("order", "mesh_of", "xform", "base", "count"):
        assert np.array_equal(np.asarray(getattr(jplan, name)),
                              np.asarray(getattr(tplan, name))), name
    for jb, tb in zip(jplan.blas, tplan.blas, strict=True):
        _assert_fields_equal(jb, tb)
    recs = np.random.default_rng(5).normal(
        size=(jplan.order.shape[0], 16)).astype(np.float32)
    j = jtlas.build_instanced_table(jplan, recs, bmin, bmax)
    t = ttlas.build_instanced_table(tplan, recs, bmin, bmax)
    assert j[1:2] + j[3:] == t[1:2] + t[3:]   # n8, tlas rows
    assert np.array_equal(j[0], t[0]) and np.array_equal(j[2], t[2])


@pytest.mark.parametrize("kind", ["instanced", "knot"])
def test_flatten_tables_match_jax(kind, instancing, tmp_path):
    """Every array and static field the port's flatten shares with the
    JAX package's, BVH8 tables included."""
    jscene, tscene = instancing
    if kind == "knot":
        from gpu_pathtracer_tpu.scene.parse import load_scene as jload
        from gpu_pathtracer_tpu_torch.scene.parse import load_scene
        path = tp.write_knot_scene(tmp_path)
        jscene, tscene = jload(str(path)), load_scene(str(path))
    jd, js = jflatten.flatten_scene(jscene, cache=False)
    arrays, static = tflatten.flatten_numpy(tscene, instancing=True)
    for name, a in arrays.items():
        if name != "camera":
            assert np.array_equal(np.asarray(getattr(jd, name)), a,
                                  equal_nan=True), name
    for name, v in static.items():
        assert getattr(js, name) == v, name
    assert static["bvh8_n_inst"] == (6 if kind == "instanced" else 0)


def test_stack_bound_covers_the_walk(instancing):
    """bvh8.stack_bound is 7 D + 8 for the deepest tree under a root; a
    walk of every ray fits it, and a 2-entry stack raises."""
    _, tscene = instancing
    td, ts = tflatten.flatten_scene(tscene, "cpu", instancing=True)
    table = td.bvh8_table.numpy()
    roots = td.bvh8_aux.numpy()[:, 12]
    assert ts.bvh8_stack == 7 * tbvh8.node_depth(table, roots) + 8
    ro, rd, _ = (torch.as_tensor(a) for a in tp.aimed_rays(
        np.random.default_rng(6), 512, -3.0, 3.0, -1.5, 1.5))
    args = (td.bvh8_table, td.bvh8_aux, ts.bvh8_n_inst, ro, rd, 1e-3,
            torch.inf, False)
    packet.walk_torch(*args, stack_depth=ts.bvh8_stack)
    with pytest.raises(RuntimeError, match="stack"):
        packet.walk_torch(*args, stack_depth=2)


def test_instanced_vs_flat_hit_geometry(instancing):
    """The same scene flattened with and without instances: the same
    hits, t within rtol 2e-5, the same normals within 1e-4."""
    _, tscene = instancing
    di, si = tflatten.flatten_scene(tscene, "cpu", instancing=True)
    df, sf = tflatten.flatten_scene(tscene, "cpu", instancing=False)
    assert si.bvh8_n_inst == 6 and sf.bvh8_n_inst == 0
    assert traverse.regime(si) == "instanced"
    assert traverse.regime(sf) == "dense"
    ro, rd, _ = (torch.as_tensor(a) for a in tp.aimed_rays(
        np.random.default_rng(13), 2048, -3.0, 3.0, -1.5, 1.5))
    hi = traverse.intersect_closest(di, si, ro, rd, 1e-3, torch.inf)
    hf = traverse.intersect_closest(df, sf, ro, rd, 1e-3, torch.inf)
    assert torch.equal(hi.valid, hf.valid) and hf.valid.float().mean() > 0.2
    v = hf.valid
    np.testing.assert_allclose(hi.t[v].numpy(), hf.t[v].numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(hi.nor[v].numpy(), hf.nor[v].numpy(),
                               rtol=1e-4, atol=1e-4)
