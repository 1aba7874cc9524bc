"""The port's native BVH builder (csrc/bvh_builder.cpp) and its disk cache.

The native builder computes in float32 and may split where the numpy
builder (float64) does not, so its trees are checked for what makes a
BVH valid, not against the numpy builder's: every prim in exactly one
leaf, leaves of at most LEAF_SIZE prims, every box containing its
children's (and a leaf's, its prims'), and the same closest hits as the
brute-force oracle on a torus knot. The cache must hand back the tree it
stored, miss once the builder changes, and be bypassed by `cache=False`
and the CLI's `--no-cache`.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu_torch.geom import bvh, bvh_native, packet, traverse
from gpu_pathtracer_tpu_torch.scene import flatten as tf
from gpu_pathtracer_tpu_torch.scene.parse import load_scene
from test_torch_render import ENV


def _assert_valid(tree, bmin, bmax):
    n = bmin.shape[0]
    assert np.array_equal(np.sort(tree.prim_order), np.arange(n))
    leaves = np.nonzero(tree.is_leaf)[0]
    counts = tree.end[leaves] - tree.start[leaves] + 1
    assert counts.min() >= 1 and counts.max() <= bvh.LEAF_SIZE
    assert counts.sum() == n
    for i in leaves:   # a leaf's box holds its prims
        ids = tree.prim_order[tree.start[i]:tree.end[i] + 1]
        assert (tree.bbox_min[i] <= bmin[ids]).all()
        assert (tree.bbox_max[i] >= bmax[ids]).all()
    inner = np.nonzero(~tree.is_leaf)[0]
    assert len(inner) + len(leaves) == tree.n_nodes
    for i in inner:   # children at i + 1 and second_child[i]
        for c in (i + 1, tree.second_child[i]):
            assert i < c < tree.n_nodes
            assert (tree.bbox_min[i] <= tree.bbox_min[c]).all()
            assert (tree.bbox_max[i] >= tree.bbox_max[c]).all()
    # every node but the root is some inner node's child, once
    kids = np.concatenate([inner + 1, tree.second_child[inner]])
    assert np.array_equal(np.sort(kids), np.arange(1, tree.n_nodes))


@pytest.mark.parametrize("boxes", ["random", "clustered", "degenerate"])
def test_native_bvh_is_valid(boxes):
    rng = np.random.default_rng(31)
    n = 3000
    c = rng.uniform(-1, 1, (n, 3))
    if boxes == "clustered":   # tight clumps: SAH's buckets fill unevenly
        c = rng.normal(size=(20, 3))[rng.integers(0, 20, n)] \
            + rng.normal(0, 1e-3, (n, 3))
    elif boxes == "degenerate":   # many equal centroids: the median split
        c = np.round(c * 4) / 4
    half = rng.uniform(0.001, 0.05, (n, 3))
    bmin = (c - half).astype(np.float32)
    bmax = (c + half).astype(np.float32)
    tree = bvh_native.build_bvh_native(bmin, bmax)
    _assert_valid(tree, bmin, bmax)
    assert tree.n_nodes > n // bvh.LEAF_SIZE


def test_native_bvh_hits_like_brute_force(tmp_path):
    """The knot scene's BVH8 table built on the native tree: the plain
    BVH8 walk finds the brute-force oracle's closest hits."""
    path = tp.write_knot_scene(tmp_path)
    host = load_scene(str(path))
    fields = tf._prim_fields(host)
    bmin, bmax = tf._prim_bboxes(host, fields)
    _assert_valid(bvh.build_bvh(bmin, bmax), bmin, bmax)
    td, ts = tf.flatten_scene(host, "cpu", cache=False)
    assert bvh.NATIVE and ts.n_primitives == 50 * 20 * 2 + 12
    rng = np.random.default_rng(32)
    ro, rd = tp.random_rays(rng, 1024)
    eps = td.epsilon
    tmax = torch.full((1024,), torch.inf)
    ref = traverse.brute_force_closest(td, ts, torch.as_tensor(ro),
                                       torch.as_tensor(rd), eps, tmax)
    t, prim = packet.walk_torch(
        td.bvh8_table, td.bvh8_aux, 0, torch.as_tensor(ro),
        torch.as_tensor(rd), eps, tmax, False, (True, False, False),
        ts.bvh8_stack)
    tp.hits_agree((t, prim, prim >= 0), (ref.t, ref.prim_idx, ref.valid))


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "bvh_cache"
    monkeypatch.setenv(bvh.CACHE_ENV, str(d))
    return d


def test_cache_reads_back_what_it_stored(cache_dir, monkeypatch):
    rng = np.random.default_rng(33)
    c = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    first = bvh.load_or_build_bvh(c - 0.01, c + 0.01)
    assert len(list(cache_dir.glob("bvh_*.npz"))) == 1

    def refuse(*args):
        raise AssertionError("a cached tree was built again")

    monkeypatch.setattr(bvh, "build_bvh", refuse)
    second = bvh.load_or_build_bvh(c - 0.01, c + 0.01)
    for name in ("bbox_min", "bbox_max", "is_leaf", "second_child", "start",
                 "end", "prim_order"):
        np.testing.assert_array_equal(getattr(second, name),
                                      getattr(first, name), err_msg=name)
    with pytest.raises(AssertionError, match="built again"):
        bvh.load_or_build_bvh(c - 0.01, c + 0.01, cache=False)
    # the numpy builder's trees are cached apart from the native one's
    monkeypatch.setattr(bvh, "NATIVE", False)
    with pytest.raises(AssertionError, match="built again"):
        bvh.load_or_build_bvh(c - 0.01, c + 0.01)


@pytest.mark.parametrize("change", ["native_source", "leaf_size", "buckets"])
def test_changed_builder_misses_the_cache(cache_dir, tmp_path, monkeypatch,
                                          change):
    """A tree cached by one builder is not read back once the builder
    changes: the key holds the native source's hash (through the
    library's name), LEAF_SIZE and N_BUCKETS."""
    c = np.random.default_rng(34).uniform(-1, 1, (300, 3)).astype(np.float32)
    bvh.load_or_build_bvh(c - 0.01, c + 0.01)
    if change == "native_source":
        src = tmp_path / "bvh_builder.cpp"
        src.write_text(bvh_native.SRC.read_text() + "// changed\n")
        monkeypatch.setattr(bvh_native, "SRC", src)
    elif change == "leaf_size":
        monkeypatch.setattr(bvh, "LEAF_SIZE", bvh.LEAF_SIZE + 1)
    else:
        monkeypatch.setattr(bvh, "N_BUCKETS", bvh.N_BUCKETS + 1)

    def refuse(*args):
        raise AssertionError("built again")

    monkeypatch.setattr(bvh, "build_bvh", refuse)
    with pytest.raises(AssertionError, match="built again"):
        bvh.load_or_build_bvh(c - 0.01, c + 0.01)


@pytest.mark.parametrize("no_cache", [False, True])
def test_cli_no_cache_bypasses_the_cache(cache_dir, tmp_path, no_cache):
    env = dict(ENV, GPT_TORCH_CACHE_DIR=str(cache_dir))
    args = [sys.executable, "-m", "gpu_pathtracer_tpu_torch.run.cli",
            str(tp.PORT_SCENES["cornell"]), "--device", "cpu", "--size", "8",
            "--spp", "1", "--out", str(tmp_path / "c.png")]
    r = subprocess.run(args + (["--no-cache"] if no_cache else []),
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    written = list(cache_dir.glob("bvh_*.npz")) if cache_dir.exists() else []
    assert len(written) == (0 if no_cache else 1)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; nothing falls back."""
    src = tmp_path / "bvh_builder.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(bvh_native, "SRC", src)
    monkeypatch.setattr(bvh_native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(bvh_native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        bvh.build_bvh(np.zeros((4, 3), np.float32),
                      np.ones((4, 3), np.float32))
