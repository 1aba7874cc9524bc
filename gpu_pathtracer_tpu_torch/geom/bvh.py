"""Host-side bucketed-SAH BVH build + DFS flatten, and its disk cache.

`build_bvh_numpy` is a copy of the numpy builder of
gpu_pathtracer_tpu/geom/bvh.py (`_build_bvh_numpy`), which
re-implements the reference builder (bvh.cpp:16-173): top-down,
12-bucket SAH over all 3 axes, DFS-flattened layout where a node's first
child is at `index + 1` and the second child at `second_child_offset`,
with primitives reordered leaf-contiguously. Leaves are always bounded
at LEAF_SIZE by a median-split fallback, as in the JAX package.

`build_bvh` runs the native C++ builder (geom/bvh_native.py, the same
algorithm in float32) unless `NATIVE` is false; it may pick other,
equally valid splits than the numpy builder, so the parity tests set
`NATIVE = False` to lay out the JAX package's tree and prim order. A
native build that fails raises: there is no quiet fall-back.

`load_or_build_bvh` keeps built trees in a content-addressed npz cache
(the JAX package's geom/bvh.py:196-223, the reference's bvh.cache,
bvh.cpp:189-218): the key hashes the prim boxes, LEAF_SIZE, N_BUCKETS
and the builder's code (the native library's name, which carries the
hash of its source and flags, or this file's source for the numpy
builder), so a changed scene or builder is rebuilt. The cache lives in
~/.cache/gpu_pathtracer_tpu_torch, or in the directory the environment
variable GPT_TORCH_CACHE_DIR names.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from dataclasses import dataclass, fields

import numpy as np

LEAF_SIZE = 4
N_BUCKETS = 12
NATIVE = True   # build_bvh: the native builder (False: build_bvh_numpy)
CACHE_ENV = "GPT_TORCH_CACHE_DIR"


@dataclass
class FlatBVH:
    """SoA flattened BVH, ready for device upload.

    `second_child[i]` is the DFS index of node i's right child (-1 for
    leaves); the left child is always `i + 1`. `start/end` are inclusive
    primitive ranges for leaves (like LinearBVHNode, bvh.h:7-25).
    `prim_order` maps leaf-contiguous slots -> original primitive indices.
    """
    bbox_min: np.ndarray     # [N, 3] f32
    bbox_max: np.ndarray     # [N, 3] f32
    is_leaf: np.ndarray      # [N] bool
    second_child: np.ndarray  # [N] i32
    start: np.ndarray        # [N] i32
    end: np.ndarray          # [N] i32
    prim_order: np.ndarray   # [P] i32

    @property
    def n_nodes(self) -> int:
        return self.bbox_min.shape[0]

    @property
    def root_box(self) -> tuple[np.ndarray, np.ndarray]:
        return self.bbox_min[0], self.bbox_max[0]


def build_bvh(prim_bbox_min: np.ndarray,
              prim_bbox_max: np.ndarray) -> FlatBVH:
    """Build from per-primitive AABBs [P, 3] (f32) with the native
    builder, or with the numpy one when `NATIVE` is false."""
    if NATIVE:
        from gpu_pathtracer_tpu_torch.geom import bvh_native
        return bvh_native.build_bvh_native(prim_bbox_min, prim_bbox_max)
    return build_bvh_numpy(prim_bbox_min, prim_bbox_max)


def build_bvh_numpy(prim_bbox_min: np.ndarray,
                    prim_bbox_max: np.ndarray) -> FlatBVH:
    """The numpy builder: the JAX package's tree, split for split."""
    p_min = np.asarray(prim_bbox_min, np.float64)
    p_max = np.asarray(prim_bbox_max, np.float64)
    centers = 0.5 * (p_min + p_max)
    n = p_min.shape[0]
    if n == 0:
        raise ValueError("cannot build BVH over zero primitives")

    bbox_min: list[np.ndarray] = []
    bbox_max: list[np.ndarray] = []
    is_leaf: list[bool] = []
    second_child: list[int] = []
    start: list[int] = []
    end: list[int] = []
    prim_order: list[int] = []

    # DFS with explicit stack; each entry: (prim-ids, parent-slot or -1)
    root_ids = np.arange(n)
    stack: list[tuple[np.ndarray, int]] = [(root_ids, -1)]

    while stack:
        ids, parent = stack.pop()
        node_idx = len(bbox_min)
        if parent >= 0:
            second_child[parent] = node_idx

        nb_min = p_min[ids].min(axis=0)
        nb_max = p_max[ids].max(axis=0)
        bbox_min.append(nb_min)
        bbox_max.append(nb_max)

        if ids.shape[0] <= LEAF_SIZE:
            is_leaf.append(True)
            second_child.append(-1)
            start.append(len(prim_order))
            prim_order.extend(ids.tolist())
            end.append(len(prim_order) - 1)
            continue

        left_ids, right_ids = _split(ids, p_min, p_max, centers,
                                     nb_min, nb_max)
        is_leaf.append(False)
        second_child.append(-1)  # patched when the right child materializes
        start.append(0)
        end.append(-1)
        # DFS order: left child must be emitted next -> push right first
        stack.append((right_ids, node_idx))
        stack.append((left_ids, -1))

    return FlatBVH(
        bbox_min=np.asarray(bbox_min, np.float32),
        bbox_max=np.asarray(bbox_max, np.float32),
        is_leaf=np.asarray(is_leaf, bool),
        second_child=np.asarray(second_child, np.int32),
        start=np.asarray(start, np.int32),
        end=np.asarray(end, np.int32),
        prim_order=np.asarray(prim_order, np.int32),
    )


def _split(ids, p_min, p_max, centers, nb_min, nb_max):
    """Bucketed SAH over 3 axes (bvh.cpp:53-141); median fallback."""
    count = ids.shape[0]
    extent = nb_max - nb_min
    c = centers[ids]

    best_cost = count * _surface_area(nb_min, nb_max)
    best_axis, best_bucket = -1, -1
    best_mask = None

    for axis in range(3):
        if extent[axis] < 1e-4:
            continue  # degenerate axis: bucket index would blow up
        t = (c[:, axis] - nb_min[axis]) / extent[axis]
        bucket = np.minimum((t * N_BUCKETS).astype(np.int64), N_BUCKETS - 1)

        # per-bucket counts and bounds
        counts = np.bincount(bucket, minlength=N_BUCKETS)
        b_min = np.full((N_BUCKETS, 3), np.inf)
        b_max = np.full((N_BUCKETS, 3), -np.inf)
        for d in range(3):
            np.minimum.at(b_min[:, d], bucket, p_min[ids, d])
            np.maximum.at(b_max[:, d], bucket, p_max[ids, d])

        # prefix/suffix sweep
        lc = np.cumsum(counts)[:-1]                    # counts left of split j
        rc = count - lc
        l_min = np.minimum.accumulate(b_min, axis=0)[:-1]
        l_max = np.maximum.accumulate(b_max, axis=0)[:-1]
        r_min = np.minimum.accumulate(b_min[::-1], axis=0)[::-1][1:]
        r_max = np.maximum.accumulate(b_max[::-1], axis=0)[::-1][1:]

        sa_l = np.where(lc > 0, _surface_area(l_min, l_max), 0.0)
        sa_r = np.where(rc > 0, _surface_area(r_min, r_max), 0.0)
        cost = sa_l * lc + sa_r * rc
        j = int(np.argmin(cost))
        if cost[j] < best_cost and lc[j] > 0 and rc[j] > 0:
            best_cost = cost[j]
            best_axis = axis
            best_bucket = j + 1
            best_mask = bucket < best_bucket

    if best_axis >= 0:
        return ids[best_mask], ids[~best_mask]

    # SAH found nothing (or box degenerate): median split on the widest
    # center spread so leaves stay bounded (deviation, see module docstring).
    spread = c.max(axis=0) - c.min(axis=0)
    axis = int(np.argmax(spread))
    order = np.argsort(c[:, axis], kind="stable")
    half = count // 2
    return ids[order[:half]], ids[order[half:]]


def _surface_area(b_min, b_max):
    d = np.maximum(b_max - b_min, 0.0)
    if d.ndim == 1:
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def cache_dir() -> str:
    """The BVH cache directory (made on first use)."""
    d = os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "gpu_pathtracer_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def load_or_build_bvh(prim_bbox_min: np.ndarray, prim_bbox_max: np.ndarray,
                      cache: bool = True) -> FlatBVH:
    """build_bvh through the disk cache: a tree built before for the same
    boxes by the same builder is read back; `cache` false builds anew
    and writes nothing."""
    if not cache:
        return build_bvh(prim_bbox_min, prim_bbox_max)
    if NATIVE:
        from gpu_pathtracer_tpu_torch.geom import bvh_native
        builder = os.path.basename(bvh_native.library_path()).encode()
    else:
        with open(__file__, "rb") as f:
            builder = f.read()
    h = hashlib.sha256(builder)
    h.update(f"{LEAF_SIZE} {N_BUCKETS}".encode())
    h.update(np.ascontiguousarray(prim_bbox_min, np.float32).tobytes())
    h.update(np.ascontiguousarray(prim_bbox_max, np.float32).tobytes())
    path = os.path.join(cache_dir(), f"bvh_{h.hexdigest()[:24]}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return FlatBVH(**{k: z[k] for k in z.files})
    bvh = build_bvh(prim_bbox_min, prim_bbox_max)
    # written under a temporary name, then renamed: a reader never sees
    # a partial file, and concurrent writers of one key write equal files
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(path))
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **{k.name: getattr(bvh, k.name) for k in fields(bvh)})
    os.replace(tmp, path)
    return bvh
