"""Collapse the binary SAH BVH into the unified 8-wide BVH8 table.

The port of gpu_pathtracer_tpu/geom/bvh8.py:37-243 (numpy, the same
code, so both packages build the same table). One unified table
[n8 + n_leaf_rows + 1, 128] f32:

- node row k (k < n8): 8 child slots at cols c*8 .. c*8+7:
  [bbox_min(3), bbox_max(3), meta, 0]. meta > 0: child is node row
  `meta`; meta < 0: child is leaf row `-meta`; empty slots have
  inverted bboxes and meta 0.
- leaf row: 8 primitive slots of 16 floats (the dense_prims record:
  v0(3) a(3) b(3) type r0 r1 prim_idx valid pad(2)); valid slots come
  first.
- a trailing all-zero row.

The collapse is the SAH-optimal dynamic program of the JAX package
(Ylitie et al. 2017, "Efficient Incoherent Ray Traversal on GPUs Through
Compressed Wide BVHs", section 3). Not ported: `_bf16_directed` and
`pack_nodes4`, the bf16-packed node table of the TPU walk's STREAMED
mode, which exists because the whole table may not fit the TPU's VMEM;
on the GPU one table in global memory serves every size (ROADMAP.md).

`stack_bound` sizes the walk's per-ray stack from the table's depth
(geom/packet.py).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from gpu_pathtracer_tpu_torch.geom.bvh import FlatBVH

MAX_LEAF_RUN = 8
ROW_W = 128


def _subtree_ranges(bvh: FlatBVH):
    """Per-node inclusive primitive range [rs, re] via bottom-up fixpoint
    (each sweep propagates one tree level)."""
    n = bvh.n_nodes
    is_leaf = bvh.is_leaf
    sc = np.maximum(bvh.second_child, 0)
    rs = np.where(is_leaf, bvh.start, -1).astype(np.int64)
    re = np.where(is_leaf, bvh.end, -1).astype(np.int64)
    left = np.minimum(np.arange(n) + 1, n - 1)
    for _ in range(10000):
        undone_s = rs < 0
        undone_e = re < 0
        if not (undone_s.any() or undone_e.any()):
            break
        cand_s = rs[left]
        upd = undone_s & ~is_leaf & (cand_s >= 0)
        rs[upd] = cand_s[upd]
        cand_e = re[sc]
        upd = undone_e & ~is_leaf & (cand_e >= 0)
        re[upd] = cand_e[upd]
    else:
        raise RuntimeError("BVH deeper than 10000 levels?")
    return rs, re


def _node_areas(bvh: FlatBVH) -> np.ndarray:
    d = np.maximum(bvh.bbox_max - bvh.bbox_min, 0.0)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


def _levels(bvh: FlatBVH) -> list[np.ndarray]:
    """Node ids grouped by depth (children of a depth-d node are exactly
    depth d+1 in the DFS-flattened binary tree)."""
    is_leaf = bvh.is_leaf
    sc = bvh.second_child.astype(np.int64)
    levels = []
    frontier = np.array([0], np.int64)
    while frontier.size:
        levels.append(frontier)
        internal = frontier[~is_leaf[frontier]]
        frontier = np.concatenate([internal + 1, sc[internal]])
    return levels


def _collapse(bvh: FlatBVH):
    """SAH-optimal 8-wide collapse of the binary BVH: minimises the
    expected number of rows a random ray visits, sum over emitted rows
    of area(row) / area(root). cost[b][i] is the cheapest realisation of
    binary subtree b as a forest of <= i wide-table roots.

    Returns (node_children, node_row, leaf_of, leaf_runs): per 8-wide
    node the list of binary child ids, binary id -> node row / leaf row
    maps, and per leaf row its (start, count) primitive run.
    """
    rs, re = _subtree_ranges(bvh)
    counts = re - rs + 1
    is_leaf = bvh.is_leaf
    sc = bvh.second_child.astype(np.int64)
    # a subtree with <= 8 prims always flattens to ONE leaf row (the
    # binary builder's DFS order makes its primitive range contiguous)
    small = is_leaf | (counts <= MAX_LEAF_RUN)
    area = _node_areas(bvh)
    n = bvh.n_nodes

    cost = np.full((n, 9), np.inf)
    kbest = np.zeros((n, 9), np.int8)   # dist argmin per slot count j
    carry = np.zeros((n, 9), bool)      # cost[b,i] came from cost[b,i-1]

    for lev in reversed(_levels(bvh)):
        sm = lev[small[lev]]
        if sm.size:
            cost[sm, 1:] = area[sm, None]   # one leaf row, however many slots
        it = lev[~small[lev]]
        if it.size == 0:
            continue
        lc = it + 1
        rc = sc[it]
        dist = np.full((it.size, 9), np.inf)
        for j in range(2, 9):
            for k in range(1, j):
                v = cost[lc, k] + cost[rc, j - k]
                better = v < dist[:, j]
                dist[better, j] = v[better]
                kbest[it[better], j] = k
        cost[it, 1] = area[it] + dist[:, 8]   # b pops as one wide node row
        for i in range(2, 9):
            c_carry = cost[it, i - 1] <= dist[:, i]
            carry[it, i] = c_carry
            cost[it, i] = np.where(c_carry, cost[it, i - 1], dist[:, i])

    def roots(b: int, i: int) -> list[int]:
        """Binary ids realizing subtree b as <= i wide-table roots."""
        out: list[int] = []
        stack = [(b, i)]
        while stack:
            b2, i2 = stack.pop()
            if small[b2] or i2 == 1:
                out.append(b2)
                continue
            if carry[b2, i2]:
                stack.append((b2, i2 - 1))
                continue
            k = int(kbest[b2, i2])
            stack.append((int(sc[b2]), i2 - k))   # right popped second
            stack.append((b2 + 1, k))             # left popped first
        return out

    node_children: list[list[int]] = []
    node_row: dict[int, int] = {}
    queue = deque()
    if small[0]:
        # whole tree fits one leaf run: emit a root node with one child
        node_children.append([0])
        node_row[0] = 0
    else:
        queue.append(0)
    while queue:
        b = queue.popleft()
        node_row[b] = len(node_children)
        k = int(kbest[b, 8])
        children = roots(b + 1, k) + roots(int(sc[b]), 8 - k)
        node_children.append(children)
        for c in children:
            if not small[c]:
                queue.append(c)

    # leaf rows: one per small child, in encounter order
    leaf_of: dict[int, int] = {}
    leaf_runs: list[tuple[int, int]] = []
    for children in node_children:
        for c in children:
            if small[c] and c not in leaf_of:
                leaf_of[c] = len(leaf_runs)
                leaf_runs.append((int(rs[c]), int(counts[c])))
    return node_children, node_row, leaf_of, leaf_runs


def build_bvh8(bvh: FlatBVH, prim_records: np.ndarray):
    """Returns (table, n8): the unified table [n8 + n_leaf_rows + 1, 128]
    f32 and its node-row count n8. prim_records: [P, 16] leaf-ordered
    records (flatten's dense_prims layout)."""
    node_children, node_row, leaf_of, leaf_runs = _collapse(bvh)
    rs, re = _subtree_ranges(bvh)
    counts = re - rs + 1
    is_leaf = bvh.is_leaf

    def small(b):
        return is_leaf[b] or counts[b] <= MAX_LEAF_RUN

    n8 = len(node_children)
    table = np.zeros((n8 + len(leaf_runs) + 1, ROW_W), np.float32)
    nview = table[:n8].reshape(n8, 16, 8)  # 16 slots of 8; use first 8
    # empty child slots: inverted boxes and meta 0
    nview[:, :8, 0:3] = np.inf
    nview[:, :8, 3:6] = -np.inf
    for k, children in enumerate(node_children):
        for ci, c in enumerate(children):
            nview[k, ci, 0:3] = bvh.bbox_min[c]
            nview[k, ci, 3:6] = bvh.bbox_max[c]
            if small(c):
                nview[k, ci, 6] = -(n8 + leaf_of[c])
            else:
                nview[k, ci, 6] = node_row[c]

    if leaf_runs:
        starts = np.asarray([s for s, _ in leaf_runs], np.int64)
        cnts = np.asarray([c for _, c in leaf_runs], np.int64)
        lview = table[n8:-1].reshape(len(leaf_runs), 8, 16)
        for slot in range(MAX_LEAF_RUN):
            sel = cnts > slot
            rows = np.nonzero(sel)[0]
            recs = prim_records[starts[sel] + slot]
            lview[rows, slot, :] = recs
            lview[rows, slot, 13] = 1.0  # valid flag
    return table, n8


def node_depth(table: np.ndarray, roots) -> int:
    """Node rows on the longest root-to-leaf path below any of `roots`
    (node rows of the unified table)."""
    depth = 0
    frontier = np.unique(np.asarray(roots, np.int64))
    while frontier.size:
        depth += 1
        metas = table[frontier].reshape(-1, 16, 8)[:, :8, 6]
        frontier = np.unique(metas[metas > 0].astype(np.int64))
    return depth


def stack_bound(table: np.ndarray, aux: np.ndarray, n_inst: int) -> int:
    """Stack entries a walk of this table can hold at once: a node pops
    one entry and pushes at most 8, so a path through D node rows leaves
    at most 7 siblings on each of its D - 1 upper levels plus 8 children,
    7 D + 1 entries; 7 D + 8 as the JAX package's packet.py:31. The
    instanced walk visits instances one after another (aux col 12 holds
    each BLAS root), so the bound is that of the deepest BLAS."""
    roots = aux[:n_inst, 12] if n_inst else [0]
    return 7 * node_depth(table, roots) + 8
