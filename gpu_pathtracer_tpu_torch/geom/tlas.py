"""Two-level (TLAS/BLAS) tables for instanced scenes.

The port of gpu_pathtracer_tpu/geom/tlas.py:72-303 (numpy, the same
code, so both packages build the same arrays). Repeated scene[] meshes
become INSTANCES of one BLAS, built in the world frame of the mesh's
FIRST entry; every instance stores the affine map T_i = M_first @
inv(M_i) taking a world ray into that frame. Points map affinely, so the
hit parameter t is the same in both frames as long as the direction is
not renormalised (tlas.py:9-14). Instance 0 is the STATIC group: every
primitive not in a repeated mesh, with the identity map. The global prim
order is (instance, blas-local), so a hit's global id is the instance's
slot base plus the BLAS-local id.

The BLAS trees go through the BVH disk cache (`cache`), as in the JAX
package. Difference from it: no cap on the table's rows. The JAX package
refuses to instance a scene whose tables exceed what the TPU walk keeps
resident in VMEM (packet_tpu.RESIDENT_MAX_ROWS); the GPU walk reads one
table from global memory at any size.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gpu_pathtracer_tpu_torch.geom import bvh8 as bvh8_mod
from gpu_pathtracer_tpu_torch.geom.bvh import (
    FlatBVH, build_bvh, load_or_build_bvh,
)

# Kept equal to the JAX package's so the tables compare array for array.
# INST_STRIDE is the TPU walk's stack-entry encoding (row * INST_STRIDE +
# instance); the port's instance-major walk keeps the instance in a
# register and does not encode it.
INST_STRIDE = 2048
MAX_INSTANCES = 64
MIN_INSTANCED_PRIMS = 1024   # don't instance tiny meshes
AUX_COLS = 20   # aux row: 12 xform, BLAS root row, slot base, world
                # bbox min (14:17) / max (17:20)


@dataclasses.dataclass
class InstancePlan:
    """Host-side plan produced by plan_instances()."""
    order: np.ndarray            # [P] global slot -> original prim index
    # per instance (0 = static group):
    mesh_of: list[int]           # unique-mesh id per instance
    xform: np.ndarray            # [n_inst, 12] world -> blas frame (3x4)
    base: np.ndarray             # [n_inst] global slot offset
    count: np.ndarray            # [n_inst] prim count
    # per unique mesh: BLAS binary BVH over the FIRST instance's prims
    blas: list[FlatBVH]

    @property
    def n_inst(self) -> int:
        return len(self.mesh_of)


def plan_instances(scene, bmin: np.ndarray, bmax: np.ndarray,
                   cache: bool = True) -> InstancePlan | None:
    """Group repeated scene[] meshes into instances; None when the scene
    has no repeated mesh worth instancing (the flat table serves it).
    `cache`: the BLAS trees go through the BVH disk cache."""
    units = getattr(scene, "units", None)
    if not units:
        return None
    by_key: dict[str, list[int]] = {}
    for ui, u in enumerate(units):
        by_key.setdefault(u.mesh_key, []).append(ui)
    groups = [uis for uis in by_key.values()
              if len(uis) >= 2 and len(units[uis[0]].prim_ids)
              >= MIN_INSTANCED_PRIMS]
    if not groups:
        return None
    n_inst = 1 + sum(len(g) for g in groups)
    if n_inst > MAX_INSTANCES:
        return None

    P = bmin.shape[0]
    in_group = np.zeros(P, bool)
    for uis in groups:
        for ui in uis:
            in_group[units[ui].prim_ids] = True
    static_ids = np.nonzero(~in_group)[0]
    if static_ids.size == 0:
        return None   # instance 0 (the static group) must not be empty

    order: list[np.ndarray] = []
    mesh_of: list[int] = [0]
    xforms = [np.eye(4, dtype=np.float64)]
    base = [0]
    count = [static_ids.size]
    blas: list[FlatBVH] = []

    sb = load_or_build_bvh(bmin[static_ids], bmax[static_ids], cache)
    blas.append(sb)
    order.append(static_ids[sb.prim_order])

    for uis in groups:
        first = units[uis[0]]
        mesh_id = len(blas)
        fb = load_or_build_bvh(bmin[first.prim_ids], bmax[first.prim_ids],
                               cache)
        blas.append(fb)
        m_first = np.asarray(first.trs, np.float64)
        for ui in uis:
            u = units[ui]
            ids = np.asarray(u.prim_ids)
            if ids.size != len(first.prim_ids):
                return None   # same path, different tessellation
            mesh_of.append(mesh_id)
            xforms.append(m_first @ np.linalg.inv(
                np.asarray(u.trs, np.float64)))
            base.append(sum(count))
            count.append(ids.size)
            order.append(ids[fb.prim_order])

    xf12 = np.stack([x[:3, :4].reshape(12) for x in xforms]).astype(
        np.float32)
    return InstancePlan(
        order=np.concatenate(order).astype(np.int32),
        mesh_of=mesh_of, xform=xf12,
        base=np.asarray(base, np.int64),
        count=np.asarray(count, np.int64),
        blas=blas)


def _build_tlas_rows(tb: FlatBVH, ib_min: np.ndarray, ib_max: np.ndarray):
    """8-wide TLAS rows from the binary BVH's spatial DFS order: the
    instances in chunks of 8, parent rows fanned over the chunks until
    one root remains, relabelled so the root is row 0. Returns (rows,
    bounds): rows[k] lists ('i', inst) / ('r', row) children, bounds[k]
    is the row's union AABB."""
    items = [("i", int(i)) for i in tb.prim_order]
    rows: list[list] = []
    bounds: list[tuple[np.ndarray, np.ndarray]] = []

    def child_bb(c):
        return ((ib_min[c[1]], ib_max[c[1]]) if c[0] == "i"
                else bounds[c[1]])

    while True:
        level = []
        for k in range(0, len(items), 8):
            ch = items[k:k + 8]
            bbs = [child_bb(c) for c in ch]
            rows.append(ch)
            bounds.append((np.min([b[0] for b in bbs], axis=0),
                           np.max([b[1] for b in bbs], axis=0)))
            level.append(("r", len(rows) - 1))
        if len(level) == 1:
            break
        items = level
    # relabel: root (last emitted) -> row 0, keep the rest stable
    T = len(rows)
    perm = {T - 1: 0}
    perm.update({k: k + 1 for k in range(T - 1)})
    new_rows: list[list] = [None] * T
    new_bounds: list = [None] * T
    for k, ch in enumerate(rows):
        new_rows[perm[k]] = [(t, perm[v] if t == "r" else v)
                             for t, v in ch]
        new_bounds[perm[k]] = bounds[k]
    return new_rows, new_bounds


def build_instanced_table(plan: InstancePlan, dense_records: np.ndarray,
                          bmin: np.ndarray, bmax: np.ndarray):
    """The unified instanced BVH8 table.

    Row space: [TLAS node rows][BLAS node rows...][all leaf rows][zero].
    BLAS rows come from bvh8.build_bvh8 per unique mesh, metas re-based
    into the global row space; TLAS child slots hold instances as
    negative metas -(inst+1). dense_records: [P, 16] in global slot
    order; each BLAS reads its first instance's block with BLAS-local
    pids. Returns (table, n8_total, aux [n_inst, AUX_COLS], tlas_rows).
    """
    n_inst = plan.n_inst
    first_of_mesh = {}
    for i in range(n_inst):
        first_of_mesh.setdefault(plan.mesh_of[i], i)
    mesh_tabs = []
    for m, fb in enumerate(plan.blas):
        fi = first_of_mesh[m]
        b0 = int(plan.base[fi])
        cnt = int(plan.count[fi])
        recs = dense_records[b0:b0 + cnt].copy()
        recs[:, 12] = np.arange(cnt)          # BLAS-local pid
        mesh_tabs.append(bvh8_mod.build_bvh8(fb, recs))

    # TLAS over exact instance world bounds
    spans = [plan.order[int(plan.base[i]):int(plan.base[i] + plan.count[i])]
             for i in range(n_inst)]
    ib_min = np.stack([bmin[s].min(0) for s in spans])
    ib_max = np.stack([bmax[s].max(0) for s in spans])
    tb = build_bvh(ib_min, ib_max)
    trows, tbounds = _build_tlas_rows(tb, ib_min, ib_max)
    T = len(trows)

    # global row layout
    n8s = [n8 for _, n8 in mesh_tabs]
    leaf_counts = [tab.shape[0] - n8 - 1 for tab, n8 in mesh_tabs]
    node_base = [T]
    for n8 in n8s[:-1]:
        node_base.append(node_base[-1] + n8)
    n8_total = T + sum(n8s)
    leaf_base = [n8_total]
    for lc in leaf_counts[:-1]:
        leaf_base.append(leaf_base[-1] + lc)
    total_rows = n8_total + sum(leaf_counts) + 1
    table = np.zeros((total_rows, bvh8_mod.ROW_W), np.float32)

    tview = table[:T].reshape(T, 16, 8)
    tview[:, :8, 0:3] = np.inf
    tview[:, :8, 3:6] = -np.inf
    for k, children in enumerate(trows):
        for ci, c in enumerate(children):
            if c[0] == "r":
                tview[k, ci, 0:3] = tbounds[c[1]][0]
                tview[k, ci, 3:6] = tbounds[c[1]][1]
                tview[k, ci, 6] = c[1]
            else:
                inst = c[1]
                tview[k, ci, 0:3] = ib_min[inst]
                tview[k, ci, 3:6] = ib_max[inst]
                tview[k, ci, 6] = -(inst + 1)

    for m, (tab_m, n8_m) in enumerate(mesh_tabs):
        nb, lb = node_base[m], leaf_base[m]
        nview = tab_m[:n8_m].reshape(n8_m, 16, 8).copy()
        meta = nview[:, :8, 6]
        is_node = meta > 0
        is_lf = meta < 0
        meta[is_node] = meta[is_node] + nb
        meta[is_lf] = -((-meta[is_lf]) - n8_m + lb)
        nview[:, :8, 6] = meta
        table[nb:nb + n8_m] = nview.reshape(n8_m, bvh8_mod.ROW_W)
        lc = leaf_counts[m]
        table[lb:lb + lc] = tab_m[n8_m:n8_m + lc]

    aux = np.zeros((n_inst, AUX_COLS), np.float32)
    aux[:, 0:12] = plan.xform
    for i in range(n_inst):
        aux[i, 12] = node_base[plan.mesh_of[i]]
        aux[i, 13] = plan.base[i]
    aux[:, 14:17] = ib_min
    aux[:, 17:20] = ib_max
    return table, n8_total, aux, T
