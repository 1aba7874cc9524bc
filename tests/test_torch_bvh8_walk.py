"""The BVH8 walk's CUDA kernel (K4, csrc/bvh8_walk.cu) and the path-trace
megakernel (K2) as far as the CPU can hold them: the kernel's visit
order, tie rule, culling and empty-interval exit, modelled in plain
PyTorch and held to the plain walk (geom/packet.py::walk_torch) lane for
lane; chip_smoke.py's count of the least work of a walk (`k4_work`,
K4's bound) against a brute-force count; the variants the wrappers of K2
and K4 choose; and the stack-overflow check that the renderer makes
once per spp.

The model (`kernel_walk`) walks one ray at a time as a kernel thread
does: a stack of node groups (a node row and its entered children not
yet taken, nearest first by the kernel's 32-bit keys: the entry
distance's ordered bits with the slot in the low 3 bits), a count of the
children pushed and not yet taken held to the stack depth, a record
taken when its t <= the best t in visit order, culling against the t of
the record taken, instances visited nearest first by keys with the
instance in the low 6 bits. It takes each record's t from the plain
test (the kernel decides by its division-free test, which agrees with
it within the hit limits, checked on the card by chip_smoke.py, and
computes a taken record's t as the plain test does).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity as tp
from gpu_pathtracer_tpu_torch import kernels
from gpu_pathtracer_tpu_torch.geom import (
    blocked, bvh8, dense, packet, packet_cuda, traverse,
)
from gpu_pathtracer_tpu_torch.geom import tlas as ttlas
from gpu_pathtracer_tpu_torch.integrators import pt_fused
from gpu_pathtracer_tpu_torch.run.renderer import Renderer
from gpu_pathtracer_tpu_torch.scene import flatten as tflatten
from gpu_pathtracer_tpu_torch.scene import model as tmodel
from gpu_pathtracer_tpu_torch.scene import objloader as tobj
from gpu_pathtracer_tpu_torch.scene.parse import load_scene

N = 384


def order_bits(x: float) -> int:
    """csrc/bvh8_walk.cu::order_bits: float32 bits that order like x."""
    u = int(np.float32(x).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000


def kernel_walk(table, aux, n_inst, ro, rd, tmin, tmax, any_hit, kinds,
                stack_depth):
    """The kernel's walk, one ray at a time (see the module docstring):
    closest hit -> (t [N], prim [N]), any hit -> found [N]."""
    n = ro.shape[0]
    t_out = tmax.clone()
    p_out = torch.full((n,), -1, dtype=torch.int32)
    tri_only = not kernels.all_kinds(kinds)
    cap = packet_cuda.group_cap(stack_depth)
    for i in range(n):
        t0, t1 = float(tmin[i]), float(tmax[i])
        if not t1 >= t0 and (tri_only or not t1 > 0.0):
            continue   # an empty interval: a miss at once
        best = {"t": np.float32(t1), "prim": -1}
        o, d = ro[i:i + 1], rd[i:i + 1]
        if n_inst == 0:
            _walk_one(table, 0, 0, o, d, t0, t1, any_hit, kinds,
                      stack_depth, cap, best)
        else:
            box = aux[:n_inst]
            hit, tn = blocked.slab(box[:, 14:17], box[:, 17:20], o,
                                   blocked.safe_inv(d), torch.tensor(t1))
            keys = sorted((int(np.float32(max(float(tn[k]), 0.0))
                               .view(np.uint32)) & ~63) | k
                          for k in range(n_inst) if hit[k])
            for key in keys:
                if np.uint32(key & ~63).view(np.float32) > best["t"]:
                    break
                if any_hit and best["prim"] >= 0:
                    break
                m = box[key & 63][None]
                _walk_one(table, int(m[0, 12]), int(m[0, 13]),
                          packet._xform(m, o, True),
                          packet._xform(m, d, False), t0, t1, any_hit,
                          kinds, stack_depth, cap, best)
        t_out[i] = float(best["t"])
        p_out[i] = best["prim"]
    return p_out >= 0 if any_hit else (t_out, p_out)


def _children(table, row, o, inv, cull):
    """The entered children of node row `row`: their slots, nearest first
    by the kernel's keys."""
    slots = table[row, :64].view(8, 8)
    hit, tn = blocked.slab(slots[:, 0:3], slots[:, 3:6], o, inv,
                           torch.tensor(float(cull)))
    hit = hit & (slots[:, 6] != 0)
    keys = sorted((order_bits(float(tn[c])) & ~7) | c
                  for c in range(8) if hit[c])
    return [k & 7 for k in keys]


def _walk_one(table, root, base, o, d, t0, t1, any_hit, kinds, depth, cap,
              best):
    inv = blocked.safe_inv(d)
    stack = []
    row, todo = root, _children(table, root, o, inv, best["t"])
    if len(todo) > depth:
        raise RuntimeError("stack overflow")
    pending = len(todo)
    while True:
        if not todo:
            if not stack:
                return
            row, todo = stack.pop()
        s = todo.pop(0)
        pending -= 1
        meta = int(table[row, 8 * s + 6])
        if meta > 0:
            kids = _children(table, meta, o, inv, best["t"])
            if pending + len(kids) > depth:
                raise RuntimeError("stack overflow")
            pending += len(kids)
            if todo:
                if len(stack) == cap:
                    raise RuntimeError("group stack overflow")
                stack.append((row, todo))
            row, todo = meta, kids
            continue
        rec = table[-meta].view(8, 16)
        ok, t = dense.rec_hits(
            [rec[:, c][None] for c in range(12)],
            tuple(o[:, k:k + 1] for k in range(3)),
            tuple(d[:, k:k + 1] for k in range(3)),
            torch.tensor([[t0]]), torch.tensor([[t1 if any_hit else
                                                  float(best["t"])]]),
            kinds)
        for j in range(8):
            if not rec[j, 13] > 0:
                break
            if not ok[0, j]:
                continue
            if any_hit:
                best["t"], best["prim"] = t[0, j].numpy(), 1
                return
            if t[0, j] <= float(best["t"]):
                best["t"] = t[0, j].numpy()
                best["prim"] = int(rec[j, 12]) + base


@pytest.fixture(scope="module")
def knot(tmp_path_factory):
    """tests/test_torch_walk.py's knot scene (2,012 prims) flattened by the
    port (numpy BVH builder), with aimed rays."""
    mp = pytest.MonkeyPatch()
    tp.numpy_bvh_builder(mp)
    try:
        path = tp.write_knot_scene(tmp_path_factory.mktemp("knot"))
        td, ts = tflatten.flatten_scene(load_scene(str(path)), "cpu",
                                        cache=False)
    finally:
        mp.undo()
    ro, rd, t_any = (torch.as_tensor(a) for a in tp.aimed_rays(
        np.random.default_rng(21), N, (-0.95, 0.05, -0.95),
        (0.95, 1.95, 0.95), (-0.5, 0.0, -0.25), (0.5, 1.0, 0.25)))
    return td, ts, ro, rd, t_any


@pytest.fixture(scope="module")
def instanced():
    """tests/test_torch_bvh8.py's instanced scene (6 instances, a sphere
    and a line), instanced on the CPU, with aimed rays."""
    mp = pytest.MonkeyPatch()
    tp.numpy_bvh_builder(mp)
    mp.setattr(ttlas, "MIN_INSTANCED_PRIMS", 8)
    try:
        td, ts = tflatten.flatten_scene(tp.instanced_scene(tmodel, tobj),
                                        "cpu", instancing=True, cache=False)
    finally:
        mp.undo()
    ro, rd, t_any = (torch.as_tensor(a) for a in tp.aimed_rays(
        np.random.default_rng(13), N, -3.0, 3.0, -1.5, 1.5))
    return td, ts, ro, rd, t_any


def _setup(name, knot, instanced):
    td, ts, ro, rd, t_any = knot if name.startswith("knot") else instanced
    table, aux, n_inst, stack = (td.bvh8_table, td.bvh8_aux, ts.bvh8_n_inst,
                                 ts.bvh8_stack)
    if name == "knot twice":
        table, _ = chip_smoke.tree_twice(table)   # every hit an exact tie
        stack = bvh8.stack_bound(table.numpy(), aux.numpy(), 0)
    return table, aux, n_inst, stack, dense.kinds_of(ts), ro, rd, t_any


@pytest.mark.parametrize("name", ["knot", "knot twice", "instanced"])
def test_kernel_order_matches_plain_walk(name, knot, instanced):
    """The kernel's visit order, tie rule and culling give walk_torch's
    record and t on every lane, closest and any hit, with tmax infinite,
    finite, and empty on 30% of the lanes (each a miss at once); on the
    tree twice over every hit is an exact tie across leaves, and both
    take the copy's record (visited last)."""
    table, aux, n_inst, stack, kinds, ro, rd, t_any = _setup(name, knot,
                                                              instanced)
    assert (n_inst > 0) == (name == "instanced")
    rng = np.random.default_rng(3)
    empty = torch.as_tensor(rng.random(N) < 0.3)
    dead = torch.as_tensor(rng.choice(np.float32([0.0, -1.0]), N))
    tmin = torch.full((N,), 1e-3)
    for tmax in (torch.full((N,), torch.inf), t_any,
                 torch.where(empty, dead, t_any)):
        args = (table, aux, n_inst, ro, rd, tmin, tmax)
        t_m, p_m = kernel_walk(*args, False, kinds, stack)
        t_p, p_p = packet.walk_torch(*args, False, kinds, stack)
        assert torch.equal(p_m, p_p) and torch.equal(t_m, t_p)
        f_m = kernel_walk(*args, True, kinds, stack)
        f_p = packet.walk_torch(*args, True, kinds, stack)
        assert torch.equal(f_m, f_p) and bool(f_p.any())
        if bool(torch.isinf(tmax).all()):
            assert (p_p >= 0).float().mean() > 0.2
    assert not bool(f_p[empty].any()) and bool((p_m[empty] == -1).all())
    if name == "knot twice":
        hit = p_p >= 0
        assert bool((p_p[hit] >= knot[1].n_primitives).all())


def test_kernel_model_overflows_like_the_plain_walk(knot):
    """The kernel counts the children pushed and not yet taken, as the
    plain walk's stack holds them: both raise on a 2-entry stack, and
    neither on the stack that bvh8.stack_bound gives."""
    td, ts, ro, rd, _ = knot
    args = (td.bvh8_table, td.bvh8_aux, 0, ro[:64], rd[:64],
            torch.full((64,), 1e-3), torch.full((64,), torch.inf), False,
            dense.kinds_of(ts))
    kernel_walk(*args, ts.bvh8_stack)
    for walk in (kernel_walk, packet.walk_torch):
        with pytest.raises(RuntimeError, match="stack"):
            walk(*args, 2)
    assert packet_cuda.group_cap(ts.bvh8_stack) >= bvh8.node_depth(
        td.bvh8_table.numpy(), [0]) - 1


def brute_work(table, aux, n_inst, ro, rd, t_best) -> dict:
    """k4_work's counts by another route: per ray, per instance it
    enters, every node row in row order (a parent's row comes before its
    children's), opened when its parent is opened and the ray enters the
    parent's slot for it at tn <= t_best."""
    out = dict.fromkeys(("inst", "inst_entered", "nodes", "slabs", "leaves",
                         "records", "record_flops"), 0)
    for i in range(ro.shape[0]):
        o, d, t = ro[i:i + 1], rd[i:i + 1], t_best[i:i + 1]
        frames = [(o, d, 0)]
        if n_inst:
            box = aux[:n_inst]
            out["inst"] += n_inst
            ent, _ = blocked.slab(box[:, 14:17], box[:, 17:20], o,
                                  blocked.safe_inv(d), t)
            frames = [(packet._xform(box[k][None], o, True),
                       packet._xform(box[k][None], d, False),
                       int(box[k, 12])) for k in range(n_inst) if ent[k]]
            out["inst_entered"] += len(frames)
        for fo, fd, root in frames:
            inv = blocked.safe_inv(fd)
            opened = {root}
            for row in range(table.shape[0]):
                if row not in opened:
                    continue
                slots = table[row, :64].view(8, 8)
                meta = slots[:, 6]
                out["nodes"] += 1
                out["slabs"] += int((meta != 0).sum())
                ent, _ = blocked.slab(slots[:, 0:3], slots[:, 3:6], fo, inv,
                                      t)
                for c in range(8):
                    m = int(meta[c])
                    if not ent[c] or m == 0:
                        continue
                    if m > 0:
                        opened.add(m)
                        continue
                    rec = table[-m].view(8, 16)
                    live = rec[:, 13] > 0
                    out["leaves"] += 1
                    out["records"] += int(live.sum())
                    out["record_flops"] += int(
                        (chip_smoke.type_flops(rec[:, 9]) * live).sum())
    return out


@pytest.mark.parametrize("name", ["knot", "instanced"])
def test_k4_work_matches_brute_force(name, knot, instanced):
    """chip_smoke.py::k4_work (K4's bound: the node rows, slab tests, leaf
    rows and records a walk must test before each ray's closest hit)
    equals a brute-force count on 96 rays."""
    table, aux, n_inst, stack, kinds, ro, rd, _ = _setup(name, knot,
                                                         instanced)
    ro, rd = ro[:96], rd[:96]
    tmin, tmax = torch.full((96,), 1e-3), torch.full((96,), torch.inf)
    t, p = packet.walk_torch(table, aux, n_inst, ro, rd, tmin, tmax, False,
                             kinds, stack)
    assert (p >= 0).float().mean() > 0.2
    work = chip_smoke.k4_work(table, aux, n_inst, ro, rd, tmin, t)
    assert work == brute_work(table, aux, n_inst, ro, rd, t)
    assert work["records"] > 0
    b = chip_smoke.k4_bound(table, aux, n_inst, ro, rd, tmin, tmax, t)
    assert b["bound_ms"] > 0 and "node rows" in b["work"]


def test_wrappers_choose_their_variant(knot, monkeypatch, tmp_path):
    """K4's wrapper takes its triangles-only variant on the knot and its
    all-kinds variant on a scene with spheres and lines; K2's the same on
    cornell_port and materials.json."""
    td, ts, ro, rd, _ = knot
    seen = []
    monkeypatch.setattr(packet_cuda, "bvh8_walk_cuda",
                        lambda *a: seen.append(a[-1]) or (a[6], a[6]))
    sl = tflatten.flatten_scene(
        load_scene(str(tp.write_sphere_line_scene(tmp_path))), "cpu",
        cache=False)
    for scene, static in ((td, ts), sl):
        packet._kernel(scene, static, ro, rd, 1e-3, torch.inf, False)
    assert [kernels.all_kinds(k) for k in seen] == [False, True]
    assert pt_fused.all_kinds(tflatten.flatten_scene(
        load_scene(str(tp.PORT_SCENES["cornell"])), "cpu")[1]) is False
    assert pt_fused.all_kinds(tflatten.flatten_scene(
        load_scene(str(tp.PORT_SCENES["materials"])), "cpu")[1]) is True


def test_overflow_is_checked_once_per_spp(knot, monkeypatch):
    """The kernel's overflow flag stays on the device across launches:
    check_overflow raises (with the stack depth) when it is set and
    clears it. The renderer checks once per spp on a scene the walk
    serves; there the plain walk raises at once on a 2-entry stack."""
    flag = packet_cuda.overflow_flag("cpu", 7)
    flag.fill_(1)
    with pytest.raises(RuntimeError, match="passed 7 entries"):
        packet_cuda.check_overflow("cpu")
    packet_cuda.check_overflow("cpu")   # cleared
    packet_cuda.check_overflow()

    calls = []
    real = packet_cuda.check_overflow
    monkeypatch.setattr(packet_cuda, "check_overflow",
                        lambda dev=None: calls.append(dev) or real(dev))
    monkeypatch.setattr(traverse, "regime", lambda static: "bvh8")
    host = load_scene(str(tp.PORT_SCENES["cornell"]))
    host.width = host.height = 8
    r = Renderer(host, device="cpu")
    r.render(2)
    assert len(calls) == 2 and r.static.bvh8_n_inst == 0
    r.static = dataclasses.replace(r.static, bvh8_stack=2)
    with pytest.raises(RuntimeError, match="stack"):
        r.render_iteration()
