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

The walk's counts of an instanced scene (`inst_entered`, `blas_walks`):
walk_torch's against the model's replay of the kernel's visits, and
K4's counting form against walk_torch's on the card (the `card` tests,
run on a machine with a CUDA card without the suite's conftest.py,
which imports JAX:

    python -m pytest --noconftest tests/test_torch_bvh8_walk.py -m card -q
).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity as tp
from gpu_pathtracer_tpu_torch import kernels, telemetry
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
                stack_depth, prims, counts=None):
    """The kernel's walk, one ray at a time (see the module docstring):
    closest hit -> (t [N], prim [N]), any hit -> found [N]. An instanced
    closest hit on a triangle takes the t of its world record in `prims`
    (dense_prims); an instanced walk adds to `counts` (a dict) the
    instances the first slab pass enters ("inst_entered") and the BLAS
    walks begun ("blas_walks")."""
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
            if counts is not None:
                counts["inst_entered"] += len(keys)
            for key in keys:
                if np.uint32(key & ~63).view(np.float32) > best["t"]:
                    break
                if any_hit and best["prim"] >= 0:
                    break
                m = box[key & 63][None]
                if counts is not None:
                    counts["blas_walks"] += 1
                _walk_one(table, int(m[0, 12]), int(m[0, 13]),
                          packet._xform(m, o, True),
                          packet._xform(m, d, False), t0, t1, any_hit,
                          kinds, stack_depth, cap, best)
            if not any_hit and best["prim"] >= 0:
                rec = prims[best["prim"]]
                _, t = dense.rec_hits(
                    [rec[c:c + 1] for c in range(12)],
                    tuple(o[:, k] for k in range(3)),
                    tuple(d[:, k] for k in range(3)), -torch.inf,
                    torch.inf, (True, False, False))
                if int(rec[9]) == int(tmodel.GeometryType.TRIANGLE):
                    best["t"] = t[0].numpy()
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
    prims = td.dense_prims
    if name == "knot twice":
        table, _ = chip_smoke.tree_twice(table)   # every hit an exact tie
        stack = bvh8.stack_bound(table.numpy(), aux.numpy(), 0)
    return (table, aux, n_inst, stack, dense.kinds_of(ts), ro, rd, t_any,
            prims)


@pytest.mark.parametrize("name", ["knot", "knot twice", "instanced"])
def test_kernel_order_matches_plain_walk(name, knot, instanced):
    """The kernel's visit order, tie rule and culling give walk_torch's
    record and t on every lane, closest and any hit, with tmax infinite,
    finite, and empty on 30% of the lanes (each a miss at once); on the
    tree twice over every hit is an exact tie across leaves, and both
    take the copy's record (visited last). An instanced closest hit's
    t is its world record's."""
    table, aux, n_inst, stack, kinds, ro, rd, t_any, prims = _setup(
        name, knot, instanced)
    assert (n_inst > 0) == (name == "instanced")
    rng = np.random.default_rng(3)
    empty = torch.as_tensor(rng.random(N) < 0.3)
    dead = torch.as_tensor(rng.choice(np.float32([0.0, -1.0]), N))
    tmin = torch.full((N,), 1e-3)
    for tmax in (torch.full((N,), torch.inf), t_any,
                 torch.where(empty, dead, t_any)):
        args = (table, aux, n_inst, ro, rd, tmin, tmax)
        t_m, p_m = kernel_walk(*args, False, kinds, stack, prims)
        t_p, p_p = packet.walk_torch(*args, False, kinds, stack,
                                     prims=prims)
        assert torch.equal(p_m, p_p) and torch.equal(t_m, t_p)
        f_m = kernel_walk(*args, True, kinds, stack, prims)
        f_p = packet.walk_torch(*args, True, kinds, stack, prims=prims)
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
    kernel_walk(*args, ts.bvh8_stack, td.dense_prims)
    for walk in (lambda *a: kernel_walk(*a, td.dense_prims),
                 packet.walk_torch):
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
    table, aux, n_inst, stack, kinds, ro, rd, _, prims = _setup(
        name, knot, instanced)
    ro, rd = ro[:96], rd[:96]
    tmin, tmax = torch.full((96,), 1e-3), torch.full((96,), torch.inf)
    t, p = packet.walk_torch(table, aux, n_inst, ro, rd, tmin, tmax, False,
                             kinds, stack, prims=prims)
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
                        lambda *a, **kw: seen.append(a[-1]) or (a[6], a[6]))
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


COUNTS = ("inst_entered", "blas_walks")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


def _tmaxes(t_any):
    """tmax infinite, finite, and empty (0 or -1) on 30% of the lanes."""
    rng = np.random.default_rng(3)
    empty = torch.as_tensor(rng.random(t_any.shape[0]) < 0.3)
    dead = torch.as_tensor(rng.choice(np.float32([0.0, -1.0]),
                                      t_any.shape[0]))
    return {"inf": torch.full_like(t_any, torch.inf), "finite": t_any,
            "empty": torch.where(empty, dead, t_any)}


@pytest.mark.parametrize("tmax_kind", ["inf", "finite", "empty"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_walk_counts_match_the_kernel_model(any_hit, tmax_kind, instanced):
    """walk_torch's inst_entered and blas_walks equal the model's replay
    of K4's visits: every instance the first slab pass enters, every
    BLAS walk begun (nearest first, until one starts beyond the best t
    or, for any hit, a hit is found); an empty interval enters none."""
    table, aux, n_inst, stack, kinds, ro, rd, t_any, prims = _setup(
        "instanced", None, instanced)
    tmax = _tmaxes(t_any)[tmax_kind]
    args = (table, aux, n_inst, ro, rd, torch.full((N,), 1e-3), tmax)
    model = dict.fromkeys(COUNTS, 0)
    kernel_walk(*args, any_hit, kinds, stack, prims, counts=model)
    got = torch.zeros(2, dtype=torch.int64)
    out = packet.walk_torch(*args, any_hit, kinds, stack, counts=got,
                            prims=prims)
    assert got.tolist() == [model[k] for k in COUNTS]
    assert 0 < model["blas_walks"] <= model["inst_entered"] + N
    # the counts leave the walk's answer as it was
    plain = packet.walk_torch(*args, any_hit, kinds, stack, prims=prims)
    for a, b in zip(*(((x,) if any_hit else x) for x in (out, plain))):
        assert torch.equal(a, b)


def test_brute_work_bounds_inst_entered(instanced):
    """brute_work's inst_entered, the instances entered before each ray's
    final best t, is a lower bound on the walk's, entered before tmax."""
    table, aux, n_inst, stack, kinds, ro, rd, _, prims = _setup(
        "instanced", None, instanced)
    tmin, tmax = torch.full((N,), 1e-3), torch.full((N,), torch.inf)
    got = torch.zeros(2, dtype=torch.int64)
    t, _ = packet.walk_torch(table, aux, n_inst, ro, rd, tmin, tmax, False,
                             kinds, stack, counts=got, prims=prims)
    low = brute_work(table, aux, n_inst, ro, rd, t)["inst_entered"]
    assert 0 < low <= int(got[0])


def test_flat_walk_counts_nothing(knot, instanced, monkeypatch):
    """On a flat scene no counter tensor is made and walk_torch adds 0;
    an instanced scene's walk calls hand theirs to the spp's record."""
    monkeypatch.setattr(telemetry, "_R", telemetry._Recorder())
    td, ts, ro, rd, _ = knot
    assert packet._counts(ts, "cpu") is None
    zero = torch.zeros(2, dtype=torch.int64)
    packet.walk_torch(td.bvh8_table, td.bvh8_aux, 0, ro, rd, 1e-3,
                      torch.inf, False, dense.kinds_of(ts), ts.bvh8_stack,
                      counts=zero)
    assert zero.tolist() == [0, 0]
    with telemetry.iteration(1) as rec:
        packet.walk_closest(td, ts, ro, rd, 1e-3, torch.inf)
        packet.walk_any(td, ts, ro, rd, 1e-3, torch.inf)
    assert not set(COUNTS) & set(rec.counts)
    td, ts, ro, rd, _ = instanced
    with telemetry.iteration(2) as rec:
        packet.walk_closest(td, ts, ro, rd, 1e-3, torch.inf)
    want = torch.zeros(2, dtype=torch.int64)
    packet.walk_torch(td.bvh8_table, td.bvh8_aux, ts.bvh8_n_inst, ro, rd,
                      1e-3, torch.inf, False, dense.kinds_of(ts),
                      ts.bvh8_stack, counts=want, prims=td.dense_prims)
    assert [rec.total(k) for k in COUNTS] == want.tolist()
    assert len(rec.counts["blas_walks"]) == 1


def _card_instanced(monkeypatch):
    """The instanced fixture's scene, built with the port's numpy builder
    alone (the card's machine has no JAX), and 16,384 aimed rays."""
    from gpu_pathtracer_tpu_torch.geom import bvh as tbvh
    monkeypatch.setattr(tbvh, "NATIVE", False)
    monkeypatch.setattr(ttlas, "MIN_INSTANCED_PRIMS", 8)
    td, ts = tflatten.flatten_scene(tp.instanced_scene(tmodel, tobj), "cpu",
                                    instancing=True, cache=False)
    ro, rd, t_any = (torch.as_tensor(a) for a in tp.aimed_rays(
        np.random.default_rng(17), 16384, -3.0, 3.0, -1.5, 1.5))
    return td, ts, ro, rd, t_any


@pytest.mark.card
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_kernel_counts_match_the_plain_walk(any_hit, card, monkeypatch):
    """K4's instanced form adds inst_entered and blas_walks within 1% of
    walk_torch's on the same rays (the kernel is held to the plain walk
    within the hit limits, not bit for bit); on a flat table it counts
    nothing."""
    td, ts, ro, rd, t_any = _card_instanced(monkeypatch)
    kinds = dense.kinds_of(ts)
    for tmax in _tmaxes(t_any).values():
        args = (td.bvh8_table, td.bvh8_aux, ts.bvh8_n_inst, ro, rd,
                torch.full_like(tmax, 1e-3), tmax)
        want = torch.zeros(2, dtype=torch.int64)
        packet.walk_torch(*args, any_hit, kinds, ts.bvh8_stack, counts=want,
                          prims=td.dense_prims)
        got = torch.zeros(2, dtype=torch.int64, device=card)
        on = [a.to(card) if torch.is_tensor(a) else a for a in args]
        packet_cuda.bvh8_walk_cuda(*on, any_hit, ts.bvh8_stack, kinds,
                                   counts=got, prims=td.dense_prims.to(card))
        got = got.cpu()
        assert bool((want > 0).all())
        assert bool(((got - want).abs() <= 0.01 * want).all()), (got, want)
    flat = torch.zeros(2, dtype=torch.int64, device=card)
    packet_cuda.bvh8_walk_cuda(*on[:2], 0, *on[3:], any_hit, ts.bvh8_stack,
                               kinds, counts=flat)
    packet_cuda.settle_overflow(card)
    assert flat.tolist() == [0, 0]


@pytest.mark.card
def test_kernel_world_t_matches_the_plain_walk(card, monkeypatch):
    """K4's instanced closest hit on a triangle takes the t of its world
    record (dense_prims) with the plain walk's arithmetic:
    wherever the two take the same triangle, t is bit-equal to
    walk_torch's (a sphere's or a line's t is its test's, held within the
    hit limits)."""
    td, ts, ro, rd, t_any = _card_instanced(monkeypatch)
    kinds = dense.kinds_of(ts)
    tmin = torch.full_like(t_any, 1e-3)
    for tmax in _tmaxes(t_any).values():
        args = (td.bvh8_table, td.bvh8_aux, ts.bvh8_n_inst, ro, rd, tmin,
                tmax)
        t_p, p_p = packet.walk_torch(*args, False, kinds, ts.bvh8_stack,
                                     prims=td.dense_prims)
        on = [a.to(card) if torch.is_tensor(a) else a for a in args]
        t_k, p_k = (x.cpu() for x in packet_cuda.bvh8_walk_cuda(
            *on, False, ts.bvh8_stack, kinds,
            prims=td.dense_prims.to(card)))
        same = p_k == p_p
        assert same.float().mean() >= 0.999 and bool((p_p >= 0).any())
        tri = td.dense_prims[p_p.clamp_min(0).long(), 9] == 0.0
        both = same & (p_p >= 0) & tri
        assert bool(both.any())
        assert torch.equal(t_k[both], t_p[both]), (
            int((t_k[both] != t_p[both]).sum()), int(both.sum()))
    packet_cuda.settle_overflow(card)
