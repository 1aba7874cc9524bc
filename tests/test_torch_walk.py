"""The block-culled (K3) and flat BVH8-walk (K4) plain versions, which
the CUDA kernels are held to on the card, vs the JAX package.

The port runs on the JAX package's own tables (numpy BVH builder), so
prim ids compare directly. On the knot scene (2,012 prims; a 2,000-
triangle knot from tools/gen_knot_port.py in the 12-triangle room) the
JAX package's CPU route is its XLA packet walk (geom/packet.py); both
plain versions are held to it and to the port's brute force on 2,048
rays. Limits: the same rays hit, t within rtol 2e-5, prim ids equal on
> 99.5% (a ray through a shared edge may take either triangle), any-hit
equal. The instanced walk is tests/test_torch_tlas.py's.

The CUDA kernel of K3 visits a ray's entered blocks nearest first and
uses a tie rule that does not depend on that order; `nearest_first`
below is a plain model of it, held to blocked_hit_torch lane for lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.geom import packet as jpacket
from gpu_pathtracer_tpu_torch.geom import (
    blocked, blocked_cuda, dense, packet, packet_cuda, traverse,
)

N = 2048


@pytest.fixture
def knot(tmp_path, monkeypatch):
    jd, js = tp.jax_flatten(tp.write_knot_scene(tmp_path), monkeypatch)
    td, ts = tp.port_scene_from_jax(jd, js)
    ro, rd, t_any = tp.aimed_rays(
        np.random.default_rng(21), N, (-0.95, 0.05, -0.95),
        (0.95, 1.95, 0.95), (-0.5, 0.0, -0.25), (0.5, 1.0, 0.25))
    return jd, js, td, ts, ro, rd, t_any


@pytest.mark.parametrize("kind", ["K3", "K4"])
def test_plain_matches_jax_packet_walk(kind, knot):
    """K3 plain and K4 plain (flat) vs the JAX package's packet walk and
    brute force, closest and any hit."""
    jd, js, td, ts, ro, rd, t_any = knot
    eps = float(jd.epsilon)
    assert traverse.regime(ts) == "blocked" and ts.bvh8_n_inst == 0
    inf = np.full(N, np.inf, np.float32)
    got = tp.plain_hits(kind, td, ts, ro, rd, eps, inf, False)
    ref = jpacket.packet_traverse(jd, js, jnp.asarray(ro), jnp.asarray(rd),
                                  jnp.full(N, eps), jnp.asarray(inf), False)
    tp.hits_agree(got, ref)
    tp.hits_agree(got, tp.brute_hits(td, ts, ro, rd, eps, inf))
    found = tp.plain_hits(kind, td, ts, ro, rd, eps, t_any, True).numpy()
    _, _, j_any = jpacket.packet_traverse(
        jd, js, jnp.asarray(ro), jnp.asarray(rd), jnp.full(N, eps),
        jnp.asarray(t_any), True)
    np.testing.assert_array_equal(found, np.asarray(j_any))
    np.testing.assert_array_equal(
        found, tp.brute_hits(td, ts, ro, rd, eps, t_any)[2].numpy())
    assert 0.05 < found.mean() < 0.95


def test_cpu_tensors_take_the_plain_version(knot):
    """On CPU tensors the routed queries are the plain versions, and the
    CUDA wrappers refuse CPU tensors rather than fall back."""
    _, _, td, ts, ro, rd, _ = knot
    ro, rd = torch.as_tensor(ro), torch.as_tensor(rd)
    tmax = torch.full((N,), torch.inf)
    t, p, f = blocked.blocked_closest(td, ts, ro, rd, 1e-3, tmax)
    t2, p2 = blocked.blocked_hit_torch(td.dense_prims, td.block_bbox, ro, rd,
                                       1e-3, tmax, False, dense.kinds_of(ts))
    assert torch.equal(t, t2) and torch.equal(p, p2)
    h = traverse.intersect_closest(td, ts, ro, rd, 1e-3, tmax)
    assert torch.equal(h.prim_idx, torch.where(f, p, -1))
    t3, p3, _ = packet.walk_closest(td, ts, ro, rd, 1e-3, tmax)
    t4, p4, _ = packet.walk_closest(td, ts, ro, rd, 1e-3, tmax, plain=True)
    assert torch.equal(t3, t4) and torch.equal(p3, p4)
    tmin = torch.full((N,), 1e-3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        blocked_cuda.blocked_hit_cuda(td.dense_prims, td.block_bbox,
                                      td.block_sub, ro, rd, tmin, tmax, False,
                                      dense.kinds_of(ts))
    with pytest.raises(ValueError, match="CUDA tensor"):
        packet_cuda.bvh8_walk_cuda(td.bvh8_table, td.bvh8_aux, 0, ro, rd,
                                   tmin, tmax, False, ts.bvh8_stack)


def nearest_first(prims, bbox, ro, rd, tmin, tmax, any_hit, kinds):
    """Plain model of csrc/blocked.cu's visiting order: each ray visits
    the blocks whose box it enters (slab test against tmax) in order of
    entry distance (clamped at 0; the lower block first among equals),
    stops at the first one it enters beyond its best t, tests only the
    rows of the sub-boxes (blocked_cuda.sub_boxes) it enters against its
    best t, and takes a hit when t < best t, or t == best t and the row
    is larger; any hit stops at the first hit. Returns (t, prim), or
    found with `any_hit`."""
    n, nb = ro.shape[0], bbox.shape[0]
    assert prims.shape[0] == nb * blocked.BLOCK
    rows_of = prims.view(nb, blocked.BLOCK, 16)
    per = blocked.BLOCK // blocked_cuda.SUB
    sub = blocked_cuda.sub_boxes(prims, nb).view(nb, per, 8)
    inv = blocked.safe_inv(rd)
    ent, tn = blocked.slab(bbox[None, :, 0:3], bbox[None, :, 3:6],
                           ro[:, None], inv[:, None], tmax[:, None])
    tn = torch.where(ent, tn.clamp_min(0.0), torch.inf)
    tn_s, order = torch.sort(tn, dim=1, stable=True)
    n_ent = ent.sum(1)
    best_t = tmax.clone()
    best = torch.full((n,), -1, dtype=torch.int32)
    done = torch.zeros(n, dtype=torch.bool)
    for k in range(int(n_ent.max())):
        lanes = ((k < n_ent) & ~done & (tn_s[:, k] <= best_t)) \
            .nonzero().squeeze(1)
        if lanes.numel() == 0:
            continue
        b = order[lanes, k]
        rows = rows_of[b]
        col = [rows[:, :, c] for c in range(12)]
        o, d = ro[lanes], rd[lanes]
        ok, t = dense.rec_hits(col, tuple(o[:, j:j + 1] for j in range(3)),
                               tuple(d[:, j:j + 1] for j in range(3)),
                               tmin[lanes, None], best_t[lanes, None], kinds)
        in_sub, _ = blocked.slab(sub[b, :, 0:3], sub[b, :, 3:6], o[:, None],
                                 blocked.safe_inv(d)[:, None],
                                 best_t[lanes, None])
        ok = ok & in_sub.repeat_interleave(blocked_cuda.SUB, 1)
        got, t_new, j = blocked.last_min(ok, t)
        row = (b * blocked.BLOCK + j).to(torch.int32)
        take = got & ((t_new < best_t[lanes])
                      | ((t_new == best_t[lanes]) & (row > best[lanes])))
        best_t[lanes] = torch.where(take, t_new, best_t[lanes])
        best[lanes] = torch.where(take, row, best[lanes])
        if any_hit:
            done[lanes] = got
    return best >= 0 if any_hit else (best_t, best)


def doubled(prims, bbox):
    """The table twice over, the copy's blocks in reverse order after the
    original's: every prim has an exact twin in another block, at a
    larger row, with the same box."""
    nb = bbox.shape[0]
    rows = prims.view(nb, blocked.BLOCK, 16)
    return (torch.cat([rows, rows.flip(0)]).reshape(-1, 16).contiguous(),
            torch.cat([bbox, bbox.flip(0)]).contiguous())


@pytest.mark.parametrize("table", ["knot", "knot doubled"])
def test_nearest_first_model_matches_plain(table, knot):
    """The kernel's order (the model above) gives blocked_hit_torch's
    answer on every lane, closest and any hit; on the doubled table every
    hit is an exact tie across blocks, and both take the twin's larger
    row."""
    _, _, td, ts, ro, rd, t_any = knot
    prims, bbox = td.dense_prims, td.block_bbox
    if table == "knot doubled":
        prims, bbox = doubled(prims, bbox)
    kinds = dense.kinds_of(ts)
    ro, rd = torch.as_tensor(ro), torch.as_tensor(rd)
    tmin = torch.full((N,), 1e-3)
    for tmax in (torch.full((N,), torch.inf), torch.as_tensor(t_any)):
        t_m, p_m = nearest_first(prims, bbox, ro, rd, tmin, tmax, False,
                                 kinds)
        t_p, p_p = blocked.blocked_hit_torch(prims, bbox, ro, rd, tmin, tmax,
                                             False, kinds)
        assert torch.equal(p_m, p_p) and torch.equal(t_m, t_p)
        assert (p_p >= 0).float().mean() > 0.3
        if table == "knot doubled":
            assert bool((p_p[p_p >= 0] >= td.dense_prims.shape[0]).all())
    f_m = nearest_first(prims, bbox, ro, rd, tmin, torch.as_tensor(t_any),
                        True, kinds)
    f_p = blocked.blocked_hit_torch(prims, bbox, ro, rd, tmin,
                                    torch.as_tensor(t_any), True, kinds)
    assert torch.equal(f_m, f_p) and 0.05 < f_p.float().mean() < 0.95


def test_empty_intervals_miss(knot):
    """blocked_closest / blocked_any give a miss (prim -1, t = tmax, not
    found) on every lane whose interval is empty (tmax < tmin, here
    tmax <= 0 or tmax = tmin / 2), mixed with live lanes that hit."""
    _, _, td, ts, ro, rd, _ = knot
    rng = np.random.default_rng(5)
    ro, rd = torch.as_tensor(ro), torch.as_tensor(rd)
    empty = torch.as_tensor(rng.random(N) < 0.4)
    dead = torch.as_tensor(rng.choice(np.float32([0.0, -1.0, 5e-4]), N))
    tmax = torch.where(empty, dead, torch.inf)
    t, p, f = blocked.blocked_closest(td, ts, ro, rd, 1e-3, tmax)
    assert bool((p[empty] == -1).all()) and not bool(f[empty].any())
    assert torch.equal(t[empty], tmax[empty])
    assert f[~empty].float().mean() > 0.3
    found = blocked.blocked_any(td, ts, ro, rd, 1e-3, tmax)
    assert not bool(found[empty].any()) and torch.equal(found, f)


def all_kinds_table(rng, n_rows=120):
    """A dense_prims table of 40 triangles, 40 spheres and 40 segments in
    the Cornell room, padded to two 64-row blocks (8 pad rows: one
    sub-box of pad rows only)."""
    t = np.zeros((2 * blocked.BLOCK, 16), np.float32)
    t[n_rows:, 9] = -1.0
    v0 = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n_rows, 3))
    t[:n_rows, 0:3] = v0
    t[:40, 3:9] = rng.normal(0, 0.3, (40, 6))                  # e1 e2
    t[40:80, 9], t[40:80, 10] = 2, rng.uniform(0.05, 0.2, 40)  # spheres
    t[80:n_rows, 9] = 1                                        # segments
    t[80:n_rows, 3:6] = v0[80:] + rng.normal(0, 0.4, (n_rows - 80, 3))
    t[80:n_rows, 10:12] = rng.uniform(0.01, 0.08, (n_rows - 80, 2))
    t[:n_rows, 12] = np.arange(n_rows)
    return torch.as_tensor(t)


@pytest.mark.parametrize("table", ["knot", "all kinds"])
def test_sub_boxes_hold_every_hit(table, knot):
    """Each plain closest hit lies in the sub-box of its row, within the
    slab test the kernel makes against the ray's best t, so culling rows
    by sub-box drops no hit; a run of pad rows only is a NaN box that no
    ray enters."""
    _, _, td, ts, ro, rd, _ = knot
    ro, rd = torch.as_tensor(ro), torch.as_tensor(rd)
    if table == "knot":
        prims, nb, kinds = td.dense_prims, td.block_bbox.shape[0], \
            dense.kinds_of(ts)
        sub = td.block_sub
        torch.testing.assert_close(sub, blocked_cuda.sub_boxes(prims, nb),
                                   rtol=0, atol=0, equal_nan=True)
    else:
        prims, nb, kinds = all_kinds_table(np.random.default_rng(8)), 2, \
            (True, True, True)
        sub = blocked_cuda.sub_boxes(prims, nb)
        assert not bool(sub[:-1, 0:6].isnan().any())
    assert sub.shape == (nb * blocked.BLOCK // blocked_cuda.SUB, 8)
    assert bool(sub[-1, 0:6].isnan().all())
    tmax = torch.full((N,), torch.inf)
    t, p = dense.dense_closest_torch(prims, ro, rd, 1e-3, tmax, kinds)
    hit = p >= 0
    assert hit.float().mean() > 0.2
    box = sub[p[hit].long() // blocked_cuda.SUB]
    inside, _ = blocked.slab(box[:, 0:3], box[:, 3:6], ro[hit],
                             blocked.safe_inv(rd[hit]), t[hit])
    assert bool(inside.all())
    nan_box, _ = blocked.slab(sub[-1, 0:3], sub[-1, 3:6], ro,
                              blocked.safe_inv(rd), tmax)
    assert not bool(nan_box.any())
