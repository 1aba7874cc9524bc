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
        blocked_cuda.blocked_hit_cuda(td.dense_prims, td.block_bbox, ro, rd,
                                      tmin, tmax, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        packet_cuda.bvh8_walk_cuda(td.bvh8_table, td.bvh8_aux, 0, ro, rd,
                                   tmin, tmax, False, ts.bvh8_stack)
