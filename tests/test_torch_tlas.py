"""The instanced BVH8 walk's plain version (K4, instanced), which the
CUDA kernel is held to on the card, vs the JAX package.

The scene is tests/test_tlas.py's (meshA 3 times, one with a non-uniform
scale, meshB twice, a singleton mesh, a sphere and a line), flattened by
the JAX package with instances (PTPU_FORCE_INSTANCING and a lowered
MIN_INSTANCED_PRIMS, as test_tlas.py does; numpy BVH builder); the port
walks the JAX package's own tables. References: the JAX package's
instanced Pallas walk in interpret mode (its CPU route for instanced
scenes) and the port's brute force, on 2,048 rays. Limits: the same rays
hit, t within rtol 2e-5, prim ids equal on > 99.5%, any-hit equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_parity as tp
from gpu_pathtracer_tpu.geom import packet_tpu as jpacket_tpu
from gpu_pathtracer_tpu.geom import tlas as jtlas
from gpu_pathtracer_tpu.scene import flatten as jflatten
from gpu_pathtracer_tpu.scene import model as jmodel
from gpu_pathtracer_tpu.scene import objloader as jobj
from gpu_pathtracer_tpu_torch.geom import traverse

N = 2048


@pytest.fixture
def instanced(monkeypatch):
    tp.numpy_bvh_builder(monkeypatch)
    monkeypatch.setenv("PTPU_FORCE_INSTANCING", "1")
    monkeypatch.setattr(jtlas, "MIN_INSTANCED_PRIMS", 8)
    jd, js = jflatten.flatten_scene(tp.instanced_scene(jmodel, jobj),
                                    cache=False)
    td, ts = tp.port_scene_from_jax(jd, js)
    ro, rd, t_any = tp.aimed_rays(np.random.default_rng(22), N, -3.0, 3.0,
                                  -1.5, 1.5)
    return jd, js, td, ts, ro, rd, t_any


def test_instanced_plain_matches_jax_kernel(instanced):
    """K4 plain, instanced, vs the JAX package's instanced Pallas walk
    (interpret mode) and brute force, closest and any hit."""
    jd, js, td, ts, ro, rd, t_any = instanced
    eps = 1e-3
    assert traverse.regime(ts) == "instanced" and ts.bvh8_n_inst == 6
    inf = np.full(N, np.inf, np.float32)
    got = tp.plain_hits("K4", td, ts, ro, rd, eps, inf, False)
    ref = jpacket_tpu.packet_traverse(jd, js, jnp.asarray(ro),
                                      jnp.asarray(rd), eps, jnp.asarray(inf),
                                      any_hit=False, interpret=True)
    tp.hits_agree(got, ref)
    tp.hits_agree(got, tp.brute_hits(td, ts, ro, rd, eps, inf))
    found = tp.plain_hits("K4", td, ts, ro, rd, eps, t_any, True).numpy()
    _, _, j_any = jpacket_tpu.packet_traverse(
        jd, js, jnp.asarray(ro), jnp.asarray(rd), eps, jnp.asarray(t_any),
        any_hit=True, interpret=True)
    np.testing.assert_array_equal(found, np.asarray(j_any))
    np.testing.assert_array_equal(
        found, tp.brute_hits(td, ts, ro, rd, eps, t_any)[2].numpy())
