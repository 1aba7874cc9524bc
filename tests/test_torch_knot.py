"""The slice as a whole: path tracing of a large mesh, JAX package vs port,
and the port's coherence sorts.

The scene is scenes/knot_port/scene.json with a 2,000-triangle knot of
the same generator (tools/gen_knot_port.py): 2,012 prims, so both
packages leave the dense regime (the port's block-culled route, the JAX
package's packet walk on the CPU). Both trace the same 32 x 32 lanes at
depth 5 from the same primary-sample matrix, which runs both wavefronts
unsorted (the JAX package asserts it, integrators/pt.py:135-139; its
KNOCK set is patched to {"sort"} for that, nothing in the package
changes). Limits as tests/test_torch_pt.py: >= 99% of lanes within atol
1e-4 + rtol 1e-3, mean ratio within 1e-3.

The port's sorted wavefront (Philox draws keyed by lane id) must equal
its unsorted one (the same draws given as a psample matrix) bit for bit
on every lane, and so must its sorted and unsorted shadow rays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.integrators import common as jcommon
from gpu_pathtracer_tpu.integrators import pt as jpt
from gpu_pathtracer_tpu_torch.core import rng as trng
from gpu_pathtracer_tpu_torch.geom import traverse
from gpu_pathtracer_tpu_torch.integrators import common, pt

SIZE = 32


@pytest.fixture
def knot(tmp_path, monkeypatch):
    jd, js = tp.jax_flatten(tp.write_knot_scene(tmp_path), monkeypatch)
    td, ts = tp.port_scene_from_jax(jd, js)
    n = SIZE * SIZE
    px = np.arange(n, dtype=np.int32) % SIZE
    py = np.arange(n, dtype=np.int32) // SIZE
    return jd, js, td, ts, px, py


def _philox_matrix(static, seed, iteration, px, py):
    """psample [4 + 8 * depth, N] holding exactly the Philox draws the
    sorted wavefront makes (site d of lane = pixel index)."""
    d = trng.PSS_CAM_DIMS + static.max_depth * trng.PSS_BOUNCE_DIMS
    s = trng.PhiloxStream(seed, iteration, pt.lane_ids_of(static, px, py))
    return torch.stack([s.uniform() for _ in range(d)])


def test_knot_render_lanes_match_jax(knot, monkeypatch):
    jd, js, td, ts, px, py = knot
    assert ts.n_primitives == 2012 and traverse.regime(ts) == "blocked"
    monkeypatch.setattr(jcommon, "KNOCK", frozenset({"sort"}))
    d = trng.PSS_CAM_DIMS + ts.max_depth * trng.PSS_BOUNCE_DIMS
    u = np.random.default_rng(5).random((d, px.size), dtype=np.float32)
    lj = np.asarray(jpt.render_lanes(jd, js, jax.random.PRNGKey(0),
                                     jnp.asarray(px), jnp.asarray(py),
                                     psample=jnp.asarray(u)))
    lt = pt.wavefront(td, ts, 0, 1, torch.as_tensor(px), torch.as_tensor(py),
                      psample=torch.as_tensor(u)).numpy()
    assert lt.shape == (px.size, 3) and np.isfinite(lt).all()
    assert tp.close_lanes(lt, lj).mean() >= 0.99
    assert abs(lt.mean() / lj.mean() - 1.0) <= 1e-3
    assert lj.mean() > 0.01


@pytest.mark.parametrize("regime", ["blocked", "bvh8"])
def test_sorted_wavefront_is_bit_equal(knot, regime, monkeypatch):
    """Sorted (Philox) vs unsorted (the same draws as psample), on the
    block-culled route and on the BVH8 walk (the same scene routed as a
    large one); then sorted shadow rays vs unsorted ones."""
    _, _, td, ts, px, py = knot
    if regime == "bvh8":
        monkeypatch.setattr(traverse.blocked, "BLOCKED_MAX", 1000)
    assert traverse.regime(ts) == regime
    px, py = torch.as_tensor(px), torch.as_tensor(py)
    u = _philox_matrix(ts, 7, 3, px, py)
    li_s, rays_s = pt.wavefront(td, ts, 7, 3, px, py, True)
    li_u, rays_u = pt.wavefront(td, ts, 7, 3, px, py, True, u)
    assert torch.equal(li_s, li_u) and int(rays_s) == int(rays_u)
    assert li_s.mean() > 0.01
    for force in (True, False):
        monkeypatch.setattr(common, "FORCE_SHADOW_SORT", force)
        assert torch.equal(pt.wavefront(td, ts, 7, 3, px, py), li_s)


def test_sort_keys_and_permutation(knot):
    """The lane permutation moves packed float and int state together;
    dead lanes sort last; the shadow sort's verdicts land on their own
    lanes."""
    _, _, td, ts, _, _ = knot
    rng = np.random.default_rng(3)
    n = 4096
    ro = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32)
    rd = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    alive = torch.as_tensor(rng.random(n) < 0.7)
    key = pt._sort_key(td, ro, rd, alive)
    order = torch.sort(key, stable=True).indices
    assert (~alive[order][:int(alive.sum())]).sum() == 0
    lanes = torch.arange(n) * 7 + 3
    (ro_p, w), (lanes_p,) = common.permute_lanes(order, (ro, ro[:, 0]),
                                                 (lanes,))
    assert torch.equal(ro_p, ro[order]) and torch.equal(w, ro[order, 0])
    assert torch.equal(lanes_p.long(), lanes[order])
    sd = torch.nn.functional.normalize(rd, dim=1)
    st = torch.as_tensor(rng.uniform(0.1, 2.0, n), dtype=torch.float32)
    occ = traverse.intersect_any(td, ts, ro, sd, 1e-3,
                                 torch.where(alive, st, 0.0))
    for force in (True, False):
        common.FORCE_SHADOW_SORT = force
        try:
            got = common._occluded_sorted(td, ts, ro, sd, st, alive, 1e-3)
        finally:
            common.FORCE_SHADOW_SORT = None
        assert torch.equal(got, occ)
