"""Sharded rendering over torch.distributed (parallel/dist.py and
`Renderer(shard=True)`) on the CPU: a 2-rank gloo group, spawned once
for the module (tests/torch_dist_worker.py: a `file://` store, one
torch thread a rank, joined with a timeout of its own so that a hung
rank fails these tests, not the suite), renders every kind at 16x16,
depth 3, for 2 iterations (MLT 3); this process renders the same on
one rank. The rules (run/renderer.py):
- "pixel" (AO, PT, VPT) and "ir": bit-equal to one rank;
- "film" (LT), "hybrid" (BDPT): the same paths and lanes, the films
  summed in another order: within rtol 1e-5 (a float32 sum of
  non-negative terms in another order; float32 eps is 1.2e-7);
- "sppm": radius and photon statistic n bit-equal (m sums multiples of
  1/32, exactly), the film within rtol 1e-5;
- "mlt": the chains (u, lum, px) bit-equal, the film within rtol 1e-5;
- the rays equal one rank's in every kind.
Also: a PT checkpoint written by 2 ranks resumes bit-equal on 1; LT and
MLT checkpoints written by 1 rank resume on 2 (within rtol 1e-5); the
ranks' scene tables hash equal; in a group of one rank (gloo, in this
process) every kind runs its collectives and equals the unsharded
render bit for bit; and `lane_range` splits an axis as JAX's
NamedSharding(lane_mesh, P("lanes")) does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_worker as w
import torch_parity as tp

JOIN_TIMEOUT_S = 180
RTOL = 1e-5
LOOPBACK = {"GLOO_SOCKET_IFNAME": "lo"}   # the group stays on loopback


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 2-rank group; meanwhile render every case on one rank
    here. Returns (output directory of the group, {case: arrays})."""
    from gpu_pathtracer_tpu_torch.run import checkpoint as ckpt
    out = tmp_path_factory.mktemp("dist")
    for case in w.RESUMED:   # one rank's checkpoints, resumed by two
        r = w.renderer(case, False)
        r.render_iteration()
        ckpt.save_checkpoint(r, str(out / f"resume_{case}.npz"))
    env = dict(os.environ, PYTHONPATH=str(tp.REPO), OMP_NUM_THREADS="1",
               **LOOPBACK)
    procs = [subprocess.Popen(
        [sys.executable, str(tp.REPO / "tests" / "torch_dist_worker.py"),
         str(rank), "2", str(out / "store"), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        ref = {}
        for case, (_, _, iterations) in w.CASES.items():
            r = w.renderer(case, False)
            r.render(iterations)
            ref[case] = w.case_arrays(r)
        logs = [p.communicate(timeout=JOIN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
    return out, ref


@pytest.mark.parametrize("case", list(w.CASES))
def test_sharded_matches_one_rank(ranks, case):
    out, ref = ranks
    a = ref[case]
    b = dict(np.load(out / f"{case}.npz"))
    assert np.isfinite(b["film"]).all() and b["film"].sum() > 0
    assert int(b["rays"]) == int(a["rays"])
    if case in ("ao", "pt", "vpt", "ir"):
        np.testing.assert_array_equal(b["film"], a["film"])
        return
    np.testing.assert_allclose(b["film"], a["film"], rtol=RTOL, atol=0)
    if case == "sppm":
        np.testing.assert_array_equal(b["radius"], a["radius"])
        np.testing.assert_array_equal(b["n"], a["n"])
    if case == "mlt":
        for k in ("u", "lum", "px"):
            np.testing.assert_array_equal(b[k], a[k])


def test_gather_is_bit_for_bit(ranks):
    """Shard.gather over 2 ranks rebuilds each probe tensor exactly: the
    sum runs over the values' integer bits, so -0.0 stays -0.0 and NaN
    keeps its payload."""
    out, _ = ranks
    got = dict(np.load(out / "gather.npz"))
    for k, whole in w.gather_probe().items():
        want = whole.numpy()
        assert got[k].dtype == want.dtype and got[k].shape == want.shape
        assert got[k].tobytes() == want.tobytes(), k


def test_two_rank_checkpoint_resumes_on_one(ranks):
    """PT: 2 ranks render 2 iterations and save; one rank loads the file
    and renders 2 more, bit-equal to one rank's 4."""
    from gpu_pathtracer_tpu_torch.run import checkpoint as ckpt
    out, _ = ranks
    a = w.renderer("pt", False)
    a.render(4)
    b = w.renderer("pt", False)
    ckpt.load_checkpoint(b, str(out / "pt_ckpt.npz"))
    assert b.iteration == 2
    b.render(2)
    np.testing.assert_array_equal(b.radiance(), a.radiance())


@pytest.mark.parametrize("case", w.RESUMED)
def test_one_rank_checkpoint_resumes_on_two(ranks, case):
    """LT's film is kept on rank 0 only, MLT's chains are split by chain
    and its sums kept on rank 0: resumed on 2 ranks for one iteration,
    within rtol 1e-5 of one rank's 2 iterations (the chains equal)."""
    out, _ = ranks
    a = w.renderer(case, False)
    a.render(2)
    a = w.case_arrays(a)
    b = dict(np.load(out / f"resumed_{case}.npz"))
    np.testing.assert_allclose(b["film"], a["film"], rtol=RTOL, atol=0)
    if case == "mlt":
        np.testing.assert_array_equal(b["lum"], a["lum"])


def test_ranks_scene_tables_equal(ranks):
    """Every rank flattens the scene file itself: the tables agree with
    each other and with this process's."""
    out, _ = ranks
    here = w.table_hash(w.renderer("pt", False).device_scene)
    assert [(out / f"tables_{r}.txt").read_text() for r in range(2)] \
        == [here, here]


@pytest.mark.parametrize("n", [8 * 37, 1 << 12])
def test_lane_range_matches_jax_sharding(n):
    """lane_range for 8 ranks is the block each of 8 CPU devices holds
    when JAX places a round_up'd axis with P("lanes"); on the axis cut
    at n, the same blocks cut at n."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gpu_pathtracer_tpu.parallel import dist as jdist
    from gpu_pathtracer_tpu_torch.parallel import dist
    devices = jax.devices()[:8]
    mesh = jdist.lane_mesh(devices)
    for m in (n, n - 5):
        padded = jdist.round_up(m, 8)
        assert dist.round_up(m, 8) == padded
        x = jax.device_put(jnp.zeros(padded),
                           NamedSharding(mesh, P("lanes")))
        shards = {devices.index(s.device): s.index[0]
                  for s in x.addressable_shards}
        assert sorted(shards) == list(range(8))
        for r, sl in shards.items():
            assert dist.lane_range(padded, r, 8) == (sl.start, sl.stop)
            assert dist.lane_range(m, r, 8) == (min(sl.start, m),
                                                min(sl.stop, m))


def test_gather_and_reduce_in_a_world_of_one():
    """Without a group a Shard is a world of 1: its gather and reduce
    give back their input, and every lane is rank 0's."""
    import torch
    from gpu_pathtracer_tpu_torch.parallel import dist
    s = dist.Shard.current()
    assert (s.rank, s.world) == (0, 1) and s.range(10) == (0, 10)
    x = torch.tensor([-0.0, 1.0, float("nan")])
    assert s.gather(x, 3) is x and s.reduce(x) is x


@pytest.mark.parametrize("case", ["ao", "pt", "lt", "bdpt", "ir", "sppm",
                                  "mlt"])
def test_group_of_one_bit_equal(tmp_path, monkeypatch, case):
    """Joined to a group of one rank, Renderer(shard=True) runs the
    sharded code and its collectives (gathers, sums, MLT's chains drawn
    again by candidate index): bit-equal to the unsharded render."""
    import torch
    from gpu_pathtracer_tpu_torch.parallel import dist
    iterations = w.CASES[case][2]
    a = w.renderer(case, False)
    a.render(iterations)
    a = w.case_arrays(a)
    for k, v in LOOPBACK.items():
        monkeypatch.setenv(k, v)
    dist.init("gloo", f"file://{tmp_path / 'store'}", 0, 1, timeout_s=60)
    try:
        b = w.renderer(case, True)
        assert b.shard.joined and b.shard.world == 1
        b.render(iterations)
        b = w.case_arrays(b)
    finally:
        torch.distributed.destroy_process_group()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_shard_never_renders_alone(monkeypatch, tmp_path):
    """With WORLD_SIZE > 1 and no group, Renderer(shard=True) raises, and
    the CLI's --shard raises where the group cannot form (no
    MASTER_ADDR): neither renders as a world of 1."""
    from gpu_pathtracer_tpu_torch.run import cli
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="process group"):
        w.renderer("pt", True)
    out = tmp_path / "r.png"
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        cli.main([str(w.CORNELL), "--device", "cpu", "--size", "8", "--spp",
                  "1", "--shard", "--out", str(out)])
    assert not out.exists()
