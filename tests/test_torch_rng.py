"""The Philox draws of core/rng.py: the plain route of `philox_uniform`
(csrc/rng.cu's plain version) and who reaches it.

- `philox_uniform` on CPU lanes equals a plain-Python Philox4x32-10
  (the Random123 algorithm, written here) word for word, and the draws
  `PhiloxStream` and `uniform_rows` hand out bit for bit: lanes at and
  above 2**31, a first block above 0, 1, 7 and 136 rows (MLT's 4 + 3 D
  at depth 5), tags 0-6 and both extreme keys.
- Every integrator run with `plain=True` (ao, pt with the BSSRDF hook,
  vpt, lt, bdpt, ir, sppm, mlt at 16x16, depth 2) sends every draw to
  the gate with `plain` set, and none to the kernel's wrapper.
- One MLT step drawn by the port (`mutation_draws`, the plain route)
  gives the same chains when those draws are served to the JAX
  package's step, within test_torch_mlt.py's limits.
The kernel itself runs only on a card: chip_smoke.py holds it against
this plain version bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu.integrators import mlt as jmlt
from gpu_pathtracer_tpu_torch.core import rng as trng
from gpu_pathtracer_tpu_torch.core import rng_cuda
from gpu_pathtracer_tpu_torch.integrators import ir, mlt, sppm
from gpu_pathtracer_tpu_torch.run import reference
from gpu_pathtracer_tpu_torch.scene.flatten import flatten_scene
from test_torch_mlt import N_CHAINS, _served, boot  # noqa: F401
from test_torch_vpt import _host

M32 = 0xFFFFFFFF


def philox_ref(ctr, key):
    """Plain-Python Philox4x32-10 (Salmon et al., SC'11)."""
    c = list(ctr)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
        p0 = 0xD2511F53 * c[0]
        p1 = 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1,
             p0 & M32]
    return c


def _lanes(kind):
    rng = np.random.default_rng(12)
    if kind == "high":   # at and above 2**31, up to 2**32 - 1
        ids = np.concatenate([[1 << 31, M32, M32 - 1],
                              rng.integers(1 << 31, 1 << 32, size=34)])
    else:                # 37 lanes: not a multiple of any block size
        ids = np.concatenate([[0, 1, (1 << 31) - 1],
                              rng.integers(0, 1 << 31, size=34)])
    return torch.as_tensor(ids.astype(np.int64))


# (lanes, first block, rows, tag, (seed, iteration))
CASES = [
    ("low", 0, 1, 0, (0, 1)),
    ("high", 0, 7, trng.BDPT_LIGHT_TAG, (M32, M32)),
    ("high", 0, 136, trng.MLT_TAG, (2024, 5)),
    ("low", 3, 7, trng.BSSRDF_TAG, (0xDEADBEEF, 17)),
    ("high", 9, 136, trng.SPPM_PHOTON_TAG, (M32, 0)),
    ("low", 1, 136, trng.IR_VPL_TAG, (0, M32)),
]


@pytest.mark.parametrize("kind, block0, n_rows, tag, key", CASES)
def test_plain_route_is_the_stream_sites(kind, block0, n_rows, tag, key):
    """Row 4 b + k of philox_uniform is word k of philox((lane, block0 +
    b, tag, 0), key) >> 8 times 2**-24; the same rows are PhiloxStream's
    sites from 4 block0 on and, from block 0, uniform_rows' rows."""
    lanes = _lanes(kind)
    n_blocks = (n_rows + 3) // 4
    rows = trng.philox_uniform(lanes, block0, n_blocks, tag, *key)
    assert rows.shape == (4 * n_blocks, lanes.shape[0])
    assert rows.dtype == torch.float32
    for j, lane in enumerate(lanes.tolist()):
        for b in range(n_blocks):
            w = philox_ref((lane, block0 + b, tag, 0), key)
            for k in range(4):
                assert rows[4 * b + k, j].item() == (w[k] >> 8) * 2.0 ** -24
    s = trng.PhiloxStream(*key, lanes, base=4 * block0, tag=tag)
    drawn = torch.stack([s.uniform() for _ in range(n_rows)])
    assert torch.equal(drawn, rows[:n_rows])
    if block0 == 0:
        assert torch.equal(trng.uniform_rows(*key, lanes, n_rows, tag),
                           rows[:n_rows])
    stream = trng.lane_stream(*key, lanes, None, 4 * block0, n_rows, tag,
                              plain=True)
    assert torch.equal(stream.uniform(), rows[0])


def test_cuda_wrapper_refuses_cpu_lanes():
    """The kernel's wrapper takes CUDA lanes only; it checks before it
    builds or launches anything."""
    with pytest.raises(ValueError, match="CUDA"):
        rng_cuda.philox_uniform_cuda(torch.arange(4), 0, 1, 0, 1, 1)


def _scene(path, **repl):
    scene, static = flatten_scene(_host(path, 16), "cpu", cache=False)
    return scene, dataclasses.replace(static, max_depth=2, **repl)


def _run(integ):
    """One all-plain iteration of program `integ` at 16x16, depth 2."""
    path = {"pt": tp.BSSRDF_SCENE, "vpt": tp.SMOKE_SCENE}.get(
        integ, tp.PORT_SCENES["cornell"])
    scene, static = _scene(path, **(
        {"photons_per_iteration": 1024} if integ == "sppm" else {}))
    n = static.width * static.height
    ids = torch.arange(n, dtype=torch.int32)
    px, py = ids % static.width, ids // static.width
    if integ in ("ao", "pt", "vpt", "lt", "bdpt"):
        return reference.run_program(integ, scene, static, ids, 3,
                                     plain=True)
    if integ == "ir":
        vpls = ir.generate_vpls(scene, static, 3, 1, plain=True)
        return ir.render_lanes(scene, static, 3, 1, px, py, vpls, 0,
                               plain=True)
    if integ == "sppm":
        state = sppm.init_state(n, static.init_radius, "cpu")
        return sppm.render_iteration(scene, static, 3, 1, state, px, py,
                                     plain=True)
    cands = mlt.candidates(scene, static, 3, n, plain=True)
    state = mlt.resample(static, cands)   # unsharded: it draws nothing
    return mlt.render_iteration(scene, static, 3, 1, state, plain=True)


@pytest.mark.parametrize("integ", ["ao", "pt", "vpt", "lt", "bdpt", "ir",
                                   "sppm", "mlt"])
def test_plain_runs_draw_nothing_through_the_kernel(integ, monkeypatch):
    """Every draw of a `plain=True` run reaches philox_uniform's gate with
    `plain` set, and none reaches the kernel's wrapper."""
    seen = []
    gate = trng.philox_uniform

    def spy(lanes, block0, n_blocks, tag, seed, iteration, plain=False):
        seen.append(plain)
        return gate(lanes, block0, n_blocks, tag, seed, iteration, plain)

    def kernel(*args):
        raise AssertionError("a plain run launched csrc/rng.cu")

    monkeypatch.setattr(trng, "philox_uniform", spy)
    monkeypatch.setattr(rng_cuda, "philox_uniform_cuda", kernel)
    _run(integ)
    assert seen and all(seen), (len(seen), seen.count(False))


def test_mlt_step_from_port_draws_matches_jax(boot, monkeypatch):  # noqa: F811
    """The port's own Philox draws of one mutation step (iteration 1,
    the plain route), served to the JAX package's step, give the chains
    the port's step gives from its own draws."""
    sj, d = boot["sj"], boot["d"]
    sel, acc, fresh, mag, sign = (x.numpy() for x in mlt.mutation_draws(
        0, 1, N_CHAINS, d, "cpu", plain=True))
    monkeypatch.setattr(jmlt, "jax", _served([sel[None], fresh, mag, sign,
                                              acc]))
    nj, img_j = jmlt.render_iteration(
        boot["jd"], boot["js"], jax.random.PRNGKey(1),
        {k: jnp.asarray(v) for k, v in sj.items()})
    nj = {k: np.asarray(v) for k, v in nj.items()}
    nt, img_t = mlt.render_iteration(boot["td"], boot["ts"], 0, 1,
                                     mlt.state_from_numpy(sj, "cpu"))
    np.testing.assert_allclose(nt["u"].numpy(), nj["u"], atol=1e-6)
    assert tp.close_lanes(nt["lum"].numpy()[:, None],
                          nj["lum"][:, None]).mean() >= 0.99
    assert abs(img_t.numpy().sum() / np.asarray(img_j).sum() - 1.0) <= 1e-3
    np.testing.assert_allclose(float(nt["b_cnt"]), float(nj["b_cnt"]),
                               rtol=1e-5)
