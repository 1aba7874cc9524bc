"""core/: vecmath and sampling vs the JAX package, and the Philox stream.

The same numpy inputs go through both packages (atol 1e-6, rtol 1e-5: the
two compute in float32 with the same formulas, so they differ by a few ulp
at most). Philox4x32-10 is checked against the Random123 known-answer
vectors and against a plain-Python reference written here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (thread count)
from gpu_pathtracer_tpu.core import sampling as js
from gpu_pathtracer_tpu.core import vecmath as jv
from gpu_pathtracer_tpu_torch.core import rng as trng
from gpu_pathtracer_tpu_torch.core import sampling as ts
from gpu_pathtracer_tpu_torch.core import vecmath as tv

ATOL = 1e-6
N = 4096


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(N, 3)).astype(np.float32)
    b = rng.normal(size=(N, 3)).astype(np.float32)
    n = b / np.linalg.norm(b, axis=1, keepdims=True)
    u1 = rng.random(N, dtype=np.float32)
    u2 = rng.random(N, dtype=np.float32)
    eta_i = rng.uniform(1.0, 1.2, N).astype(np.float32)
    eta_t = rng.uniform(1.3, 1.8, N).astype(np.float32)
    return dict(a=a, b=b, n=n.astype(np.float32), u1=u1, u2=u2,
                ei=eta_i, et=eta_t)


def _close(t, j, atol=ATOL):
    if isinstance(t, tuple):
        for x, y in zip(t, j):
            _close(x, y, atol)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol,
                               rtol=1e-5)


VEC_CASES = {
    "dot": (lambda m, d: m.dot(d["a"], d["b"]), ATOL),
    "cross": (lambda m, d: m.cross(d["a"], d["b"]), ATOL),
    "length": (lambda m, d: m.length(d["a"]), ATOL),
    "normalize": (lambda m, d: m.normalize(d["a"]), ATOL),
    "luminance": (lambda m, d: m.luminance(d["a"]), ATOL),
    "reflect": (lambda m, d: m.reflect(d["a"], d["n"]), ATOL),
    "refract": (lambda m, d: m.refract(d["a"], d["n"], d["ei"], d["et"]),
                ATOL),
    "make_coordinate": (lambda m, d: m.make_coordinate(d["n"]), ATOL),
    "to_world": (lambda m, d: m.to_world(d["a"], d["n"], d["b"], d["a"]),
                 ATOL),
    "is_black": (lambda m, d: m.is_black(d["a"]), 0),
    "same_hemisphere": (lambda m, d: m.same_hemisphere(d["a"], d["b"],
                                                       d["n"]), 0),
    "face_forward": (lambda m, d: m.face_forward(d["n"], d["a"]), 0),
}


@pytest.mark.parametrize("case", sorted(VEC_CASES))
def test_vecmath_matches_jax(case, data):
    fn, atol = VEC_CASES[case]
    t = fn(tv, {k: torch.as_tensor(v) for k, v in data.items()})
    j = fn(jv, {k: jnp.asarray(v) for k, v in data.items()})
    _close(t, j, atol)


SAMPLING_CASES = {
    "sincos_2pi": lambda m, d: m.sincos_2pi(d["u1"]),
    "cosine_hemisphere": lambda m, d: m.cosine_hemisphere(d["u1"], d["u2"]),
    "uniform_disk": lambda m, d: m.uniform_disk(d["u1"], d["u2"]),
    "uniform_triangle": lambda m, d: m.uniform_triangle(d["u1"], d["u2"]),
}


@pytest.mark.parametrize("case", sorted(SAMPLING_CASES))
def test_sampling_matches_jax(case, data):
    """atol 1e-6, plus the sine's conditioning: both packages take
    sin(2 pi u) as +-sqrt(1 - cos^2), which turns the frameworks' 1-ulp
    cosine differences (<= 1.2e-7) into up to 1.2e-7 |cos / sin|, so each
    lane is held to 1e-6 + 2.4e-7 |cos / sin| (two ulp)."""
    fn = SAMPLING_CASES[case]
    t = fn(ts, {k: torch.as_tensor(v) for k, v in data.items()})
    j = fn(js, {k: jnp.asarray(v) for k, v in data.items()})
    u = (data["u1"] if case == "sincos_2pi" else data["u2"]).astype(
        np.float64)
    cond = np.abs(np.cos(2 * np.pi * u) / np.sin(2 * np.pi * u))
    tol = ATOL + 2.4e-7 * cond
    for x, y in zip(t, j):
        x, y = x.numpy(), np.asarray(y)
        err = np.abs(x - y).reshape(len(u), -1).max(axis=1)
        assert np.all(err <= tol + 1e-5 * np.abs(y).reshape(len(u), -1)
                      .max(axis=1)), err.max()


def test_power_heuristic_matches_jax(data):
    f = data["u1"] * 3.0
    g = data["u2"] * np.where(data["u1"] < 0.1, 0.0, 2.0).astype(np.float32)
    f[:8] = 0.0
    g[:8] = 0.0
    _close(ts.power_heuristic(torch.as_tensor(f), torch.as_tensor(g)),
           js.power_heuristic(1, jnp.asarray(f), 1, jnp.asarray(g)))


# ---------------------------------------------------------------------------
# Philox4x32-10
# ---------------------------------------------------------------------------

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


KAT = [  # Random123 kat_vectors, philox4x32 10 rounds
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr, key, expect", KAT)
def test_philox_known_answers(ctr, key, expect):
    assert tuple(philox_ref(ctr, key)) == expect
    words = trng.philox4x32_10(*(torch.tensor([c], dtype=torch.int64)
                                 for c in ctr), *key)
    assert tuple(int(w[0]) for w in words) == expect


def test_philox_matches_reference():
    rng = np.random.default_rng(3)
    ctr = rng.integers(0, 1 << 32, size=(4, 256), dtype=np.int64)
    key = (int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32)))
    words = trng.philox4x32_10(*(torch.as_tensor(c) for c in ctr), *key)
    for i in range(ctr.shape[1]):
        ref = philox_ref([int(c[i]) for c in ctr], key)
        assert [int(w[i]) for w in words] == ref


def test_philox_stream_sites():
    """Site d of lane i is word d & 3 of philox((i, d >> 2, 0, 0),
    (seed, iteration)) >> 8, times 2^-24, read in draw order."""
    lanes = torch.tensor([0, 5, 1 << 20, (1 << 31) - 1])
    seed, it = 0xDEADBEEF, 17
    s = trng.PhiloxStream(seed, it, lanes, base=4, budget=8)
    draws = [s.uniform(), *s.uniform2(), *s.uniform3(), s.uniform()]
    for k, u in enumerate(draws):
        d = 4 + k
        for j, lane in enumerate(lanes.tolist()):
            w = philox_ref((lane, d >> 2, 0, 0), (seed, it))[d & 3]
            assert u[j].item() == (w >> 8) * 2.0 ** -24
    assert all(((u >= 0) & (u < 1)).all() for u in draws)
    s.uniform()   # site 11 is the last of the budget
    with pytest.raises(ValueError, match="budget"):
        s.uniform()


@pytest.mark.parametrize("n_rows", [7, 4 * trng.ROW_BLOCKS + 5])
def test_uniform_rows_are_the_stream_sites(n_rows):
    """uniform_rows' row d is PhiloxStream's site d of the same tag, also
    past the first ROW_BLOCKS counter blocks."""
    lanes = torch.tensor([0, 3, 1 << 20, (1 << 31) - 1])
    rows = trng.uniform_rows(77, 5, lanes, n_rows, trng.MLT_TAG)
    s = trng.PhiloxStream(77, 5, lanes, tag=trng.MLT_TAG)
    assert rows.shape == (n_rows, 4)
    assert torch.equal(rows, torch.stack([s.uniform() for _ in range(n_rows)]))


def test_primary_sample_stream_reads_rows():
    u = torch.rand(12, 5, generator=torch.Generator().manual_seed(0))
    s = trng.PrimarySampleStream(u, base=4, budget=8)
    assert torch.equal(s.uniform(), u[4])
    a, b = s.uniform2()
    assert torch.equal(a, u[5]) and torch.equal(b, u[6])
    lanes = torch.arange(5)
    assert isinstance(trng.lane_stream(1, 1, lanes, u, 0, 4),
                      trng.PrimarySampleStream)
    assert isinstance(trng.lane_stream(1, 1, lanes, None, 0, 4),
                      trng.PhiloxStream)
