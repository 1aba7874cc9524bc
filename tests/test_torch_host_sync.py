"""The host's waits on the card inside a spp (PERF.md section 3, "run/
renderer: host syncs").

A spp of the port makes the host wait on the card at one place only:
the BVH8 walk's overflow check (geom/packet_cuda.check_overflow), which
on a card waits for the previous spp's copy of the flag while this
spp's work stays queued. Everything else reaches the card without a
copy from pageable host memory: `f32n` makes a number's [n] tensor with
one fill launch, `pt_shade.start` repeats a template record kept on the
device and writes the wave's first count with a fill.

On the CPU these tests hold `f32n` and `start` bit for bit to the
constructions they replace (written out here), and the deferred check's
contract: after a spp whose walk set the flag, the renderer raises with
the stack depth at the next spp's check or at the next film read. The
`card` tests run two spp of a knot through the BVH8 walk, the knot in
its own (K3) regime, the 1M-prim forest through the instanced walk and
cornell BDPT under
`torch.cuda.set_sync_debug_mode("error")` (the deferred wait aside), and
the deferred raise on the card. They import no JAX; on a machine with a
card, run them without the suite's conftest.py, which imports JAX:

    python -m pytest --noconftest tests/test_torch_host_sync.py -m card -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp
from gpu_pathtracer_tpu_torch import telemetry
from gpu_pathtracer_tpu_torch.geom import packet, packet_cuda, traverse
from gpu_pathtracer_tpu_torch.geom.dense import f32n
from gpu_pathtracer_tpu_torch.integrators import pt_shade
from gpu_pathtracer_tpu_torch.run.renderer import Renderer
from gpu_pathtracer_tpu_torch.scene.model import IntegratorType
from gpu_pathtracer_tpu_torch.scene.parse import load_scene


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


@pytest.fixture
def fresh_flags(monkeypatch):
    """A flag table of the test's own, and an empty telemetry ring."""
    monkeypatch.setattr(packet_cuda, "_OVERFLOW", {})
    telemetry.reset()
    yield
    telemetry.reset()


def _bits(t):
    return t.contiguous().view(torch.int32)


# the scenes' epsilon as the DeviceScene holds it (float32's 1e-3), 0,
# inf, and numbers that float32 rounds (0.1, 1 / 3, 1e-4)
@pytest.mark.parametrize("x", [float(np.float32(1e-3)), 1e-3, 0, 0.0,
                               float("inf"), 0.1, 1 / 3, 1e-4])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_f32n_number_is_the_old_copy_bit_for_bit(x, n):
    old = torch.as_tensor(x, dtype=torch.float32).expand(n).contiguous()
    got = f32n(x, n, "cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert torch.equal(_bits(got), _bits(old))


def test_f32n_tensor_keeps_its_path():
    t = torch.tensor([0.5, 0.25, 0.125], dtype=torch.float64)
    got = f32n(t, 3, "cpu")
    assert got.dtype == torch.float32
    assert torch.equal(got, t.float())
    one = f32n(torch.tensor(2.0), 4, "cpu")
    assert torch.equal(one, torch.full((4,), 2.0))


def _old_start_records(lanes, slot, n, sort, max_depth):
    """The records and counts as `start` built them with a host-side
    template (`torch.tensor`) and `counts[0, 0] = n`."""
    n_pad = -(-max(n, 1) // 4) * 4
    one = int(np.float32(1.0).view(np.int32))
    row = torch.tensor([0, 0, 0, one, one, one, one, pt_shade.ALIVE, 0, 0,
                        0, 0, 0, 0, 0, 0], dtype=torch.int32)
    rec = row.repeat(n_pad, 1)
    rec[:n, pt_shade.LANE] = lanes.to(torch.int32)
    rec[:n, pt_shade.SLOT] = slot.to(torch.int32)
    rec[n:, pt_shade.FLAGS] = 0
    counts = None
    if sort:
        counts = torch.zeros((max_depth + 2, 2), dtype=torch.int32)
        counts[0, 0] = n
    return rec, counts


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("n", [5, 8, 13])
def test_start_records_are_the_old_ones(sort, n):
    """The template kept on the device gives the records and counts the
    host-side template gave, every word; a second wave gets the same
    (the kept template is not written)."""
    g = torch.Generator().manual_seed(n)
    lanes = torch.randperm(4 * n, generator=g)[:n].to(torch.int32)
    slot = torch.randperm(n, generator=g).to(torch.int64)
    ro = torch.rand((n, 3), generator=g)
    rd = torch.rand((n, 3), generator=g)
    rec, counts = _old_start_records(lanes, slot, n, sort, max_depth=5)
    for _ in range(2):
        w = pt_shade.start(None, lanes, slot, ro, rd, sort, True, 5)
        assert torch.equal(_bits(w.rec), rec)
        if sort:
            assert w.counts.dtype == torch.int32
            assert torch.equal(w.counts, counts)
        else:
            assert w.counts is None


def _walk_renderer(flag_in: set, monkeypatch):
    """A CPU renderer of cornell_port at 8^2 whose hit queries take the
    BVH8 walk; each walk notes its stack on the overflow flag, and sets
    the flag during the spp numbered in `flag_in`, as the kernel does."""
    monkeypatch.setattr(traverse, "regime", lambda static: "bvh8")
    real = packet._plain

    def plain(scene, static, ro, rd, tmin, tmax, any_hit):
        out = real(scene, static, ro, rd, tmin, tmax, any_hit)
        flag = packet_cuda.overflow_flag(ro.device, static.bvh8_stack)
        if r.iteration in flag_in:
            flag.fill_(1)
        return out

    monkeypatch.setattr(packet, "_plain", plain)
    host = load_scene(str(tp.PORT_SCENES["cornell"]))
    host.width = host.height = 8
    r = Renderer(host, device="cpu", cache=False)
    return r


@pytest.mark.parametrize("read", ["next_spp", "film", "image", "radiance"])
def test_deferred_overflow_raises_by_the_next_spp_or_film_read(
        read, monkeypatch, fresh_flags):
    """Reads deferred as on a card: a spp whose walk set the flag ends
    without a word, and the next spp's check or the next film read
    raises with the stack depth; the flag is cleared behind each copy,
    so the spp after that, and the film, read clean. The deferred check
    waits once a spp from the second on (one sync.overflow span)."""
    monkeypatch.setattr(packet_cuda, "_deferred", lambda device: True)
    r = _walk_renderer({2}, monkeypatch)
    depth = r.static.bvh8_stack
    r.render_iteration()
    r.render_iteration()            # its walks overflowed: no word yet
    with pytest.raises(RuntimeError, match=f"passed {depth} entries"):
        if read == "next_spp":
            r.render_iteration()
        else:
            getattr(r, read)()
    r.render_iteration()
    assert np.isfinite(r.image()).all()
    recs = telemetry.records()
    assert [len(x.syncs()) for x in recs[:2]] == [0, 1]


def test_deferred_overflow_in_the_last_spp_raises_at_the_film_read(
        monkeypatch, fresh_flags):
    """The spp whose walk set the flag is the last: no later spp checks
    it, and `render`'s image raises."""
    monkeypatch.setattr(packet_cuda, "_deferred", lambda device: True)
    r = _walk_renderer({3}, monkeypatch)
    with pytest.raises(RuntimeError, match="stack passed"):
        r.render(3)


def test_deferred_check_raises_on_the_previous_snapshot(fresh_flags,
                                                        monkeypatch):
    """check_overflow on a deferred device: a set flag raises one check
    later (the depth of the launches before its copy), settle_overflow
    at once; a flag set after a check's copy is the next snapshot's."""
    monkeypatch.setattr(packet_cuda, "_deferred", lambda device: True)
    flag = packet_cuda.overflow_flag("cpu", 9)
    flag.fill_(1)
    packet_cuda.check_overflow("cpu")
    packet_cuda.overflow_flag("cpu", 3)
    with pytest.raises(RuntimeError, match="passed 9 entries"):
        packet_cuda.check_overflow("cpu")
    packet_cuda.check_overflow("cpu")   # the copy of a clean flag
    packet_cuda.overflow_flag("cpu", 5).fill_(1)
    with pytest.raises(RuntimeError, match="passed 5 entries"):
        packet_cuda.settle_overflow("cpu")
    packet_cuda.settle_overflow("cpu")
    packet_cuda.check_overflow()
    assert int(flag) == 0


def _no_sync_spp(r, monkeypatch):
    """Two spp of `r` after a warm-up one, under the sync debug mode
    "error" but for the deferred overflow wait; their telemetry
    records."""
    real = packet_cuda._wait

    def wait(snap):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real(snap)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(packet_cuda, "_wait", wait)
    r.render_iteration()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r.render_iteration()
        r.render_iteration()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    img = r.image()
    assert np.isfinite(img).all() and img.sum() > 0
    return telemetry.records()[-2:]


@pytest.mark.card
@pytest.mark.parametrize("route", ["bvh8", "blocked"])
def test_knot_spp_makes_no_sync(route, card, tmp_path, monkeypatch,
                                fresh_flags):
    """A knot of 2,000 triangles, PT on the sorted wavefront, through K4
    (the regime forced, as the 100k knot takes it) or its own K3: no
    sync in two spp but the deferred overflow wait, once a spp on K4."""
    if route == "bvh8":
        monkeypatch.setattr(traverse, "regime", lambda static: "bvh8")
    r = Renderer(str(tp.write_knot_scene(tmp_path)), device=card,
                 cache=False)
    recs = _no_sync_spp(r, monkeypatch)
    want = ["sync.overflow"] if route == "bvh8" else []
    assert [[s.name for s in x.syncs()] for x in recs] == [want, want]


@pytest.mark.card
def test_forest_spp_makes_no_sync(card, monkeypatch, fresh_flags):
    """The 1,000,012-prim forest at 1024^2, instanced as on the card's
    main path: no sync in two spp but the deferred overflow wait, and
    each spp's K4 calls hand their walk counts to its record (read after
    the debug mode is off): each BLAS walk is of an entered instance."""
    r = Renderer(str(tp.REPO / "scenes" / "knot_port" / "forest.json"),
                 device=card, cache=False)
    assert traverse.regime(r.static) == "instanced"
    assert r.static.bvh8_n_inst == 11
    recs = _no_sync_spp(r, monkeypatch)
    assert [[s.name for s in x.syncs()] for x in recs] \
        == [["sync.overflow"]] * 2
    for x in recs:
        assert 0 < x.total("blas_walks") <= x.total("inst_entered")


@pytest.mark.card
def test_cornell_bdpt_spp_makes_no_sync(card, monkeypatch, fresh_flags):
    host = load_scene(str(tp.PORT_SCENES["cornell"]))
    host.width = host.height = 64
    r = Renderer(host, device=card, integrator=IntegratorType.BDPT,
                 cache=False)
    recs = _no_sync_spp(r, monkeypatch)
    assert [x.syncs() for x in recs] == [[], []]


@pytest.mark.card
@pytest.mark.parametrize("read", ["next_spp", "image"])
def test_card_overflow_raises_one_spp_late(read, card, tmp_path,
                                           monkeypatch, fresh_flags):
    """K4 with a 2-entry stack overflows in the first spp; its check does
    not wait on it, and the next spp or the image raises."""
    monkeypatch.setattr(traverse, "regime", lambda static: "bvh8")
    r = Renderer(str(tp.write_knot_scene(tmp_path)), device=card,
                 cache=False)
    r.static = dataclasses.replace(r.static, bvh8_stack=2)
    r.render_iteration()
    with pytest.raises(RuntimeError, match="passed 2 entries"):
        if read == "next_spp":
            r.render_iteration()
        else:
            r.image()
