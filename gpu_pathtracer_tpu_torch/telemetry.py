"""Spans and counters inside the port: where a spp's host time goes.

A span (`span(name, index)`, a context manager) is an interval on the
host clock (`time.perf_counter_ns`) with its name, its index (a bounce,
a step; None if it has none), the span that encloses it (`parent`) and
the iteration it belongs to. `iteration(n)`, which
`Renderer.render_iteration` enters, opens one `Record`: the spans and
counters of one spp, under a root span named "iteration", with the
process-wide id that all its spans carry as their `iteration`. The last
RING records stay in memory (`records()`). Spans opened outside any
iteration are set-up spans (the scene build's) and are kept apart, the
last SETUP_MAX of them (`setup_spans()`). `count(name, value)` adds a
host int, or a device tensor kept by reference and read only when a
reader asks (`Record.total`), to the open record; outside one it does
nothing. Nothing here launches a device op or waits on the device.

While torch's profiler runs (`torch.autograd.profiler.
_is_profiler_enabled`), each span also enters
`torch.profiler.record_function("<name>.<index>")`, so that it lands in
the profiler's Chrome trace as a `user_annotation` on the clock of the
device's events; a record opened then is marked `traced`. With no
profiler running a span costs two clock reads and two list appends.

Names (PERF.md section 3 gives the metric that reads each):
- "iteration", the root of a record;
- PT: "pt.camera" (the draws, the primary rays, their sort and the
  wave's start), "pt.fused" (the megakernel's launch); on the
  wavefront, per bounce b, "pt.hit", "pt.shade", "pt.shadow", "pt.sort";
- BDPT: "bdpt.start"; per step "bdpt.hit", "bdpt.step"; then
  "bdpt.connect", "bdpt.shadow", "bdpt.finish";
- "film.add": the renderer's accumulation;
- "sync.<what>": a call on the main path that makes the host wait on the
  device (`SYNC` prefix): "sync.overflow", the wait of the BVH8 walk's
  deferred overflow check (geom/packet_cuda.py);
- set-up: "scene.parse", "scene.flatten" (flatten_numpy, enclosing its
  "scene.bvh" spans: the binary BVH or the TLAS plan, and the BVH8
  table; with instancing, each holds a "scene.tlas" span: the TLAS plan
  with its BLAS builds, the instanced BVH8 table), "scene.upload".
Counters: "hit_lanes" (the lanes each closest- or any-hit call is
launched over), "rays" (the spp's device-side ray count); on an
instanced scene, per BVH8 walk call, "inst_entered" (the (ray, instance)
pairs whose world box the ray entered) and "blas_walks" (the BLAS walks
begun), device tensors kept by reference (geom/packet.py).

One recorder serves the process; spans are opened and closed by the
thread that renders. `reset()` empties it.
"""

from __future__ import annotations

import collections
import statistics
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

RING = 256
SETUP_MAX = 4096
SYNC = "sync."

_clock = time.perf_counter_ns


class SpanRecord(NamedTuple):
    """One closed span. `seq`: its position in its record (0, the root,
    opened first), or its serial number among the set-up spans; `parent`:
    the `seq` of the span that enclosed it (None at the top);
    `iteration`: its record's id (None for a set-up span). Times in ns
    of `time.perf_counter_ns`."""
    name: str
    index: object
    start: int
    end: int
    seq: int
    parent: object
    iteration: object

    @property
    def ns(self) -> int:
        return self.end - self.start


class Span:
    """The context manager that records one span: a slot in the open
    record (or a set-up serial number) when entered, the span's fields
    as a plain tuple, in `SpanRecord`'s order, when left (a tuple of
    numbers and strings costs less to make than a named one, and the
    collector leaves it alone)."""

    __slots__ = ("name", "index", "start", "seq", "parent", "rec", "_rf")

    def __init__(self, name: str, index=None):
        self.name = name
        self.index = index

    @property
    def label(self) -> str:
        """The profiler annotation's name: "<name>.<index>" or the name."""
        return self.name if self.index is None \
            else f"{self.name}.{self.index}"

    def __enter__(self):
        r = _R
        rec = self.rec = r.record
        stack = r.stack
        self.parent = stack[-1] if stack else None
        if rec is None:
            self.seq = r.setup_seq
            r.setup_seq += 1
        else:
            self.seq = len(rec.raw)
            rec.raw.append(None)
        stack.append(self.seq)
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.label)
            self._rf.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        r = _R
        stack = r.stack
        if stack:
            stack.pop()
        rec = self.rec
        if rec is None:
            r.setup.append((self.name, self.index, self.start, end,
                            self.seq, self.parent, None))
        else:
            rec.raw[self.seq] = (self.name, self.index, self.start, end,
                                 self.seq, self.parent, rec.iteration)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class Record:
    """The spans (`SpanRecord`s in the order they opened, `spans[0]` the
    root; None for one still open) and counters ({name: [values]}) of
    one spp: the renderer's spp number `n` (1-based), the process-wide
    id `iteration`, and whether a profiler was running when it opened
    (`traced`)."""

    __slots__ = ("iteration", "n", "traced", "raw", "counts")

    def __init__(self, iteration: int, n: int, traced: bool):
        self.iteration = iteration
        self.n = n
        self.traced = traced
        self.raw = []
        self.counts = {}

    @property
    def spans(self) -> list:
        return [None if t is None else SpanRecord._make(t)
                for t in self.raw]

    def total(self, name: str) -> int:
        """The sum of counter `name` (device tensors read here)."""
        return sum(int(v) for v in self.counts.get(name, ()))

    def ns_by_name(self) -> dict:
        """{span name: summed ns} over the record."""
        out = {}
        for s in self.spans:
            if s is not None:
                out[s.name] = out.get(s.name, 0) + s.ns
        return out

    def syncs(self) -> list:
        """The record's sync.* spans."""
        return [s for s in self.spans
                if s is not None and s.name.startswith(SYNC)]


class _Recorder:
    def __init__(self):
        self.ring = collections.deque(maxlen=RING)
        self.setup = collections.deque(maxlen=SETUP_MAX)
        self.record = None
        self.stack = []
        self.next_id = 0
        self.setup_seq = 0


_R = _Recorder()


def reset() -> None:
    """Forget every record and set-up span (an open iteration's too)."""
    global _R
    _R = _Recorder()


def span(name: str, index=None) -> Span:
    """A span named `name` (with a bounce's or step's `index`), to be
    entered with `with`."""
    return Span(name, index)


class iteration:
    """The record of one spp, numbered `n` by its renderer: `with
    iteration(n) as rec:` opens it and its root span; on exit it joins
    the ring. Inside an open record it is a plain "iteration" span."""

    __slots__ = ("n", "rec", "root")

    def __init__(self, n: int):
        self.n = n
        self.rec = None
        self.root = Span("iteration")

    def __enter__(self):
        r = _R
        if r.record is None:
            self.rec = r.record = Record(r.next_id, self.n,
                                         _profiler._is_profiler_enabled)
            r.next_id += 1
        self.root.__enter__()
        return self.rec

    def __exit__(self, *exc):
        self.root.__exit__(*exc)
        if self.rec is not None:
            _R.record = None
            _R.ring.append(self.rec)
        return False


def count(name: str, value) -> None:
    """Add `value` (a host int, or a device tensor, kept as it is) to
    counter `name` of the open record; nothing outside a record."""
    rec = _R.record
    if rec is not None:
        rec.counts.setdefault(name, []).append(value)


def records() -> list:
    """The ring's records, oldest first."""
    return list(_R.ring)


def setup_spans() -> list:
    """The set-up spans, in the order they opened."""
    return [SpanRecord._make(t) for t in sorted(_R.setup,
                                                 key=lambda t: t[4])]


def summary(recs: list) -> tuple:
    """({span name: median ms a spp}, median sync.* spans a spp) over
    `recs`; a name missing from a record counts 0 there."""
    if not recs:
        return {}, 0.0
    per = [r.ns_by_name() for r in recs]
    names = []
    for p in per:
        names += [k for k in p if k not in names]
    ms = {k: statistics.median(p.get(k, 0) for p in per) / 1e6
          for k in names}
    return ms, statistics.median(len(r.syncs()) for r in recs)
