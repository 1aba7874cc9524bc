"""Host ms a spp blocked in host syncs, from the program's own spans
(gpu_pathtracer_tpu_torch.telemetry): the median, over the records of
the untraced window (no record opened under the profiler, no renderer's
first spp), of the summed sync.* spans (0 in a record without one). None
where the program keeps no spans."""

import statistics


def read(s):
    try:
        from gpu_pathtracer_tpu_torch import telemetry
    except ImportError:
        return None
    recs = [r for r in telemetry.records() if not r.traced and r.n > 1]
    if not recs:
        return None
    return statistics.median(
        sum(x.ns for x in r.spans if x.name.startswith("sync.")) / 1e6
        for r in recs)
