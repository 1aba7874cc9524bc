"""Host ms a spp outside the host syncs, from the program's own spans
(gpu_pathtracer_tpu_torch.telemetry): the median, over the records of
the untraced window (no record opened under the profiler, no renderer's
first spp), of the "iteration" span less its sync.* spans. None where
the program keeps no spans."""

import statistics


def read(s):
    try:
        from gpu_pathtracer_tpu_torch import telemetry
    except ImportError:
        return None
    recs = [r for r in telemetry.records() if not r.traced and r.n > 1]
    if not recs:
        return None
    issue = []
    for r in recs:
        spans = r.spans
        syncs = sum(x.ns for x in spans if x.name.startswith("sync."))
        issue.append((spans[0].ns - syncs) / 1e6)
    return statistics.median(issue)
