"""The share of the hit calls' lanes that carry a ray, from the
program's own counters (gpu_pathtracer_tpu_torch.telemetry): the rays
the spp traced ("rays", the program's device-side count) over the lanes
its closest- and any-hit calls were launched over ("hit_lanes"), summed
over the records of the untraced window (no record opened under the
profiler, no renderer's first spp). None where the program keeps no
counters or launched no hit call."""


def read(s):
    try:
        from gpu_pathtracer_tpu_torch import telemetry
    except ImportError:
        return None
    recs = [r for r in telemetry.records() if not r.traced and r.n > 1]
    lanes = sum(r.total("hit_lanes") for r in recs)
    if lanes <= 0:
        return None
    return sum(r.total("rays") for r in recs) / lanes
