"""BLAS walks a ray begins in the instanced BVH8 walk, from the
program's own counters (gpu_pathtracer_tpu_torch.telemetry): the walks
the spp's K4 calls began ("blas_walks", counted on the device) over the
rays the spp traced ("rays"), summed over the records of the untraced
window (no record opened under the profiler, no renderer's first spp).
None where the program keeps no such counter or traced no ray."""


def read(s):
    try:
        from gpu_pathtracer_tpu_torch import telemetry
    except ImportError:
        return None
    recs = [r for r in telemetry.records() if not r.traced and r.n > 1]
    if not any("blas_walks" in r.counts for r in recs):
        return None
    rays = sum(r.total("rays") for r in recs)
    if rays <= 0:
        return None
    return sum(r.total("blas_walks") for r in recs) / rays
