"""The share of the instances a ray enters that the instanced BVH8 walk
walks, from the program's own counters (gpu_pathtracer_tpu_torch.
telemetry): the BLAS walks begun ("blas_walks") over the (ray, instance)
pairs whose world box the first slab pass entered ("inst_entered"),
both counted on the device, summed over the records of the untraced
window (no record opened under the profiler, no renderer's first spp).
None where the program keeps no such counter or no ray entered an
instance."""


def read(s):
    try:
        from gpu_pathtracer_tpu_torch import telemetry
    except ImportError:
        return None
    recs = [r for r in telemetry.records() if not r.traced and r.n > 1]
    entered = sum(r.total("inst_entered") for r in recs)
    if entered <= 0:
        return None
    return sum(r.total("blas_walks") for r in recs) / entered
