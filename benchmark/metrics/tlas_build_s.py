"""Host seconds of the two-level build (the TLAS plan with its BLAS
builds, and the instanced BVH8 table): the program's "scene.tlas"
set-up spans (gpu_pathtracer_tpu_torch.telemetry), inside its
"scene.bvh" spans, opened after its last "scene.parse", summed. None
where the program keeps no such span."""


def read(s):
    try:
        from gpu_pathtracer_tpu_torch import telemetry
    except ImportError:
        return None
    spans = telemetry.setup_spans()
    parses = [x.seq for x in spans if x.name == "scene.parse"]
    tlas = [x.ns for x in spans
            if x.name == "scene.tlas" and parses and x.seq > parses[-1]]
    return sum(tlas) / 1e9 if tlas else None
