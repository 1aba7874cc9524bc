"""Host seconds of the BVH build (the binary BVH or the TLAS plan, and
the BVH8 table): the program's "scene.bvh" set-up spans
(gpu_pathtracer_tpu_torch.telemetry) opened after its last
"scene.parse", summed. None where the program keeps no spans."""


def read(s):
    try:
        from gpu_pathtracer_tpu_torch import telemetry
    except ImportError:
        return None
    spans = telemetry.setup_spans()
    parses = [x.seq for x in spans if x.name == "scene.parse"]
    bvh = [x.ns for x in spans
           if x.name == "scene.bvh" and parses and x.seq > parses[-1]]
    return sum(bvh) / 1e9 if bvh else None
