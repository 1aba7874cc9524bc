"""Host seconds of the scene file's parse, its OBJ reads included: the
program's last "scene.parse" set-up span
(gpu_pathtracer_tpu_torch.telemetry). None where the program keeps no
spans."""


def read(s):
    try:
        from gpu_pathtracer_tpu_torch import telemetry
    except ImportError:
        return None
    parses = [x for x in telemetry.setup_spans() if x.name == "scene.parse"]
    return parses[-1].ns / 1e9 if parses else None
