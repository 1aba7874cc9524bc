"""Device ms a spp of the ops that are no kernel of the program's csrc/:
PyTorch's elementwise work, sorts, gathers, cats, copies and sets."""


def read(s):
    t = s.get("trace")
    return t["glue_ms_per_spp"] if t and t["busy_s"] > 0 else None
