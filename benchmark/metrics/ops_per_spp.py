"""Device ops a traced spp (kernels, copies, sets): the launch rate."""


def read(s):
    t = s.get("trace")
    return t["ops_per_spp"] if t and t["busy_s"] > 0 else None
