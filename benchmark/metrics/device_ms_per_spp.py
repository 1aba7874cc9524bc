"""Device ms a spp: the union of the traced spp's kernel, copy and set
intervals (CUPTI)."""


def read(s):
    t = s.get("trace")
    return t["device_ms_per_spp"] if t and t["busy_s"] > 0 else None
