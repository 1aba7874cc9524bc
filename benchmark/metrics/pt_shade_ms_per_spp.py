"""Device ms a traced spp of the program's kernel `pt_shade_kernel` (CUPTI)."""


def read(s):
    k = (s.get("trace") or {}).get("kernels", {}).get("pt_shade_kernel")
    return k["ms_per_spp"] if k else None
