"""Device ms a traced spp of the program's kernel `dense_kernel` (CUPTI)."""


def read(s):
    k = (s.get("trace") or {}).get("kernels", {}).get("dense_kernel")
    return k["ms_per_spp"] if k else None
