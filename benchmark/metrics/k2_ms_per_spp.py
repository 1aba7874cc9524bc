"""Device ms a traced spp of the program's kernel `pt_fused_kernel` (CUPTI)."""


def read(s):
    k = (s.get("trace") or {}).get("kernels", {}).get("pt_fused_kernel")
    return k["ms_per_spp"] if k else None
