"""Device ms a traced spp of the program's kernel
`bdpt_connect_kernel` (CUPTI)."""


def read(s):
    k = (s.get("trace") or {}).get("kernels", {}).get("bdpt_connect_kernel")
    return k["ms_per_spp"] if k else None
