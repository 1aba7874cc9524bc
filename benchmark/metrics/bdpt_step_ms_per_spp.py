"""Device ms a traced spp of the program's kernel
`bdpt_step_kernel` (CUPTI)."""


def read(s):
    k = (s.get("trace") or {}).get("kernels", {}).get("bdpt_step_kernel")
    return k["ms_per_spp"] if k else None
