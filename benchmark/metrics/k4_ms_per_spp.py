"""Device ms a traced spp of the program's kernel
`bvh8_walk_kernel` (CUPTI)."""


def read(s):
    k = (s.get("trace") or {}).get("kernels", {}).get("bvh8_walk_kernel")
    return k["ms_per_spp"] if k else None
