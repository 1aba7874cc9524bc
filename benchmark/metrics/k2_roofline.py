"""K2's share of its roofline, in %: the least time its traced spp's
rays take at the float32 peak, every ray against every triangle of the
scene (benchmark/peaks.py; the workload file's triangle count), over
K2's device time in those spp."""

from benchmark import peaks


def read(s):
    t = s.get("trace") or {}
    k = t.get("kernels", {}).get("pt_fused_kernel")
    if not k or k["ms_per_spp"] <= 0 or t.get("rays_per_spp", 0) <= 0:
        return None
    bound = peaks.dense_hit_seconds(t["rays_per_spp"],
                                    s["workload"]["counts"]["triangles"])
    return 100.0 * bound / (k["ms_per_spp"] / 1e3)
