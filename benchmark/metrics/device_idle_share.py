"""1 - the traced device ms a spp x the untraced spp/s of the same run,
unclamped: the share of the window the device waited on the host."""

from benchmark import trace


def read(s):
    t = s.get("trace")
    if not t or t["busy_s"] <= 0 or not s.get("window_s"):
        return None
    return trace.idle_share(t["device_ms_per_spp"],
                            s["spp"] / s["window_s"])[0]
