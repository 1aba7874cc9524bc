"""spp/s: every spp the window completed over the window's seconds (host
clock, from before the first frame to after the final synchronise)."""


def read(s):
    return s["spp"] / s["window_s"] if s.get("window_s") else None
