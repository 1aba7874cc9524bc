"""The 95th percentile, over every frame of the window, of the device
time between consecutive frames' completions (CUDA events recorded
after each frame's calls, read after the window); linear interpolation
between order statistics."""


def read(s):
    x = sorted(s.get("frame_ms") or [])
    if not x:
        return None
    pos = 0.95 * (len(x) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(x) - 1)
    return x[lo] + (x[hi] - x[lo]) * (pos - lo)
