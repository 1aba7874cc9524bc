"""Seconds from the start of the process to the start of the window:
the kernels built or loaded, the scene built, the warm-up frame."""


def read(s):
    return s.get("setup_s")
