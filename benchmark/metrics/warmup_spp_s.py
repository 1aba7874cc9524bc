"""Host seconds of the warm-up frame, synchronised."""


def read(s):
    return s.get("warmup_spp_s")
