"""Philox4x32-10 (Salmon et al., SC'11), as the renderer keys its draws.

Site d of lane i at (seed, iteration) under stream `tag` is word d & 3
of philox4x32_10(counter=(i, d >> 2, tag, 0), key=(seed, iteration)),
shifted right by 8 and scaled by 2**-24. The key's second word is a
tensor here, one iteration a lane, so that draws of many iterations
come from one call. uint32 arithmetic is emulated in int64 with masks.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, x):
    lo16, hi16 = x * (m & 0xFFFF), x * (m >> 16)
    mid = lo16 + ((hi16 & 0xFFFF) << 16)
    return (hi16 >> 16) + (mid >> 32), mid & MASK32


def philox(c0, c1, c2, c3, k0, k1):
    """Ten rounds over int64 tensors of uint32 values; keys may be ints
    or tensors that broadcast against the counters."""
    k0, k1 = k0 & MASK32, k1 & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


class Stream:
    """The draws of one scope of a lane: site `base` onwards, in turn."""

    def __init__(self, seed: int, its, lanes, base: int, dtype, tag: int = 0):
        self.seed, self.its, self.tag, self.dtype = seed, its, tag, dtype
        self.lanes = lanes & MASK32
        self.site = base
        self.block, self.words = None, None

    def uniform(self):
        d = self.site
        self.site += 1
        if self.block != d >> 2:
            z = torch.zeros_like(self.lanes)
            self.words = philox(self.lanes, z + (d >> 2), z + self.tag, z,
                                self.seed, self.its)
            self.block = d >> 2
        u = (self.words[d & 3] >> 8).to(torch.float32) * (1.0 / (1 << 24))
        return u.to(self.dtype)
