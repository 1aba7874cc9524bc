"""Counter-based random numbers that the CUDA kernels reproduce bit for bit.

The JAX package draws from threefry keys folded per draw site
(gpu_pathtracer_tpu/core/rng.py) and, inside its megakernel, from the
TPU's own generator; neither can be reproduced on a GPU. The port draws
every uniform from Philox4x32-10 (Salmon et al., SC'11), addressed like
the JAX package's primary-sample matrix `psample [4 + 8*depth, N]`
(rng.py:61-106): site d of lane i is

    u = (philox4x32_10(counter=(i, d >> 2, 0, 0),
                       key=(seed, iteration))[d & 3] >> 8) * 2**-24

Sites 0-3 are the camera (pixel jitter x, y, aperture u1, u2); site
4 + 8*b + k is bounce b's draw k (0 light pick, 1-2 light uv, 3-5 BSDF
u1 u2 u3, 6 Russian roulette). The lane id is the pixel index, so a
result does not depend on tiling, and csrc/pt_fused.cu computes the same
bits from the same formula. The uint32 arithmetic is emulated in int64
with masks, valid on either device.

`philox_uniform` hands out whole counter blocks as float rows: on CUDA
lanes it launches csrc/rng.cu (core/rng_cuda.py), one launch for all the
blocks of a call, bit-equal to its plain version `philox_uniform_torch`
(philox4x32_10 + bits_to_uniform, int64 elementwise ops); on CPU lanes,
or with `plain=True`, it runs the plain version. `uniform_rows` and
`PhiloxStream` draw through it and take `plain` from their callers, so
an integrator run with `plain=True` draws nothing through the kernel.

In general a counter is (i, block, tag, j): the path tracer's sites
above are tag = j = 0. The volumetric path tracer (integrators/vpt.py)
keeps sites 0-3 for the camera and gives step s of its loop the 16
sites 4 + 16*s + k (VPT_STEP_DIMS), of which it reads 13:

    k = 0        homogeneous distance sample u0      (VPT_MEDIUM)
    k = 1-3      medium NEE light pick, u, v         (VPT_SCATTER)
    k = 4-5      phase sample u1, u2
    k = 6-8      surface NEE light pick, u, v        (VPT_SURFACE)
    k = 9-11     BSDF u1, u2, u3
    k = 12       Russian roulette

Its tracking walks (shade/media.py, csrc/track.cu) draw from counters
(i, 0, tag, j) with tag = track_tag(step, call site, walk segment) >=
256, so they never meet a site above; j counts the walk's draws, and
each draw reads word 0 (the exponential step), word 1 (the acceptance)
and word 2 (the Russian roulette of ratio tracking).

Streams of their own, tags 1-15 (counters (i, d >> 2, tag, 0)): the
path tracer's subsurface hook at bounce b reads sites 16 b + k of tag
BSSRDF_TAG; BDPT's light subpath reads tag BDPT_LIGHT_TAG and its
connection rounds tag BDPT_CONNECT_TAG (integrators/bdpt.py). Light
tracing keys its tag-0 sites by the path index (integrators/lt.py).

The last three integrators:
- Instant radiosity (integrators/ir.py). Its camera pass reads the
  tag-0 pixel sites: 0-3 the camera, 4 + 8 b + k (k = 0-2) bounce b's
  BSDF sample. Its VPL light paths read tag IR_VPL_TAG, lane = path
  index 0 .. 31, keyed by the iteration that regenerates the set:
  sites 0-4 the emission (light pick, triangle u, v, direction u1, u2),
  IR_EMIT_DIMS + IR_BOUNCE_DIMS b + k bounce b's BSDF u1-u3 (k = 0-2)
  and Russian roulette (k = 3).
- SPPM (integrators/sppm.py). Its eye pass reads the tag-0 pixel sites:
  0-1 the pixel jitter (no aperture), 4 + SPPM_EYE_DIMS b + k bounce
  b's k = 0 light pick, 1-2 light u, v, 3-5 the BSDF sample of the MIS
  pair, 6-8 the BSDF sample of the walk. Its photons read tag
  SPPM_PHOTON_TAG, lane = photon index: sites 0-4 the emission,
  PHOTON_EMIT_DIMS + PHOTON_BOUNCE_DIMS b + k bounce b's k = 0 deposit
  rotation, 1-3 BSDF u1-u3, 4 Russian roulette.
- PSSMLT (integrators/mlt.py). Tag MLT_TAG, lane = chain index. The
  bootstrap (iteration 0) reads sites 0 .. D - 1 as its candidate u and
  site D as its resampling offset; the mutation step of iteration it
  reads site 0 (large step or not), 1 (acceptance), 4 + j (row j of
  the fresh sample), 4 + D + j (the perturbation's magnitude) and
  4 + 2 D + j (its sign), j < D. Its path evaluations read the chain's
  u, not Philox (`lane_stream` with a psample).
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.core import rng_cuda

PSS_CAM_DIMS = 4
PSS_BOUNCE_DIMS = 8

VPT_STEP_DIMS = 16   # sites per VPT step (13 read)
VPT_MEDIUM = 0       # step-site offsets of the three scopes of a VPT step
VPT_SCATTER = 1
VPT_SURFACE = 6

# call sites of the tracking walk, field 2 of track_tag
TRACK_SAMPLE = 0     # distance sampling (media.medium_sample)
TRACK_SCATTER = 1    # Tr walk of the medium NEE shadow ray
TRACK_SURFACE = 2    # Tr walk of the surface NEE shadow ray
TRACK_EMITTER = 3    # Tr of the segment to an emitter hit
TRACK_CAMERA = 4     # Tr of a connection to the camera (LT, BDPT s = 1)
TRACK_CONNECT = 5    # Tr of a BDPT connection (t = 1, general)
TRACK_LIGHT_PATH = 6  # distance sampling on BDPT's light subpath

# tags of the streams beside the tag-0 sites
BSSRDF_TAG = 1         # the path tracer's subsurface hook
BSSRDF_DIMS = 16       # its sites per bounce (9 read)
BDPT_LIGHT_TAG = 2     # BDPT's light subpath
BDPT_CONNECT_TAG = 3   # BDPT's connection rounds
IR_VPL_TAG = 4         # instant radiosity's VPL light paths
SPPM_PHOTON_TAG = 5    # SPPM's photon paths
MLT_TAG = 6            # PSSMLT's bootstrap and mutation draws

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def _mulhilo(m: int, x):
    """(hi, lo) 32-bit halves of m * x; m a uint32 constant, x an int64
    tensor holding uint32 values. 16-bit limbs keep every partial
    product below 2**49."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32 with 10 rounds. Counters: int64 tensors of uint32
    values (broadcastable); keys: Python ints. Returns 4 int64 tensors."""
    k0 &= MASK32
    k1 &= MASK32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def track_tag(step: int, site: int, segment: int = 0) -> int:
    """The tag of a tracking walk's counters: (step + 1, call site, walk
    segment) in bits 8+, 4-7 and 0-3; never 0, the path tracer's tag."""
    return ((step + 1) << 8) | (site << 4) | segment


def track_words(seed: int, iteration: int, lanes, tag, j):
    """Words 0-2 of draw j of the tracking walk of lanes `lanes` (int64
    tensors of uint32 values; the tag, an int or a tensor, and j
    broadcast against lanes)."""
    z = torch.zeros_like(lanes)
    w = philox4x32_10(lanes, z, z + tag, z + j, seed, iteration)
    return w[0], w[1], w[2]


def bits_to_uniform(w):
    """uint32 word -> U[0, 1) with 24 bits, exact in float32."""
    return (w >> 8).to(torch.float32) * (1.0 / (1 << 24))


ROW_BLOCKS = 8   # counter blocks (4 sites each) the plain version does at once


def philox_uniform_torch(lanes, block0: int, n_blocks: int, tag: int,
                         seed: int, iteration: int):
    """The plain version of csrc/rng.cu: rows 4 b + k (b < n_blocks) =
    site 4 (block0 + b) + k of stream `tag` for each lane of `lanes` (int64
    [N] of uint32 values), float32 [4 n_blocks, N], computed ROW_BLOCKS
    counter blocks at a time (which bounds the int64 temporaries at
    [ROW_BLOCKS, N])."""
    if lanes.is_cuda:
        rng_cuda.STATS.plain_cuda += 1
    lanes = lanes[None, :]
    out = torch.empty((4 * n_blocks, lanes.shape[1]), dtype=torch.float32,
                      device=lanes.device)
    z = torch.zeros_like(lanes)
    for b0 in range(0, n_blocks, ROW_BLOCKS):
        b1 = min(b0 + ROW_BLOCKS, n_blocks)
        blk = torch.arange(block0 + b0, block0 + b1, dtype=torch.int64,
                           device=lanes.device)[:, None]
        w = philox4x32_10(lanes, blk, z + tag, z, seed, iteration)
        for k in range(4):
            out[4 * b0 + k:4 * b1:4] = bits_to_uniform(w[k])
    return out


def philox_uniform(lanes, block0: int, n_blocks: int, tag: int, seed: int,
                   iteration: int, plain: bool = False):
    """Counter blocks block0 .. block0 + n_blocks - 1 of stream `tag` as
    float32 rows [4 n_blocks, N] (row 4 b + k: word k of block block0 +
    b). CUDA lanes launch csrc/rng.cu; CPU lanes, or `plain`, take
    `philox_uniform_torch`."""
    if plain or lanes.device.type != "cuda":
        return philox_uniform_torch(lanes, block0, n_blocks, tag, seed,
                                    iteration)
    return rng_cuda.philox_uniform_cuda(lanes, block0, n_blocks, tag, seed,
                                        iteration)


def uniform_rows(seed: int, iteration: int, lane_ids, n_rows: int, tag: int,
                 plain: bool = False):
    """Sites 0 .. n_rows - 1 of stream `tag` for every lane, as one
    [n_rows, N] float32 tensor: the draws PhiloxStream would hand out in
    turn, from one `philox_uniform` call."""
    lanes = lane_ids.to(torch.int64) & MASK32
    return philox_uniform(lanes, 0, (n_rows + 3) // 4, tag, seed, iteration,
                          plain)[:n_rows]


class PhiloxStream:
    """RngStream-compatible Philox reader: each draw reads the next site.

    `base` is the first site of this scope and `budget` bounds the sites
    it may consume, exactly like PrimarySampleStream; `tag` is field 2
    of the counter (0 for the sites above); `shape` arguments
    are accepted for interface parity and ignored (every draw is one
    value per lane). The four rows of a counter block are drawn at once
    (`philox_uniform`, `plain` as there).
    """

    def __init__(self, seed: int, iteration: int, lane_ids, base: int = 0,
                 budget: int | None = None, tag: int = 0,
                 plain: bool = False):
        self._key = (int(seed) & MASK32, int(iteration) & MASK32)
        self._tag = tag
        self._plain = plain
        self._lanes = lane_ids.to(torch.int64) & MASK32
        self._base = base
        self._budget = budget
        self._site = 0
        self._block = None
        self._rows = None

    def _row(self):
        if self._budget is not None and self._site >= self._budget:
            raise ValueError(
                f"random-site budget exceeded: {self._site + 1} > "
                f"{self._budget} (raise PSS_BOUNCE_DIMS)")
        d = self._base + self._site
        self._site += 1
        if self._block != d >> 2:
            self._rows = philox_uniform(self._lanes, d >> 2, 1, self._tag,
                                        *self._key, self._plain)
            self._block = d >> 2
        return self._rows[d & 3]

    def uniform(self, shape=()):
        return self._row()

    def uniform2(self, shape=()):
        return self._row(), self._row()

    def uniform3(self, shape=()):
        return self._row(), self._row(), self._row()


class PrimarySampleStream:
    """RngStream-compatible reader of an explicit primary-sample matrix
    `u [D, N]` (rng.py:70-106): each site reads the next row."""

    def __init__(self, u, base: int = 0, budget: int | None = None):
        self._u = u
        self._base = base
        self._budget = budget
        self._site = 0

    def _row(self):
        if self._budget is not None and self._site >= self._budget:
            raise ValueError(
                f"primary-sample budget exceeded: {self._site + 1} > "
                f"{self._budget} (raise PSS_BOUNCE_DIMS)")
        r = self._u[self._base + self._site]
        self._site += 1
        return r

    def uniform(self, shape=()):
        return self._row()

    def uniform2(self, shape=()):
        return self._row(), self._row()

    def uniform3(self, shape=()):
        return self._row(), self._row(), self._row()


def lane_stream(seed: int, iteration: int, lane_ids, psample, base: int,
                budget: int, tag: int = 0, plain: bool = False):
    """The stream for one scope (camera or one bounce): the psample rows
    when a matrix is given, else Philox at the same sites of `tag`
    (`plain` as in `philox_uniform`)."""
    if psample is not None:
        return PrimarySampleStream(psample, base, budget)
    return PhiloxStream(seed, iteration, lane_ids, base, budget, tag, plain)
