"""Primary-sample-space Metropolis light transport (PSSMLT).

The port of gpu_pathtracer_tpu/integrators/mlt.py: Kelemen-style PSSMLT
(Kelemen et al. 2002) driving the path tracer's lane program. The
reference declares an empty Mlt kernel it never launches
(pathtracer.cu:1973-1983), so the JAX package's integrator is the one
the port follows.

W*H chains, one per lane. A chain's state is a column of the
primary-sample matrix u [D, N] (D = 2 pixel dims + PSS_CAM_DIMS +
PSS_BOUNCE_DIMS per bounce); its path f(u) is
`pt.render_lanes(..., psample=u[2:])`, which on a CUDA tensor of a
scene the megakernel covers is one K2 launch reading the matrix. One
iteration (`render_iteration`) is one mutation of every chain: a large
step (probability P_LARGE) draws u afresh, a small one moves every dim
by +-S2 exp(-log(S2 / S1) U), wrapped mod 1; acceptance a = min(1,
I' / I) on the path luminance; both states splat, weighted (1 - a) / I
and a / I' (one `index_add_` each into the [W*H, 3] film). The
normalisation b = E_uniform[I] accumulates over the large-step
proposals, so the image is absolute: W*H b film / (N steps).

The bootstrap resamples N uniform candidate paths in proportion to I
(systematic resampling over their cumulative luminance, in float64
here: float32 cumsums of the two packages associate differently, and
a chain at a boundary could take its neighbour), and the candidates are
the first b samples.

Random numbers (core/rng.py): tag MLT_TAG keyed by chain. The bootstrap
reads iteration 0: sites 0 .. D - 1 the candidate, D the resampling
offset. The step of iteration it reads site 0 (large step), 1
(acceptance), 4 + j, 4 + D + j and 4 + 2 D + j (fresh, magnitude and
sign of dim j). `draws=` replaces them with given matrices (the tests).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpu_pathtracer_tpu_torch.core.rng import (
    MLT_TAG, PSS_BOUNCE_DIMS, PSS_CAM_DIMS, uniform_rows,
)
from gpu_pathtracer_tpu_torch.core.vecmath import luminance
from gpu_pathtracer_tpu_torch.integrators import pt

P_LARGE = 0.3                        # large-step probability (plarge)
S1, S2 = 1.0 / 1024.0, 1.0 / 64.0    # small-step perturbation range


def n_dims(static) -> int:
    """Rows of the primary-sample matrix: 2 pixel dims + the path
    tracer's camera and bounce sites (core/rng.py)."""
    return 2 + PSS_CAM_DIMS + PSS_BOUNCE_DIMS * static.max_depth


def state_from_numpy(arrays: dict, device) -> dict:
    """The chain state on `device` from numpy fields (the JAX package's
    state dict; extra keys are ignored)."""
    names = ("u", "lum", "li", "px", "py", "film", "b_sum", "b_cnt",
             "steps")
    return {k: torch.as_tensor(np.array(arrays[k]), dtype=torch.int32
                               if k in ("px", "py") else torch.float32,
                               device=device) for k in names}


def pixel_of(static, u):
    """The pixel (px, py) of each chain's sample u [D, N]."""
    w, h = static.width, static.height
    return (torch.clamp((u[0] * w).to(torch.int32), 0, w - 1),
            torch.clamp((u[1] * h).to(torch.int32), 0, h - 1))


def evaluate(scene, static, seed: int, iteration: int, u, plain=False):
    """f(u) of every chain: (radiance [N, 3], luminance [N], px, py,
    rays traced: 0-d int64). `plain` runs the plain wavefront."""
    px, py = pixel_of(static, u)
    if plain:
        li, rays = pt.wavefront(scene, static, seed, iteration, px, py, True,
                                u[2:], plain=True)
    else:
        li, rays = pt.render_lanes(scene, static, seed, iteration, px, py,
                                   True, u[2:])
    return li, torch.clamp_min(luminance(li), 0.0), px, py, rays


def candidates(scene, static, seed: int, n_chains: int, plain=False,
               draws=None, chain_ids=None):
    """The bootstrap's uniform candidate paths: (u [D, N], radiance,
    luminance, px, py, rays, resampling offsets [N]) of chains
    `chain_ids` (default 0 .. n_chains - 1). `draws` = (u, offsets)
    replaces the Philox draws."""
    d = n_dims(static)
    if draws is None:
        if chain_ids is None:
            chain_ids = torch.arange(n_chains, device=scene.device)
        rows = uniform_rows(seed, 0, chain_ids, d + 1, MLT_TAG, plain)
        draws = (rows[:d], rows[d])
    u, u_r = draws
    return (u, *evaluate(scene, static, seed, 0, u, plain), u_r)


def resample(static, cands, shard=None, seed: int = 0,
             n_chains: int = 0) -> dict:
    """The chain state from the candidates: each chain's start taken in
    proportion to I by systematic resampling (stratified positions over
    the float64 cumulative luminance).

    On a rank of a sharded render (`shard`, parallel/dist.py), `cands`
    are the rank's share of the n_chains: the cdf runs over every
    candidate's luminance (gathered), a chosen candidate's radiance is
    gathered and its u drawn again from Philox by its index (stream
    `seed`), so the chains equal one rank's. b_sum and b_cnt are the
    rank's share."""
    u, li, lum, px, py, _, u_r = cands
    joined = shard is not None and shard.joined
    chain_ids = torch.arange(lum.shape[0], device=lum.device)
    lum_all, li_all = lum, li
    if joined:
        chain_ids = shard.ids(n_chains, lum.device)
        lum_all = shard.gather(lum, n_chains)
        li_all = shard.gather(li, n_chains)
    n = lum_all.shape[0]
    cdf = torch.cumsum(lum_all.double(), 0)
    pos = (chain_ids.double() + u_r.double()) * (cdf[-1] / n)
    idx = torch.clamp(torch.searchsorted(cdf, pos), 0, n - 1)
    if joined:
        u = uniform_rows(seed, 0, idx, u.shape[0], MLT_TAG)
        px, py = pixel_of(static, u)
    else:
        u, px, py = u[:, idx], px[idx], py[idx]
    f32 = dict(dtype=torch.float32, device=lum.device)
    return dict(
        u=u, lum=lum_all[idx], li=li_all[idx], px=px, py=py,
        film=torch.zeros((static.width * static.height, 3), **f32),
        b_sum=lum.sum(), b_cnt=torch.tensor(float(lum.shape[0]), **f32),
        steps=torch.zeros((), **f32))


def bootstrap(scene, static, seed: int, n_chains: int, draws=None,
              shard=None):
    """The initial chain state (`candidates` then `resample`) and the
    rays the candidates traced; with `shard`, of the rank's chains."""
    ids = None if shard is None else shard.ids(n_chains, scene.device)
    cands = candidates(scene, static, seed, n_chains, draws=draws,
                       chain_ids=ids)
    return resample(static, cands, shard, seed, n_chains), cands[5]


def mutation_draws(seed: int, iteration: int, n: int, d: int, device,
                   chain_ids=None, plain: bool = False):
    """The Philox draws of one mutation step of chains `chain_ids`
    (default 0 .. n - 1): (large-step U [N], acceptance U [N], fresh
    [D, N], magnitude U [D, N], sign U [D, N]); one launch of csrc/rng.cu
    on the card unless `plain`."""
    if chain_ids is None:
        chain_ids = torch.arange(n, device=device)
    rows = uniform_rows(seed, iteration, chain_ids, 4 + 3 * d, MLT_TAG,
                        plain)
    return (rows[0], rows[1], rows[4:4 + d], rows[4 + d:4 + 2 * d],
            rows[4 + 2 * d:4 + 3 * d])


def render_iteration(scene, static, seed: int, iteration: int, state: dict,
                     with_stats: bool = False, plain: bool = False,
                     draws=None, shard=None):
    """One Metropolis mutation of every chain. Returns (state, absolute
    image [W*H, 3]) and, with_stats, the rays of the proposal's path.

    On a rank of a sharded render (`shard`, parallel/dist.py; W*H chains
    in all), `state` holds the rank's chains, its share of the film and
    of b_sum and b_cnt; the image is made from their sums over the
    ranks, and the rays are the rank's own."""
    n_pix = static.width * static.height
    u = state["u"]
    d, n = u.shape
    chain_ids = None
    if shard is not None and shard.joined:
        chain_ids = shard.ids(n_pix, u.device)
    if draws is None:
        draws = mutation_draws(seed, iteration, n, d, u.device, chain_ids,
                               plain)
    u_sel, u_acc, fresh, u_mag, u_sign = draws

    # ---- the Kelemen proposal ----------------------------------------
    large = u_sel < P_LARGE
    r_mag = S2 * torch.exp(-math.log(S2 / S1) * u_mag)
    sign = torch.where(u_sign < 0.5, 1.0, -1.0)
    u_prop = torch.where(large[None, :], fresh, (u + sign * r_mag) % 1.0)

    # ---- f(u') and the acceptance ------------------------------------
    li2, i2, px2, py2, rays = evaluate(scene, static, seed, iteration,
                                       u_prop, plain)
    i1 = state["lum"]
    a = torch.where(i1 > 0.0,
                    torch.clamp_max(i2 / torch.clamp_min(i1, 1e-30), 1.0),
                    (i2 > 0.0).float())

    # ---- Kelemen's splat of both samples -----------------------------
    w_cur = torch.where(i1 > 0.0, (1.0 - a) / torch.clamp_min(i1, 1e-30),
                        0.0)
    w_prop = torch.where(i2 > 0.0, a / torch.clamp_min(i2, 1e-30), 0.0)
    width = static.width
    film = state["film"].index_add(
        0, (state["px"] + state["py"] * width).long(),
        state["li"] * w_cur[:, None])
    film.index_add_(0, (px2 + py2 * width).long(), li2 * w_prop[:, None])

    acc = u_acc < a
    b_sum = state["b_sum"] + torch.where(large, i2, 0.0).sum()
    b_cnt = state["b_cnt"] + large.sum().float()
    steps = state["steps"] + 1.0
    state = dict(
        u=torch.where(acc[None, :], u_prop, u),
        lum=torch.where(acc, i2, i1),
        li=torch.where(acc[:, None], li2, state["li"]),
        px=torch.where(acc, px2, state["px"]),
        py=torch.where(acc, py2, state["py"]),
        film=film, b_sum=b_sum, b_cnt=b_cnt, steps=steps)

    if chain_ids is not None:
        n = n_pix
        flat = shard.reduce(torch.cat([film.reshape(-1), b_sum[None],
                                       b_cnt[None]]))
        film, b_sum, b_cnt = flat[:-2].reshape(film.shape), flat[-2], \
            flat[-1]
    b = b_sum / torch.clamp_min(b_cnt, 1.0)
    image = film * (n_pix * b / (n * torch.clamp_min(steps, 1.0)))
    if with_stats:
        return state, image, rays
    return state, image
