"""Multi-GPU rendering over torch.distributed: one process per card.

The port of gpu_pathtracer_tpu/parallel/dist.py. The JAX package splits
the lane axis over a 1-D device mesh and lets GSPMD insert the
collectives; here every rank is a process that renders a contiguous
slice of the lanes (`lane_range`: the split that P("lanes") makes of a
`round_up`'d axis), and the ranks' results meet in `all_reduce`:
- `reduce_film` sums the ranks' films (the counterpart of `psum_film`
  and `constrain_replicated`);
- `gather_lanes` makes a lane-split tensor whole on every rank: each
  rank writes its slice into a zero-filled buffer and the buffers are
  summed as integers over the values' bits, so every value arrives bit
  for bit (a float sum would turn -0.0 into 0.0).

Only `all_reduce` is used: PyTorch's backend table lists it and
`broadcast` as the only collectives that take CUDA tensors on gloo as
well as on NCCL, so two gloo ranks can share one card (NCCL takes one
rank a device). The scene is not sent (the JAX package's `replicate` has no
counterpart): every rank flattens the same scene file with the same
numpy code, so the tables are equal.

Backends: NCCL for ranks on CUDA devices, gloo for CPU ranks (the
tests). `init` joins a group from torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or from an explicit
`init_method` such as a `file://` store.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as tdist

DEFAULT_TIMEOUT_S = 600


def init(backend: str, init_method: str = "env://", rank: int | None = None,
         world_size: int | None = None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple[int, int]:
    """Join the process group (rank and world size from torchrun's RANK
    and WORLD_SIZE unless given) and return (rank, world size). Raises
    when the group does not form."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    tdist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return tdist.get_rank(), tdist.get_world_size()


def local_rank() -> int:
    """The rank among this host's processes (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def lane_range(n: int, rank: int, world: int) -> tuple[int, int]:
    """Rank `rank`'s lanes [lo, hi) of n: the block P("lanes") gives it
    on the axis padded to round_up(n, world), cut at n."""
    per = round_up(n, world) // world
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


def reduce_film(x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's x (a new tensor; x is left as it is)."""
    out = x.clone()
    tdist.all_reduce(out)
    return out


def _bits(x: torch.Tensor) -> torch.Tensor:
    """x as integers over its bits (a view where the width allows)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    return x


def gather_lanes(part: torch.Tensor, lo: int, n: int,
                 dim: int = 0) -> torch.Tensor:
    """The whole tensor of n lanes along `dim` on every rank, from each
    rank's `part` (its lanes lo .. lo + len - 1), bit for bit."""
    shape = list(part.shape)
    shape[dim] = n
    full = torch.zeros(shape, dtype=part.dtype, device=part.device)
    full.narrow(dim, lo, part.shape[dim]).copy_(part)
    bits = _bits(full)
    tdist.all_reduce(bits)
    return bits.bool() if part.dtype == torch.bool else full


@dataclass(frozen=True)
class Shard:
    """A rank's place in a sharded render: what the renderer and the
    integrators that couple all lanes (SPPM, MLT) take to split and join
    their work. `joined` says a process group is there: without one
    (the default, a world of 1) every method gives back its input; with
    one, the collectives run, in a world of 1 too."""
    rank: int = 0
    world: int = 1
    joined: bool = False

    @classmethod
    def current(cls) -> "Shard":
        """This process's place in the initialised group (a world of 1,
        not joined, without one)."""
        if tdist.is_available() and tdist.is_initialized():
            return cls(tdist.get_rank(), tdist.get_world_size(), True)
        return cls()

    def range(self, n: int) -> tuple[int, int]:
        return lane_range(n, self.rank, self.world)

    def ids(self, n: int, device) -> torch.Tensor:
        """This rank's lane ids of n, int64."""
        lo, hi = self.range(n)
        return torch.arange(lo, hi, dtype=torch.int64, device=device)

    def gather(self, part: torch.Tensor, n: int, dim: int = 0):
        if not self.joined:
            return part
        return gather_lanes(part, self.range(n)[0], n, dim)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_film(x) if self.joined else x
