"""Rank meshes and the data-parallel context (counterpart of
``golf_tpu.parallel.mesh``).

``golf_tpu`` lays its devices out as a ``jax.sharding.Mesh`` with axes
``("data", "time")``; here the ranks of ``torch.distributed`` take the same
layout, ``np.arange(n).reshape(data, time)``, and every rank keeps the world
group, its data group (the ranks of its time index: they hold the other
rows of the batch) and its time group (the ranks of its data index: they
hold the other time windows of the same rows).

While a training step runs data-parallel it sets a ``DataShard``
(``data_parallel``); the modules that reduce over the batch read it
(``current_data``): the batch norms take their statistics over the data
group, the running min/max of the encoder and the masked f0 loss likewise,
and the random draws of a step (the noise, the unvoiced frames' f0) are made
over the global batch and sliced to this rank's rows (``rows_of``). The
step is then the single-device step on the global batch, as ``golf_tpu``'s
data-sharded ``jit`` computes it.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import collectives


@dataclasses.dataclass
class Mesh:
    """A (data x time) layout of ranks; ``ranks[d, t]`` is the global rank
    at data index d and time index t."""

    ranks: np.ndarray
    rank: int
    data_group: Any = None
    time_group: Any = None
    world_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.ranks.shape[0], "time": self.ranks.shape[1]}

    @property
    def n_data(self) -> int:
        return self.ranks.shape[0]

    @property
    def n_time(self) -> int:
        return self.ranks.shape[1]

    @property
    def member(self) -> bool:
        return self.rank < self.ranks.size

    @property
    def data_index(self) -> int:
        return int(np.argwhere(self.ranks == self.rank)[0][0])

    @property
    def time_index(self) -> int:
        return int(np.argwhere(self.ranks == self.rank)[0][1])

    @property
    def size(self) -> int:
        return self.ranks.size


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: Optional[int] = None, time: int = 1) -> Mesh:
    """The (data x time) mesh of the first data x time ranks of the
    initialised process group (one rank without one); a rank past them is
    left out (``Mesh.member`` false), as ``golf_tpu`` leaves out the devices
    past ``devices[:data]``. Every rank must call it: it creates each data
    and each time group, in the same order everywhere."""
    world, rank = _world()
    if data is None:
        data = world // time
    n = data * time
    if n > world or n < 1:
        raise ValueError(f"mesh {data} x {time} on {world} ranks")
    ranks = np.arange(n).reshape(data, time)
    mesh = Mesh(ranks, rank)
    if world == 1:
        return mesh
    mesh.world_group = dist.group.WORLD if n == world else \
        dist.new_group(list(range(n)))
    for d in range(data):
        g = dist.new_group(ranks[d].tolist())
        if rank in ranks[d]:
            mesh.time_group = g
    for t in range(time):
        g = dist.new_group(ranks[:, t].tolist())
        if rank in ranks[:, t]:
            mesh.data_group = g
    return mesh


def shard_batch(mesh: Mesh, *arrays) -> tuple:
    """This rank's rows of each global-batch array: the data index's share,
    the same on every time index."""
    return tuple(rows_of(a, mesh.data_index, mesh.n_data) for a in arrays)


def rows_of(a, index: int, parts: int):
    """Rows ``[index * B / parts, (index + 1) * B / parts)`` of ``a``."""
    b = a.shape[0]
    if b % parts:
        raise ValueError(f"batch {b} is not divisible by {parts} data ranks")
    step = b // parts
    return a[index * step:(index + 1) * step]


# ---------------------------------------------------------------------------
# the data-parallel context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DataShard:
    """This rank's share of a data-parallel step: ``index`` of ``size``
    equal row blocks, reduced over ``group``."""

    group: Any
    index: int
    size: int


_ACTIVE: List[DataShard] = []


def current_data() -> Optional[DataShard]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextmanager
def data_parallel(shard: Optional[DataShard]):
    """Run a block data-parallel over ``shard`` (a no-op for None or a
    shard of one)."""
    if shard is None or shard.size == 1:
        yield shard
        return
    _ACTIVE.append(shard)
    try:
        yield shard
    finally:
        _ACTIVE.pop()


def data_shard(mesh: Mesh) -> Optional[DataShard]:
    """The DataShard of a mesh's data axis, or None without one."""
    if mesh.n_data == 1:
        return None
    return DataShard(mesh.data_group, mesh.data_index, mesh.n_data)


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor],
              local_shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` over the global batch when a data shard is active,
    sliced to this rank's rows; ``draw(local_shape)`` otherwise. Every rank
    then draws the same global field from its generator."""
    shard = current_data()
    if shard is None:
        return draw(tuple(local_shape))
    full = draw((local_shape[0] * shard.size,) + tuple(local_shape[1:]))
    return rows_of(full, shard.index, shard.size)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """A sum over this rank's rows, summed over the data group when a data
    shard is active (differentiable)."""
    shard = current_data()
    return x if shard is None else collectives.psum(x, shard.group)


def train_batch_norm(norm: torch.nn.modules.batchnorm._BatchNorm,
                     x: torch.Tensor) -> torch.Tensor:
    """flax's ``BatchNorm`` in train mode for a torch batch norm ``norm``
    over x (B, C, ...): the batch statistics over every dim but 1 (over the
    data group's rows when a data shard is active: per-channel sums of x
    and of its centred squares and the count, through the differentiable
    ``psum``), the running variance following the biased variance, the
    same on every rank."""
    dims = (0,) + tuple(range(2, x.ndim))
    shard = current_data()
    if shard is None:
        with torch.no_grad():
            norm.running_mean.lerp_(x.mean(dim=dims), norm.momentum)
            norm.running_var.lerp_(x.var(dim=dims, unbiased=False),
                                   norm.momentum)
            norm.num_batches_tracked += 1
        return torch.nn.functional.batch_norm(
            x, None, None, norm.weight, norm.bias, True, 0.0, norm.eps)
    count = collectives.psum(
        torch.tensor(float(x.numel() // x.shape[1]), device=x.device),
        shard.group)
    mean = collectives.psum(x.sum(dim=dims), shard.group) / count
    shape = (1, -1) + (1,) * (x.ndim - 2)
    xc = x - mean.reshape(shape)
    var = collectives.psum((xc * xc).sum(dim=dims), shard.group) / count
    with torch.no_grad():
        norm.running_mean.lerp_(mean.detach(), norm.momentum)
        norm.running_var.lerp_(var.detach(), norm.momentum)
        norm.num_batches_tracked += 1
    y = xc * torch.rsqrt(var + norm.eps).reshape(shape)
    return y * norm.weight.reshape(shape) + norm.bias.reshape(shape)
