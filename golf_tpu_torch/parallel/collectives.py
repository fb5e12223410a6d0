"""Differentiable collectives over a ``torch.distributed`` process group.

The sharded ops of ``parallel.seqpar`` and the global batch statistics of
data parallelism differentiate through these, each a
``torch.autograd.Function``:

* ``psum`` / ``pmean``: the sum (mean) over the group; the backward is the
  sum of the cotangents, as in ``jax.lax.psum`` under ``shard_map``, so a
  loss that a psum makes the same on every rank is backpropagated as
  loss / n on each (every rank then holds its part of the gradient, and
  the parts sum to the whole);
* ``all_gather``: the tiled gather along a dimension; the backward is this
  rank's slot of the summed cotangents;
* ``shift``: every rank receives the tensor of the rank ``offset`` below it
  (zeros where there is none), ``jax.lax.ppermute``'s halo exchange; the
  backward shifts the cotangents the other way;
* ``mirror``: rank r receives rank n - 1 - r's tensor (``global_flip``'s
  shard order); it is its own backward.

All of them are built on ``all_reduce(SUM)`` alone: a gather or a
permutation is an all-reduce of a zero buffer in which each rank fills its
own slot. gloo carries CUDA tensors only through ``all_reduce`` and
``broadcast``, and ``torch.distributed.nn.functional.all_gather``'s backward
goes through ``all_to_all``, which gloo lacks; this way one card can host
several ranks over gloo, and several cards use NCCL, with the same code.

A collective must be called by every rank of its group in the same order,
and so must its backward: the callers keep the graphs of all ranks alike
(``torch.where`` on a rank's index, never a Python branch around a
collective). With ``group`` None and no process group initialised, each is
the identity of a group of one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def group_size(group=None) -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    if group_size(group) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _slots(x: torch.Tensor, slot: int, n: int) -> torch.Tensor:
    """A zero (n, *x.shape) buffer with x in ``slot``."""
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[slot] = x
    return buf


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n, r = group_size(group), group_rank(group)
        ctx.group, ctx.dim, ctx.n, ctx.r = group, dim, n, r
        buf = _all_reduce(_slots(x, r, n), group)
        return torch.cat(list(buf.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        pieces = torch.stack(torch.chunk(g, ctx.n, dim=ctx.dim))
        return _all_reduce(pieces, ctx.group)[ctx.r], None, None


def _permute(x: torch.Tensor, group, src_of: int, dst_slot: int
             ) -> torch.Tensor:
    """Rank r's result: the tensor of rank ``src_of`` (zeros when out of
    range); this rank's own tensor goes to ``dst_slot``."""
    n = group_size(group)
    buf = _all_reduce(_slots(x, dst_slot, n), group)
    if 0 <= src_of < n:
        return buf[src_of]
    return torch.zeros_like(x)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        r = group_rank(group)
        ctx.group, ctx.offset = group, offset
        return _permute(x, group, r - offset, r)

    @staticmethod
    def backward(ctx, g):
        # rank r received from r - offset: its cotangent goes back there,
        # and this rank's input's cotangent comes from r + offset
        r = group_rank(ctx.group)
        return _permute(g, ctx.group, r + ctx.offset, r), None, None


class _Mirror(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n, r = group_size(group), group_rank(group)
        ctx.group = group
        return _permute(x, group, n - 1 - r, r)

    @staticmethod
    def backward(ctx, g):
        n, r = group_size(ctx.group), group_rank(ctx.group)
        return _permute(g, ctx.group, n - 1 - r, r), None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group, differentiable."""
    return _PSum.apply(x, group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    return psum(x, group) / group_size(group)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's x, concatenated in rank order along ``dim``."""
    return _AllGather.apply(x, group, dim)


def shift(x: torch.Tensor, group=None, offset: int = 1) -> torch.Tensor:
    """Rank r receives rank r - offset's x (zeros where that rank does not
    exist): offset 1 passes to the right neighbour, -1 to the left."""
    return _Shift.apply(x, group, offset)


def mirror(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank r receives rank n - 1 - r's x."""
    return _Mirror.apply(x, group)


@torch.no_grad()
def psum_all(tensors, group=None) -> list:
    """Each tensor summed over the group (no gradient), in one all-reduce of
    their concatenation: the gradients of a step, one round trip."""
    tensors = list(tensors)
    if group_size(group) == 1 or not tensors:
        return tensors
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [piece.view_as(t) for piece, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


@torch.no_grad()
def all_min_max(value: torch.Tensor, group=None) -> tuple:
    """(min, max) of a tensor over every rank of the group (no gradient)."""
    both = torch.stack([value.min(), value.max()])
    if group_size(group) == 1:
        return both[0], both[1]
    gathered = all_gather(both[None], group)
    return gathered[:, 0].min(), gathered[:, 1].max()


def barrier(group: Optional[object] = None) -> None:
    """A barrier built on an all-reduce (gloo's and NCCL's alike)."""
    if group_size(group) > 1:
        device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        _all_reduce(torch.zeros(1, device=device), group)
