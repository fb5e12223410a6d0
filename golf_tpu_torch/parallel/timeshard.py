"""The time-sharded all-pole filter as one op on global tensors
(counterpart of ``golf_tpu.parallel.timeshard``).

Every rank of the mesh's time group passes the same global x (B, T) and a
(B, T, p); each filters its window with ``seqpar.allpole_sharded`` (the
affine summaries of the windows, one all-gather, each window's incoming
state, then B4 from it on the card) and every rank gets the whole y back.
Its gradient is the unsharded filter's: the window's slice passes the
cotangent's gathered windows back, and the final gather takes this rank's
window of the (replicated) cotangent, so a loss computed the same on every
rank backpropagates as it would on one device. T must be a multiple of the
time ranks.
"""

from __future__ import annotations

import torch

from . import collectives
from .mesh import Mesh
from .seqpar import SeqParEnv, allpole_sharded


class _Scatter(torch.autograd.Function):
    """Replicated (B, T, ...) -> this rank's window; the backward gathers
    the windows' cotangents (replicated again)."""

    @staticmethod
    def forward(ctx, x, group, n, k):
        ctx.group = group
        tl = x.shape[1] // n
        return x[:, k * tl:(k + 1) * tl].contiguous()

    @staticmethod
    def backward(ctx, g):
        return collectives.all_gather(g, ctx.group, dim=1), None, None, None


class _Gather(torch.autograd.Function):
    """This rank's window -> the replicated (B, T, ...); the backward takes
    this rank's window of the replicated cotangent."""

    @staticmethod
    def forward(ctx, x, group, k):
        ctx.k, ctx.tl = k, x.shape[1]
        return collectives.all_gather(x, group, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.k * ctx.tl:(ctx.k + 1) * ctx.tl], None, None


def allpole_timesharded(x: torch.Tensor, a: torch.Tensor, mesh: Mesh
                        ) -> torch.Tensor:
    """Differentiable time-sharded all-pole filter of global x (B, T) and
    a (B, T, p) over the mesh's time group; returns the global y."""
    n, k = mesh.n_time, mesh.time_index
    if x.shape[1] % n:
        raise ValueError(f"T={x.shape[1]} is not a multiple of {n} ranks")
    env = SeqParEnv(n_time=n, t_global=x.shape[1], b_global=x.shape[0],
                    time_index=k, time_group=mesh.time_group)
    y = allpole_sharded(_Scatter.apply(x, mesh.time_group, n, k),
                        _Scatter.apply(a, mesh.time_group, n, k), env)
    return _Gather.apply(y, mesh.time_group, k)
