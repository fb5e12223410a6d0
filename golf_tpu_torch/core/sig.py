"""Sig: a tensor with a hop length (counterpart of ``golf_tpu.core.sig``).

Frame-rate controls (LPC coefficients, gains, FIR magnitudes) and
sample-rate signals mix freely: arithmetic between two signals first
linearly upsamples the coarser one to the finer hop (align-corners, to
``(n-1)*hop + 1`` points), truncates both to the shorter length, then
applies the op.

Layout: dim 0 is batch, dim 1 is time (frames or samples), trailing dims
are channels. A tensor with fewer than 2 dims has an "infinite" hop.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable, Tuple, Union

import torch

INF_HOP = 1 << 62

ArrayLike = Union[torch.Tensor, float, int]


def true_divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, on every device. On CUDA PyTorch computes
    ``tensor / python_number`` as a product with the number's rounded
    reciprocal (some results one ulp off the CPU's); a 0-dim divisor on
    the tensor's device makes it a true division, as the CPU's is."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def linear_upsample(x: torch.Tensor, factor: int, axis: int = -1
                    ) -> torch.Tensor:
    """Linear interpolation to ``(n-1)*factor + 1`` points (align_corners):
    output point ``i`` lands exactly on input coordinate ``i/factor``."""
    if factor == 1:
        return x
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    left = x[..., :-1]
    right = x[..., 1:]
    w = true_divide(torch.arange(factor, dtype=x.dtype, device=x.device),
                    factor)
    seg = left[..., None] * (1 - w) + right[..., None] * w
    out = seg.reshape(*x.shape[:-1], (n - 1) * factor)
    out = torch.cat([out, x[..., -1:]], dim=-1)
    return out.movedim(-1, axis)


@dataclasses.dataclass(frozen=True)
class Sig:
    """Tensor + hop length. Time axis is dim 1 (when ndim >= 2)."""

    data: torch.Tensor
    hop: int = 1

    def __post_init__(self):
        if not isinstance(self.data, torch.Tensor):
            object.__setattr__(self, "data", torch.as_tensor(self.data))
        if self.data.ndim < 2:
            object.__setattr__(self, "hop", INF_HOP)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def steps(self) -> int:
        return 1 if self.data.ndim < 2 else self.data.shape[1]

    def __len__(self) -> int:
        return self.data.shape[0]

    def new(self, data: ArrayLike) -> "Sig":
        return Sig(torch.as_tensor(data), self.hop)

    # ---- hop algebra -----------------------------------------------------
    def reduce_hop_length(self, factor: int | None = None) -> "Sig":
        """Linear-upsample the time axis by ``factor`` (default: to hop 1)."""
        if factor is None:
            factor = self.hop
        elif self.hop % factor or factor > self.hop:
            raise ValueError(f"cannot reduce hop {self.hop} by {factor}")
        if factor == 1 or self.ndim < 2:
            return self
        return Sig(linear_upsample(self.data, factor, axis=1),
                   self.hop // factor)

    def increase_hop_length(self, factor: int) -> "Sig":
        if factor == 1 or self.ndim < 2:
            return self
        return Sig(self.data[:, ::factor], self.hop * factor)

    def set_hop_length(self, hop: int) -> "Sig":
        if hop > self.hop:
            if hop % self.hop:
                raise ValueError(f"hop {hop} is not a multiple of {self.hop}")
            return self.increase_hop_length(hop // self.hop)
        if hop < self.hop:
            return self.reduce_hop_length(self.hop // hop)
        return self

    def truncate(self, steps: int) -> "Sig":
        if self.ndim < 2 or steps >= self.steps:
            return self
        return Sig(self.data[:, :steps], self.hop)

    # ---- broadcasting ----------------------------------------------------
    @staticmethod
    def broadcast(*sigs: "Sig") -> Tuple["Sig", ...]:
        """All to the smallest hop, truncated to the fewest steps, trailing
        dims padded to the largest ndim."""
        finite = [s.hop for s in sigs if s.hop != INF_HOP]
        if finite:
            min_hop = min(finite)
            if any(h % min_hop for h in finite):
                raise ValueError(f"hop lengths must divide each other: "
                                 f"{[s.hop for s in sigs]}")
            sigs = tuple(
                s.reduce_hop_length(s.hop // min_hop)
                if s.hop != INF_HOP and s.hop > min_hop else s
                for s in sigs)
        steps = [s.steps for s in sigs if s.ndim >= 2]
        if steps:
            sigs = tuple(s.truncate(min(steps)) for s in sigs)
        max_ndim = max(s.ndim for s in sigs)
        return tuple(
            Sig(s.data.reshape(s.shape + (1,) * (max_ndim - s.ndim)), s.hop)
            if s.ndim < max_ndim else s for s in sigs)

    def _binop(self, other: Any, op: Callable, reverse: bool = False
               ) -> "Sig":
        if isinstance(other, Sig):
            a, b = Sig.broadcast(self, other)
            hop = min(a.hop, b.hop)
            x, y = a.data, b.data
        else:
            hop = self.hop
            x, y = self.data, other
        if reverse:
            x, y = y, x
        return Sig(op(x, y), hop)

    def __add__(self, o): return self._binop(o, operator.add)
    def __radd__(self, o): return self._binop(o, operator.add, True)
    def __sub__(self, o): return self._binop(o, operator.sub)
    def __rsub__(self, o): return self._binop(o, operator.sub, True)
    def __mul__(self, o): return self._binop(o, operator.mul)
    def __rmul__(self, o): return self._binop(o, operator.mul, True)
    def __truediv__(self, o): return self._binop(o, operator.truediv)
    def __rtruediv__(self, o): return self._binop(o, operator.truediv, True)
    def __neg__(self): return Sig(-self.data, self.hop)
    def __gt__(self, o): return self._binop(o, operator.gt)
    def __ge__(self, o): return self._binop(o, operator.ge)
    def __lt__(self, o): return self._binop(o, operator.lt)
    def __le__(self, o): return self._binop(o, operator.le)

    def __getitem__(self, idx) -> "Sig":
        return Sig(self.data[idx], self.hop)

    def __repr__(self):
        return f"Sig(hop={self.hop}, {self.data!r})"


def bcast_len(n: int, sig: Sig) -> int:
    """Steps of a hop-1 signal of ``n`` steps after a hop-broadcast op with
    ``sig``: ``sig`` is upsampled to (steps - 1) hop + 1 when framed, and
    the shorter wins."""
    if sig.hop == 1:
        return min(n, sig.steps)
    return min(n, (sig.steps - 1) * sig.hop + 1)


def sig_where(cond: Union[Sig, torch.Tensor], a: Union[Sig, ArrayLike],
              b: Union[Sig, ArrayLike]) -> Union[Sig, torch.Tensor]:
    """torch.where with hop broadcasting."""
    parts = [p for p in (cond, a, b) if isinstance(p, Sig)]
    if not parts:
        return torch.where(cond, a, b)
    bc = iter(Sig.broadcast(*parts))
    hop = min(p.hop for p in parts)
    vals = [next(bc).data if isinstance(p, Sig) else p for p in (cond, a, b)]
    return Sig(torch.where(*vals), hop)
