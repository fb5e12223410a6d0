"""Multi-resolution STFT losses (counterpart of ``golf_tpu.loss.spec``).

SSSLoss: |STFT| L1 + alpha * log2-magnitude L1.
MSSLoss: the sum of SSSLoss over ``n_ffts`` at 75% overlap (the
Interspeech24 recipe uses the primes 509, 1021, 2053).
MSSLossV2: pluggable distance and compression.
The time-sharded branch of ``golf_tpu`` is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..core.sig import Sig
from ..ops import stft as stft_ops


def _as_tensor(x):
    return x.data if isinstance(x, Sig) else x


@dataclasses.dataclass(frozen=True)
class SSSLoss:
    """Single-scale spectral loss."""

    n_fft: int
    alpha: float = 1.0
    window: str = "hann"
    hop_length: Optional[int] = None
    center: bool = True
    eps: float = 1e-8

    def __call__(self, pred, target) -> torch.Tensor:
        hop = self.hop_length or self.n_fft // 4
        s_pred = stft_ops.spectrogram(_as_tensor(pred), self.n_fft, hop,
                                      window=self.window, power=1.0,
                                      center=self.center)
        s_true = stft_ops.spectrogram(_as_tensor(target), self.n_fft, hop,
                                      window=self.window, power=1.0,
                                      center=self.center)
        linear = torch.mean(torch.abs(s_pred - s_true))
        log = torch.mean(torch.abs(torch.log2(s_true + self.eps)
                                   - torch.log2(s_pred + self.eps)))
        return linear + self.alpha * log


@dataclasses.dataclass(frozen=True)
class MSSLoss:
    """Multi-scale spectral loss."""

    n_ffts: Sequence[int]
    alpha: float = 1.0
    ratio: float = 1.0
    overlap: float = 0.75
    window: str = "hann"
    center: bool = True

    def __call__(self, pred, target) -> torch.Tensor:
        total = 0.0
        for n_fft in self.n_ffts:
            hop = int(n_fft - n_fft * self.overlap)
            total = total + SSSLoss(
                n_fft=n_fft, alpha=self.alpha, window=self.window,
                hop_length=hop, center=self.center)(pred, target)
        return self.ratio * total


@dataclasses.dataclass(frozen=True)
class MSSLossV2:
    """Multi-scale spectral loss with a pluggable distance ('l1', 'l2')
    and compression ('log1p', 'log', 'id')."""

    n_ffts: Sequence[int]
    distance: str = "l1"
    compression: str = "log1p"
    window: str = "hann"
    overlap: float = 0.75
    ratio: float = 1.0

    def _compress(self, x):
        if self.compression == "log1p":
            return torch.log1p(x)
        if self.compression == "log":
            return torch.log(x + 1e-7)
        if self.compression == "id":
            return x
        raise ValueError(f"Unknown compression: {self.compression}")

    def _dist(self, a, b):
        if self.distance == "l1":
            return torch.mean(torch.abs(a - b))
        if self.distance == "l2":
            return torch.mean((a - b) ** 2)
        raise ValueError(f"Unknown distance: {self.distance}")

    def __call__(self, pred, target) -> torch.Tensor:
        total = 0.0
        for n_fft in self.n_ffts:
            hop = int(n_fft - n_fft * self.overlap)
            sp = stft_ops.spectrogram(_as_tensor(pred), n_fft, hop,
                                      window=self.window, power=1.0)
            st = stft_ops.spectrogram(_as_tensor(target), n_fft, hop,
                                      window=self.window, power=1.0)
            total = total + self._dist(self._compress(sp),
                                       self._compress(st))
        return self.ratio * total
