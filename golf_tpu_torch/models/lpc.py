"""Frame-wise LPC synthesis (counterpart of ``golf_tpu.models.lpc``).

Stateless windowed overlap-add synthesis from per-frame LPC (or biquad
cascade) coefficients: the excitation is cut into overlapping windows, each
window runs through a constant-coefficient all-pole filter, batched over
B x frames rows (``allpole_const``, B2 on the card), and the windows are
overlap-added and normalised by the overlap-added window.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.allpole import allpole_const, lpc_synthesis
from ..ops.dsp import get_window_fn, unfold
from .filters import _overlap_add

__all__ = ["LPCSynth", "BatchLPCSynth", "BatchSecondOrderLPCSynth"]


class LPCSynth(nn.Module):
    """Single-sequence frame-wise LPC synthesis: ex (T,), lpc (F, 1 + order)
    with the gain in column 0 -> (T',)."""

    def __init__(self, hop_length: int, window_size: Optional[int] = None,
                 window: str = "hann"):
        super().__init__()
        self.hop_length = hop_length
        self.window_size = hop_length * 4 if window_size is None \
            else window_size
        self.padding = (self.window_size - self.hop_length) // 2
        self.register_buffer("win", torch.tensor(
            get_window_fn(window)(self.window_size), dtype=torch.float32),
            persistent=False)

    def _frames(self, ex: torch.Tensor, n_frames: int) -> torch.Tensor:
        """Pad and cut (B, T) into (B, F, window), F at most n_frames."""
        frames = unfold(F.pad(ex, (self.padding, self.padding)),
                        self.window_size, self.hop_length)
        return frames[:, :min(frames.shape[1], n_frames)]

    def _ola(self, filtered: torch.Tensor) -> torch.Tensor:
        y, norm = _overlap_add(filtered, self.win.to(filtered.device),
                               self.hop_length, self.padding)
        return y / norm

    def forward(self, ex: torch.Tensor, lpc: torch.Tensor) -> torch.Tensor:
        if ex.ndim != 1 or lpc.ndim != 2:
            raise ValueError(f"ex (T,) and lpc (F, 1 + order), got "
                             f"{tuple(ex.shape)} and {tuple(lpc.shape)}")
        frames = self._frames(ex[None], lpc.shape[0])
        if frames.shape[1] != lpc.shape[0]:
            raise ValueError(f"{frames.shape[1]} frames for {lpc.shape[0]} "
                             f"rows of lpc")
        filtered = lpc_synthesis(frames[0], lpc[:, 0], lpc[:, 1:])
        return self._ola(filtered[None])[0]


class BatchLPCSynth(LPCSynth):
    """Batched: ex (B, T), gain (B, F), a (B, F, order) -> (B, T')."""

    def forward(self, ex: torch.Tensor, gain: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
        if ex.ndim != 2 or gain.ndim != 2 or a.ndim != 3 or \
                a.shape[1] != gain.shape[1]:
            raise ValueError(f"ex (B, T), gain (B, F), a (B, F, order), got "
                             f"{tuple(ex.shape)}, {tuple(gain.shape)}, "
                             f"{tuple(a.shape)}")
        frames = self._frames(ex, a.shape[1])
        batch, n, ws = frames.shape
        filtered = lpc_synthesis(frames.reshape(-1, ws),
                                 gain[:, :n].reshape(-1),
                                 a[:, :n].reshape(-1, a.shape[-1]))
        return self._ola(filtered.reshape(batch, n, ws))


class BatchSecondOrderLPCSynth(LPCSynth):
    """A cascade of second-order sections a frame: the gain-scaled window
    runs through each section [a0, a1, a2] (normalised by a0, as
    torchaudio's lfilter) in turn, one ``allpole_const`` at p = 2 a
    section. ex (B, T), gain (B, F), biquads (B, F, K, 3) -> (B, T')."""

    def forward(self, ex: torch.Tensor, gain: torch.Tensor,
                biquads: torch.Tensor) -> torch.Tensor:
        if ex.ndim != 2 or gain.ndim != 2 or biquads.ndim != 4 or \
                biquads.shape[-1] != 3:
            raise ValueError(f"ex (B, T), gain (B, F), biquads (B, F, K, 3), "
                             f"got {tuple(ex.shape)}, {tuple(gain.shape)}, "
                             f"{tuple(biquads.shape)}")
        frames = self._frames(ex, biquads.shape[1])
        batch, n, ws = frames.shape
        flat = frames.reshape(-1, ws) * gain[:, :n].reshape(-1)[:, None]
        bi = biquads[:, :n].reshape(-1, biquads.shape[-2], 3)
        bi = bi / bi[..., :1]
        for i in range(bi.shape[-2]):
            flat = allpole_const(flat.contiguous(),
                                 bi[:, i, 1:].contiguous())
        return self._ola(flat.reshape(batch, n, ws))
