"""FCNF0-style neural pitch estimator (counterpart of
``golf_tpu.models.pitchnet``): the ``penn`` method of
``scripts/wav2f0_torch.py``.

Frames of 1024 samples at a 16 kHz analysis rate (one a 5 ms hop, centred
on the original clock) go through a strided conv pyramid, each conv
followed by LayerNorm (flax's eps, 1e-6) and ReLU, then one linear layer to
pitch-bin logits over 65-1047 Hz at 10 cents a bin. Decoding is penn's: the
local expected cents over +-4 bins around the argmax, periodicity the
largest softmax probability, f0 gated to 0 at periodicity <= 0.065. The
pyramid's output is flattened in flax's (length, channel) order before the
linear layer, so ``golf_tpu``'s weights (``golf_tpu/assets/
pitchnet.msgpack``, read by ``utils/pitchnet.py``) apply as they are.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ANALYSIS_SR = 16000
FRAME = 1024
CENTS_PER_BIN = 10.0
FMIN = 65.0
FMAX = 1047.0
N_BINS = int(math.ceil(1200.0 * math.log2(FMAX / FMIN) / CENTS_PER_BIN)) + 1


def bin_centers_hz() -> np.ndarray:
    cents = np.arange(N_BINS) * CENTS_PER_BIN
    return FMIN * 2.0 ** (cents / 1200.0)


def f0_to_bin(f0: np.ndarray) -> np.ndarray:
    cents = 1200.0 * np.log2(np.maximum(f0, 1e-6) / FMIN)
    return np.clip(np.round(cents / CENTS_PER_BIN), 0, N_BINS - 1).astype(
        np.int32)


class PitchNet(nn.Module):
    """Strided conv pyramid: (B, 1024) frames -> (B, N_BINS) logits."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128, 256, 256),
                 kernels: Sequence[int] = (32, 16, 8, 8, 4),
                 strides: Sequence[int] = (4, 4, 4, 4, 4)):
        super().__init__()
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        in_ch, length = 1, FRAME
        for ch, k, s in zip(channels, kernels, strides):
            self.convs.append(nn.Conv1d(in_ch, ch, k, stride=s,
                                        padding=k // 2))
            self.norms.append(nn.LayerNorm(ch, eps=1e-6))
            in_ch, length = ch, (length + 2 * (k // 2) - k) // s + 1
        self.dense = nn.Linear(length * in_ch, N_BINS)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        # per-frame normalization: remove DC, unit RMS
        x = frames - frames.mean(-1, keepdim=True)
        x = x / (torch.sqrt((x * x).mean(-1, keepdim=True)) + 1e-6)
        h = x[:, None, :]
        for conv, norm in zip(self.convs, self.norms):
            h = F.relu(norm(conv(h).transpose(1, 2))).transpose(1, 2)
        return self.dense(h.transpose(1, 2).reshape(h.shape[0], -1))


def frame_signal(x: np.ndarray, sr: int, hop_ms: float = 5.0
                 ) -> Tuple[np.ndarray, int]:
    """Resample to the analysis rate (``utils.native.resample``) and cut
    centred frames: (frames (N, FRAME) float32, n_frames), frame i centred
    at i * hop_ms on the original clock."""
    if sr != ANALYSIS_SR:
        from ..utils.native import resample
        x = resample(np.asarray(x, np.float64), sr, ANALYSIS_SR)
        dur = len(x) / ANALYSIS_SR
    else:
        dur = len(x) / sr
    hop = int(round(ANALYSIS_SR * hop_ms / 1000.0))
    n_frames = int(dur * 1000.0 / hop_ms) + 1
    pad = FRAME // 2
    xp = np.pad(x.astype(np.float32), (pad, pad + FRAME))
    idx = np.arange(n_frames)[:, None] * hop + np.arange(FRAME)[None, :]
    return xp[idx], n_frames


def decode(logits: torch.Tensor, gate: float = 0.065
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits -> (f0 in Hz, 0 where periodicity <= gate; periodicity)."""
    probs = torch.softmax(logits, -1)
    periodicity, center = probs.max(-1)
    offs = torch.arange(-4, 5, device=logits.device)
    idx = torch.clamp(center[:, None] + offs[None, :], 0, N_BINS - 1)
    w = torch.gather(probs, -1, idx)
    cents = (idx.to(probs.dtype) * CENTS_PER_BIN * w).sum(-1) / (
        w.sum(-1) + 1e-9)
    f0 = FMIN * torch.pow(2.0, cents / 1200.0)
    return torch.where(periodicity > gate, f0, torch.zeros_like(f0)), \
        periodicity
