"""STFT and spectrogram (counterpart of ``golf_tpu.ops.stft``):
torchaudio ``Spectrogram`` semantics, center=True with reflect padding,
win_length = n_fft unless given, not normalized."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .dsp import get_window_fn


def frame_signal(x: torch.Tensor, frame_length: int, hop: int,
                 center: bool = True, pad_mode: str = "reflect"
                 ) -> torch.Tensor:
    """(..., T) -> (..., F, frame_length), torch.stft framing."""
    if center:
        pad = frame_length // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=pad_mode)
        x = x.reshape(*lead, x.shape[-1])
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None, window: str = "hann",
         center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """One-sided STFT. Returns complex (..., n_bins, n_frames)."""
    win_length = win_length or n_fft
    w = np.zeros(n_fft)
    ofs = (n_fft - win_length) // 2
    w[ofs:ofs + win_length] = get_window_fn(window)(win_length)
    frames = frame_signal(x, n_fft, hop_length, center, pad_mode)
    frames = frames * torch.as_tensor(w, dtype=x.dtype, device=x.device)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def spectrogram(x: torch.Tensor, n_fft: int, hop_length: int,
                win_length: Optional[int] = None, window: str = "hann",
                power: Optional[float] = 2.0, center: bool = True,
                pad_mode: str = "reflect") -> torch.Tensor:
    """power=None returns complex; 1 magnitude; 2 power spectrum."""
    s = stft(x, n_fft, hop_length, win_length, window, center, pad_mode)
    if power is None:
        return s
    mag = torch.abs(s)
    if power == 1.0:
        return mag
    return mag ** power
