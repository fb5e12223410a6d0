"""Spectrogram conv-pyramid encoder, the Interspeech24 backbone
(counterpart of ``golf_tpu.models.unet``).

Spectrogram -> log -> running min/max -> stacked Conv2d/BN/ReLU/MaxPool
frequency pyramid -> flatten -> BiLSTM -> LayerNorm -> zero-init head.
Activations are NCHW (batch, channels, freq, time); ``golf_tpu`` keeps NHWC,
and its flatten orders features as ``freq_idx * C + c``, so the pyramid's
output is permuted to (B, T, F, C) before the reshape.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.sig import Sig
from ..ops import stft as stft_ops
from .enc import BackboneModelInterface, _running_minmax
from .rnn import BiLSTM


def _strided_max(x: torch.Tensor, s: int, axis: int) -> torch.Tensor:
    """Max-pool with window == stride along ``axis`` (floor)."""
    if s == 1:
        return x
    x = x.movedim(axis, -1)
    frames = x.shape[-1] // s
    x = x[..., :frames * s].reshape(*x.shape[:-1], frames, s).amax(dim=-1)
    return x.movedim(-1, axis)


class BatchNorm2d(nn.BatchNorm2d):
    """flax's ``BatchNorm`` in train mode: the running variance follows the
    biased batch variance (``nn.BatchNorm2d`` would take the unbiased one).
    In eval mode it is ``nn.BatchNorm2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            self.running_mean.lerp_(x.mean(dim=(0, 2, 3)), self.momentum)
            self.running_var.lerp_(x.var(dim=(0, 2, 3), unbiased=False),
                                   self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class ConvPyramid(nn.Module):
    """Conv2d((2s+1, 3)) + BN + ReLU + MaxPool((s, 1)) over frequency."""

    def __init__(self, in_channels: int = 1,
                 channels: Sequence[int] = (16, 32, 64, 128),
                 strides: Sequence[int] = (4, 4, 4, 4)):
        super().__init__()
        self.strides = tuple(strides)
        ins = (in_channels,) + tuple(channels[:-1])
        self.convs = nn.ModuleList(
            nn.Conv2d(i, o, kernel_size=(2 * s + 1, 3), padding=(s, 1))
            for i, o, s in zip(ins, channels, strides))
        # flax BatchNorm: eps 1e-5, running averages decay by 0.99
        self.norms = nn.ModuleList(
            BatchNorm2d(o, eps=1e-5, momentum=0.01) for o in channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm, s in zip(self.convs, self.norms, self.strides):
            x = _strided_max(F.relu(norm(conv(x))), s, axis=2)
        return x


class UNetEncoder(BackboneModelInterface):
    def __init__(self, out_channels: int, n_fft: int = 1024,
                 hop_length: int = 256,
                 channels: Sequence[int] = (16, 32, 64, 128),
                 strides: Sequence[int] = (4, 4, 4, 4),
                 lstm_hidden_size: int = 128, num_layers: int = 1,
                 dropout: float = 0.0, include_env_features: bool = False,
                 num_harmonics: int = 150, sample_rate: int = 22050,
                 f0_conditioning: bool = True, use_lru: bool = False,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if include_env_features or use_lru or compute_dtype:
            raise NotImplementedError(
                "env_features, the LRU block and compute_dtype are not "
                "ported")
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.f0_conditioning = f0_conditioning
        self.pyramid = ConvPyramid(1, channels, strides)
        n_freq = n_fft // 2 + 1
        for s in strides:
            n_freq //= s
        lstm_in = n_freq * channels[-1] + (1 if f0_conditioning else 0)
        self.lstm = BiLSTM(lstm_in, lstm_hidden_size, num_layers, dropout)
        # flax LayerNorm's epsilon is 1e-6 (torch's default is 1e-5)
        self.norm = nn.LayerNorm(2 * lstm_hidden_size, eps=1e-6)
        self.out_linear = self.make_out_linear(2 * lstm_hidden_size,
                                               out_channels)
        self.register_buffer("log_spec_min", torch.tensor(float("inf")))
        self.register_buffer("log_spec_max", torch.tensor(float("-inf")))

    def features(self, x: Sig, f0: Optional[Sig], train: bool):
        """Normalised log spectrogram (B, 1, freq, T) and the frame-rate
        f0 (or None). In train mode this updates the running min/max."""
        if x.hop != 1:
            raise ValueError("the encoder takes a signal at hop 1")
        spec = stft_ops.spectrogram(x.data, self.n_fft, self.hop_length,
                                    power=2.0, center=True)
        f0_d = None
        if self.f0_conditioning:
            if f0 is None:
                raise ValueError("f0_conditioning needs f0")
            f0_d = f0.set_hop_length(self.hop_length).truncate(
                spec.shape[2]).data
            spec = spec[..., :f0_d.shape[-1]]
        log_spec = torch.log(spec + 1e-8)[:, None]
        return _running_minmax(self, log_spec, train), f0_d

    def forward(self, x: Sig, f0: Optional[Sig] = None, train: bool = False
                ) -> Sig:
        """``train`` updates the running min/max; the batch norms and the
        LSTM's dropout follow the module's mode. ``golf_tpu`` drives all
        three from ``train``, so the two must agree."""
        if train != self.training:
            raise ValueError(
                f"train={train} but the encoder is in "
                f"{'train' if self.training else 'eval'} mode; call "
                f".train() or .eval() to match")
        h = self.lstm(self.rows(*self.features(x, f0, train)))
        return Sig(self.head(h), self.hop_length)

    def rows(self, feature: torch.Tensor, f0_d: Optional[torch.Tensor]
             ) -> torch.Tensor:
        """The recurrent stack's input (B, T, freq' C [+ 1]): the conv
        pyramid's output flattened as ``golf_tpu`` does, and log1p(f0)."""
        h = self.pyramid(feature)                      # (B, C, freq', T)
        b, c, fr, t = h.shape
        h = h.permute(0, 3, 2, 1).reshape(b, t, fr * c)
        if f0_d is not None:
            h = h[:, :f0_d.shape[-1]]
            h = torch.cat([h, torch.log1p(f0_d)[..., None]], dim=-1)
        return h

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """LayerNorm and the output linear over the recurrent stack's
        output."""
        return self.out_linear(self.norm(h))
