"""Mel frame-rate backbones (counterpart of ``golf_tpu.models.mel``):
``Mel2Control``, the encoder of the ISMIR23 vocoder and of LPCNet, the
other frame nets a ``frame_decoder`` may name, ``LPCFrameNet`` and the
non-causal WaveNet ``WN``, and ``X2Control``, the same stack on the raw
wave's log spectrogram and log1p(f0). Each takes its ``out_channels`` at
construction (``golf_tpu`` passes them at call time)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.sig import Sig
from ..ops import stft as stft_ops
from .enc import BackboneModelInterface, _running_minmax, check_mode
from .rnn import BiLSTM


class Mel2Control(BackboneModelInterface):
    """Conv1d(3) -> GroupNorm(4) -> leaky ReLU(0.01) -> Conv1d(3) -> BiLSTM
    -> LayerNorm -> the zero-initialised head, over (B, T, in_channels)
    features. flax's GroupNorm and LayerNorm take epsilon 1e-6 (torch's
    default is 1e-5)."""

    def __init__(self, out_channels: int, in_channels: int = 128,
                 hidden_channels: int = 128, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(in_channels, hidden_channels, 3, padding=1),
            nn.Conv1d(hidden_channels, hidden_channels, 3, padding=1)])
        self.group_norm = nn.GroupNorm(4, hidden_channels, eps=1e-6)
        self.lstm = BiLSTM(hidden_channels, hidden_channels, num_layers,
                           dropout)
        self.norm = nn.LayerNorm(2 * hidden_channels, eps=1e-6)
        self.out_linear = self.make_out_linear(2 * hidden_channels,
                                               out_channels)

    def forward(self, mels: Sig, f0: Optional[Sig] = None,
                train: bool = False) -> Sig:
        """``train`` drives the LSTM's dropout in ``golf_tpu``, the
        module's mode here: the two must agree."""
        check_mode(self, train)
        return Sig(self.stack(mels.data), mels.hop)

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, in_channels) -> the head's (B, T, out_channels)."""
        x = self.convs[0](x.transpose(1, 2))           # (B, C, T)
        x = F.leaky_relu(self.group_norm(x), 0.01)
        x = self.convs[1](x).transpose(1, 2)           # (B, T, C)
        return self.out_linear(self.norm(self.lstm(x)))


class X2Control(Mel2Control):
    """``Mel2Control``'s stack on the raw wave: its log power spectrogram
    (n_fft // 2 + 1 bins at ``hop_length``), normalised by the running
    min/max buffers ``log_spec_min``/``_max``, with log1p(f0) as one more
    channel; f0 is required."""

    def __init__(self, out_channels: int, n_fft: int = 1024,
                 hop_length: int = 256, hidden_channels: int = 128,
                 num_layers: int = 1, dropout: float = 0.0):
        super().__init__(out_channels, n_fft // 2 + 2, hidden_channels,
                         num_layers, dropout)
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.register_buffer("log_spec_min", torch.tensor(float("inf")))
        self.register_buffer("log_spec_max", torch.tensor(float("-inf")))

    def features(self, x: Sig, f0: Sig, train: bool) -> torch.Tensor:
        """The stack's input (B, T, bins + 1); in train mode this updates
        the running min/max."""
        spec = stft_ops.spectrogram(x.data, self.n_fft, self.hop_length,
                                    power=2.0, center=True)
        h = _running_minmax(self, torch.log(spec + 1e-8), train)
        h = h.transpose(1, 2)                          # (B, T, bins)
        f0_d = f0.set_hop_length(self.hop_length).truncate(h.shape[1]).data
        h = h[:, :f0_d.shape[1]]
        return torch.cat([h, torch.log1p(f0_d)[..., None]], dim=-1)

    def forward(self, x: Sig, f0: Optional[Sig] = None,
                train: bool = False) -> Sig:
        check_mode(self, train)
        return Sig(self.stack(self.features(x, f0, train)), self.hop_length)


class LPCFrameNet(BackboneModelInterface):
    """tanh(Conv1d(3)) twice, tanh(Linear), then the zero-initialised head,
    over (B, T, in_channels) features (``in_channels`` is the mel count,
    which flax infers)."""

    def __init__(self, out_channels: int, in_channels: int = 80,
                 hidden_channels: int = 128):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(in_channels, hidden_channels, 3, padding=1),
            nn.Conv1d(hidden_channels, hidden_channels, 3, padding=1)])
        self.dense0 = nn.Linear(hidden_channels, hidden_channels)
        self.out_linear = self.make_out_linear(hidden_channels,
                                               out_channels)

    def forward(self, mels: Sig, f0: Optional[Sig] = None,
                train: bool = False) -> Sig:
        x = mels.data.transpose(1, 2)
        for conv in self.convs:
            x = torch.tanh(conv(x))
        x = torch.tanh(self.dense0(x.transpose(1, 2)))
        return Sig(self.out_linear(x), mels.hop)


class NonCausalWaveNetLayer(nn.Module):
    """Gated dilated Conv1d (``radix`` taps, same-length padding), then a
    1x1 conv into the residual (added to the input) and the skip; the last
    layer has the skip only and returns (None, skip)."""

    def __init__(self, radix: int, dilation: int, residual_channels: int,
                 last_layer: bool = False):
        super().__init__()
        pad = dilation * (radix - 1) // 2
        out = residual_channels if last_layer else 2 * residual_channels
        self.last_layer = last_layer
        self.convs = nn.ModuleList([
            nn.Conv1d(residual_channels, 2 * residual_channels, radix,
                      padding=pad, dilation=dilation),
            nn.Conv1d(residual_channels, out, 1)])

    def forward(self, x: torch.Tensor):
        """x: (B, C, T) -> (residual output or None, skip)."""
        zw, zf = torch.chunk(self.convs[0](x), 2, dim=1)
        z = self.convs[1](torch.tanh(zw) * torch.sigmoid(zf))
        if self.last_layer:
            return None, z
        res, skip = torch.chunk(z, 2, dim=1)
        return res + x, skip


class WN(BackboneModelInterface):
    """Non-causal WaveNet: a 1x1 conv in, ``depth`` gated layers with
    dilations 2^(i mod cycle), the sum of their skips through a 1x1 conv out
    (not zero-initialised)."""

    def __init__(self, out_channels: int, in_channels: int = 80,
                 residual_channels: int = 128, depth: int = 20,
                 cycle: int = 6, radix: int = 3):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(in_channels, residual_channels, 1),
            nn.Conv1d(residual_channels, out_channels, 1)])
        self.layers = nn.ModuleList([
            NonCausalWaveNetLayer(radix, 2 ** (i % cycle), residual_channels,
                                  last_layer=i == depth - 1)
            for i in range(depth)])

    def forward(self, mels: Sig, f0: Optional[Sig] = None,
                train: bool = False) -> Sig:
        x = self.convs[0](mels.data.transpose(1, 2))
        cum_skip = 0.0
        for layer in self.layers:
            x, skip = layer(x)
            cum_skip = cum_skip + skip
        return Sig(self.convs[1](cum_skip).transpose(1, 2), mels.hop)
