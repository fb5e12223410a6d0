"""Mel frame-rate backbone (counterpart of ``golf_tpu.models.mel``):
``Mel2Control``, the ISMIR23 vocoder's encoder. ``X2Control``,
``LPCFrameNet`` and ``WN`` are not ported."""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F
from torch import nn

from ..core.sig import Sig
from .enc import BackboneModelInterface
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
        if train != self.training:
            raise ValueError(
                f"train={train} but the encoder is in "
                f"{'train' if self.training else 'eval'} mode; call "
                f".train() or .eval() to match")
        x = mels.data.transpose(1, 2)                  # (B, C, T)
        x = self.convs[0](x)
        x = F.leaky_relu(self.group_norm(x), 0.01)
        x = self.convs[1](x).transpose(1, 2)           # (B, T, C)
        h = self.norm(self.lstm(x))
        return Sig(self.out_linear(h), mels.hop)
