"""CREPE-style strided conv pitch backbone (counterpart of
``golf_tpu.models.crepe``).

Six strided ``Conv1d`` layers (flax's ``padding=k//2``, symmetric, is
``Conv1d``'s ``padding=k // 2``), each followed by batch norm (flax's eps
1e-5 and momentum 0.99, which is torch's 0.01) and ReLU, then the
zero-initialised head: (B, T) at hop h -> (B, T', out_channels) at hop
4 * 4 * 4 * 4 * 2 * 2 * h = 1024 h. The batch norms follow the module's
mode, and ``train`` must agree with it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.sig import Sig
from ..parallel.mesh import train_batch_norm
from .enc import BackboneModelInterface, check_mode


class BatchNorm1d(nn.BatchNorm1d):
    """flax's ``BatchNorm`` in train mode, as ``unet.BatchNorm2d``: the
    running variance follows the biased batch variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return train_batch_norm(self, x)


class CREPE(BackboneModelInterface):
    def __init__(self, out_channels: int,
                 channels: Sequence[int] = (128, 32, 32, 128, 256, 512),
                 kernels: Sequence[int] = (512, 64, 64, 64, 64, 64),
                 strides: Sequence[int] = (4, 4, 4, 4, 2, 2)):
        super().__init__()
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        self.strides = tuple(strides)
        in_ch = 1
        for ch, k, s in zip(channels, kernels, strides):
            self.convs.append(nn.Conv1d(in_ch, ch, k, stride=s,
                                        padding=k // 2))
            self.norms.append(BatchNorm1d(ch, eps=1e-5, momentum=0.01))
            in_ch = ch
        self.out_linear = self.make_out_linear(in_ch, out_channels)

    def forward(self, x: Sig, f0: Optional[Sig] = None,
                train: bool = False) -> Sig:
        check_mode(self, train)
        h = x.data[:, None, :]                       # (B, 1, T)
        hop = 1
        for conv, norm, s in zip(self.convs, self.norms, self.strides):
            h = F.relu(norm(conv(h)))
            hop *= s
        return Sig(self.out_linear(h.transpose(1, 2)), hop * x.hop)
