"""Recurrent backbone (counterpart of ``golf_tpu.models.rnn.BiLSTM``).

A bidirectional ``nn.LSTM`` (cuDNN on the GPU). The gate order (i, f, g, o)
and activations are those of flax's ``OptimizedLSTMCell``; the bridge
(``golf_tpu_torch.bridge``) maps its per-gate kernels onto this layout.
"""

from __future__ import annotations

import torch
from torch import nn


class BiLSTM(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers=num_layers,
                            batch_first=True, bidirectional=True,
                            dropout=dropout if num_layers > 1 else 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lstm(x)[0]
