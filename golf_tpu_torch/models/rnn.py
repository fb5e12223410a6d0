"""Recurrent backbone (counterpart of ``golf_tpu.models.rnn.BiLSTM``).

A bidirectional ``nn.LSTM`` (cuDNN on the GPU). The gate order (i, f, g, o)
and activations are those of flax's ``OptimizedLSTMCell``; the bridge
(``golf_tpu_torch.bridge``) maps its per-gate kernels onto this layout.
flax's cell has one bias, on the h side: ``bias_ih_*`` stays zero and does
not train (``requires_grad`` is off, so an optimizer and a gradient clip
over the trainable parameters do not see it).
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
        for name, prm in self.lstm.named_parameters():
            if name.startswith("bias_ih"):
                nn.init.zeros_(prm)
                prm.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lstm(x)[0]
