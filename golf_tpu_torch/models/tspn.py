"""Set-prediction modules (counterpart of ``golf_tpu.models.tspn``):
``TopNGenerator``, a cosine-similarity lookup of stored embeddings, and
``TTSPNEncoder``, cross-attention layers over a memory of frames followed
by a BiLSTM and a linear head.

A ``TTSPNEncoderLayer`` is the transformer backbone's ``AttentionLayer``
(``models/unet.py``: flax's ``MultiHeadDotProductAttention``, post-norm,
a ReLU MLP of 4 d) with its queries from the set's tokens and its keys and
values from the memory. In train mode with dropout, each layer drops
attention weights with one (tokens, frames) mask shared by every batch
item and head (flax's ``broadcast_dropout``), drawn from the default
generator or given as ``keeps``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from .enc import check_mode
from .rnn import BiLSTM
from .unet import AttentionLayer

TTSPNEncoderLayer = AttentionLayer


class TopNGenerator(nn.Module):
    """The ``top_n`` stored embeddings closest, by cosine similarity, to a
    projection of the time-pooled feature: (B, T, in_features) ->
    (B, top_n, embed_size). ``in_features`` (which flax infers at init) is
    the feature's width, ``embed_size`` unless given."""

    def __init__(self, num_embeddings: int = 256, embed_size: int = 128,
                 top_n: int = 10, in_features: Optional[int] = None):
        super().__init__()
        self.top_n = top_n
        self.embeddings = nn.Parameter(torch.randn(num_embeddings,
                                                   embed_size))
        self.proj = nn.Linear(in_features or embed_size, embed_size)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        q = self.proj(feature.mean(dim=1))                       # (B, E)
        sim = (q @ emb.T) / (
            torch.linalg.vector_norm(q, dim=-1, keepdim=True)
            * torch.linalg.vector_norm(emb, dim=-1)[None] + 1e-8)
        idx = torch.topk(sim, self.top_n, dim=-1).indices
        return emb[idx]


class TTSPNEncoder(nn.Module):
    """tokens (B, N, d_model), memory (B, T, d_model) -> (B, N,
    out_channels)."""

    def __init__(self, d_model: int = 128, nhead: int = 4,
                 num_layers: int = 2, dropout: float = 0.1,
                 out_channels: int = 2):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.ModuleList(TTSPNEncoderLayer(d_model, nhead)
                                    for _ in range(num_layers))
        self.lstm = BiLSTM(d_model, d_model // 2)
        self.head = nn.Linear(d_model, out_channels)

    def dropout_masks(self, n_tokens: int, n_frames: int, device
                      ) -> List[Optional[torch.Tensor]]:
        """One (tokens, frames) multiplier a layer in train mode with
        dropout, else None."""
        if not self.training or self.dropout <= 0:
            return [None] * len(self.layers)
        keep = 1.0 - self.dropout
        return [(torch.rand((n_tokens, n_frames), device=device) < keep)
                .float() / keep for _ in self.layers]

    def forward(self, tokens: torch.Tensor, memory: torch.Tensor,
                train: bool = False,
                keeps: Optional[Sequence[Optional[torch.Tensor]]] = None
                ) -> torch.Tensor:
        check_mode(self, train)
        if keeps is None:
            keeps = self.dropout_masks(tokens.shape[1], memory.shape[1],
                                       tokens.device)
        x = tokens
        for layer, keep in zip(self.layers, keeps):
            x = layer(x, keep, memory)
        return self.head(self.lstm(x))
