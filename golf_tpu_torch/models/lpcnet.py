"""LPCNet's sample-rate network (counterpart of ``golf_tpu.models.lpcnet``).

The continuous mu-law codec, the interpolated embedding and the dual-GRU
sample net with its dual-FC head. Teacher-forced, each GRU is a bias-free
``nn.GRU`` over the whole sequence (cuDNN on the GPU); ``sample_forward``,
one autoregressive step, runs the same weights in a one-step cell. The
gate order (r, z, n) and ``n = tanh(W_in x + r * W_hn h)`` are those of
``golf_tpu``'s ``GRUCellNoBias``, whose ``wi (in, 3H)`` and ``wh (H, 3H)``
are ``weight_ih_l0`` and ``weight_hh_l0`` transposed.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


def mu_law_encode_continuous(x: torch.Tensor,
                             quantization_channels: int = 256
                             ) -> torch.Tensor:
    """Continuous mu-law -> [0, mu]."""
    mu = quantization_channels - 1.0
    x_mu = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)
    return (x_mu + 1) / 2 * mu


def mu_law_decode_continuous(x_mu: torch.Tensor,
                             quantization_channels: int = 256
                             ) -> torch.Tensor:
    mu = quantization_channels - 1.0
    x = (x_mu / mu) * 2 - 1
    return torch.sign(x) * (torch.exp(torch.abs(x) * math.log1p(mu)) - 1) / mu


class InterpolatedEmbedding(nn.Module):
    """Linear interpolation between adjacent rows of a table for continuous
    indices: row floor(x) (clipped to [0, n - 2]) and the next, weighted by
    x minus that row's index (not clipped, so it extrapolates outside)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(num_embeddings, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.embedding.shape[0]
        lower = torch.clamp(torch.floor(x).long(), 0, n - 2)
        p = (x - lower)[..., None]
        return self.embedding[lower] * (1 - p) + \
            self.embedding[lower + 1] * p


def gru_cell(gru: nn.GRU, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One step of a one-layer bias-free ``nn.GRU`` on its own weights:
    (B, H), (B, in) -> the new (B, H)."""
    x_r, x_z, x_n = torch.chunk(x @ gru.weight_ih_l0.T, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(h @ gru.weight_hh_l0.T, 3, dim=-1)
    r = torch.sigmoid(x_r + h_r)
    z = torch.sigmoid(x_z + h_z)
    n = torch.tanh(x_n + r * h_n)
    return (1 - z) * n + z * h


class SampleNet(nn.Module):
    """Dual-GRU sample-rate net: the conditioning f and the embeddings of
    the prediction, the previous sample and the previous excitation (all
    continuous mu-law indices) into GRU A, its state and f into GRU B, then
    ``sum over pairs of tanh(fc(h_b)) * a`` as Q logits."""

    def __init__(self, quantization_channels: int = 256,
                 condition_channels: int = 128, a_channels: int = 192,
                 b_channels: int = 32):
        super().__init__()
        q = quantization_channels
        self.quantization_channels = q
        self.condition_channels = condition_channels
        self.a_channels = a_channels
        self.b_channels = b_channels
        self.embeddings = InterpolatedEmbedding(q, q)
        self.gru_a = nn.GRU(condition_channels + 3 * q, a_channels,
                            bias=False, batch_first=True)
        self.gru_b = nn.GRU(a_channels + condition_channels, b_channels,
                            bias=False, batch_first=True)
        self.a = nn.Parameter(torch.randn(2 * q))
        self.fc = nn.Linear(b_channels, 2 * q)

    def _head(self, h_b: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(self.fc(h_b)) * self.a
        return h.reshape(*h.shape[:-1], self.quantization_channels,
                         2).sum(-1)

    def _inputs(self, f: torch.Tensor, p: torch.Tensor, s_prev: torch.Tensor,
                e_prev: torch.Tensor) -> torch.Tensor:
        """[f, emb(p), emb(s_prev), emb(e_prev)] along the last axis."""
        emb = self.embeddings(torch.stack([p, s_prev, e_prev], dim=-1))
        return torch.cat([f, emb.flatten(-2)], dim=-1)

    def forward(self, f: torch.Tensor, p: torch.Tensor, s_prev: torch.Tensor,
                e_prev: torch.Tensor) -> torch.Tensor:
        """Teacher-forced: f (B, T, C), p/s_prev/e_prev (B, T) -> logits
        (B, T, Q)."""
        ha, _ = self.gru_a(self._inputs(f, p, s_prev, e_prev))
        hb, _ = self.gru_b(torch.cat([ha, f], dim=-1))
        return self._head(hb)

    def sample_forward(self, f: torch.Tensor, p: torch.Tensor,
                       s_prev: torch.Tensor, e_prev: torch.Tensor,
                       states: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None):
        """One autoregressive step: f (B, C), the others (B,) -> (logits
        (B, Q), (state_a, state_b)); zero states when ``states`` is None."""
        if states is None:
            b = f.shape[0]
            states = (f.new_zeros((b, self.a_channels)),
                      f.new_zeros((b, self.b_channels)))
        state_a, state_b = states
        state_a = gru_cell(self.gru_a, state_a,
                           self._inputs(f, p, s_prev, e_prev))
        state_b = gru_cell(self.gru_b, state_b,
                           torch.cat([state_a, f], dim=-1))
        return self._head(state_b), (state_a, state_b)
