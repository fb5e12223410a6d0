"""Linear Recurrent Unit (counterpart of ``golf_tpu.models.lru``): a
diagonal complex recurrence h_t = lambda h_{t-1} + gamma (B x_t), read out
as Re(C h_t) (+ D x_t when in == out).

``golf_tpu`` runs the recurrence as ``jax.lax.associative_scan``; here it is
a log-depth (Hillis-Steele) scan with the same combine
``(la lb, xa lb + xb)``, so T steps take ceil(log2 T) levels. The two group
the products differently, so they agree to complex64 rounding, not bit for
bit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


def lru_scan(lam: torch.Tensor, bu: torch.Tensor,
             zi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = lam * h_{t-1} + bu_t along dim 1 from h_{-1} = zi (zero when
    None). bu: (B, T, H) complex, lam: (H,) complex, zi: (B, H) complex."""
    if zi is not None:
        bu = torch.cat([bu[:, :1] + lam * zi[:, None], bu[:, 1:]], dim=1)
    h = bu
    power = lam                     # lam ** shift: the span each side covers
    shift = 1
    while shift < h.shape[1]:
        h = torch.cat([h[:, :shift], h[:, :-shift] * power + h[:, shift:]],
                      dim=1)
        power = power * power
        shift *= 2
    return h


class LRU(nn.Module):
    """in_features -> hidden diagonal complex state -> out_features (real),
    with ``golf_tpu``'s parameter names and initialisers."""

    def __init__(self, in_features: int, out_features: int,
                 state_features: Optional[int] = None, r_min: float = 0.0,
                 r_max: float = 1.0):
        super().__init__()
        h = state_features or out_features
        u = torch.rand(h)
        self.nu_log = nn.Parameter(torch.log(-0.5 * torch.log(
            u * (r_max ** 2 - r_min ** 2) + r_min ** 2)))
        self.theta_log = nn.Parameter(torch.log(torch.rand(h) * 2 * math.pi))
        scale_in = 1.0 / math.sqrt(2 * in_features)
        self.B_re = nn.Parameter(scale_in * torch.randn(in_features, h))
        self.B_im = nn.Parameter(scale_in * torch.randn(in_features, h))
        scale_out = 1.0 / math.sqrt(h)
        self.C_re = nn.Parameter(scale_out * torch.randn(h, out_features))
        self.C_im = nn.Parameter(scale_out * torch.randn(h, out_features))
        self.D = nn.Parameter(torch.randn(in_features)) \
            if in_features == out_features else None

    def forward(self, x: torch.Tensor, zi: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, T, in) real, zi (B, H) complex -> (y (B, T, out), the last
        state (B, H))."""
        lam = torch.exp(torch.complex(-torch.exp(self.nu_log),
                                      torch.exp(self.theta_log)))
        gamma = torch.sqrt(1 - torch.abs(lam) ** 2)
        bu = (x.to(torch.complex64)
              @ torch.complex(self.B_re, self.B_im)) * gamma
        hseq = lru_scan(lam, bu, zi)
        y = (hseq @ torch.complex(self.C_re, self.C_im)).real
        if self.D is not None:
            y = y + x * self.D
        return y, hseq[:, -1]
