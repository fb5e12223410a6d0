"""Encoder interface (counterpart of ``golf_tpu.models.enc``): a backbone
with one zero-initialised linear head, sliced into named parameter groups.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.sig import Sig
from .ctrl import split_heads

Layout = Tuple[Tuple[Tuple[int, ...], ...], Tuple[str, ...]]


class BackboneModelInterface(nn.Module):
    """Base with the zero-initialised output linear: parameters start at the
    DSP prior."""

    def make_out_linear(self, in_features: int, out_channels: int
                        ) -> nn.Linear:
        lin = nn.Linear(in_features, out_channels)
        nn.init.zeros_(lin.weight)
        nn.init.zeros_(lin.bias)
        return lin


def _running_minmax(mdl: nn.Module, value: torch.Tensor, train: bool,
                    prefix: str = "log_spec") -> torch.Tensor:
    """Normalise by running min/max buffers (``{prefix}_min``/``_max``,
    starting at +inf/-inf), updated only in train mode."""
    vmin = getattr(mdl, f"{prefix}_min")
    vmax = getattr(mdl, f"{prefix}_max")
    if train:
        with torch.no_grad():
            vmin.copy_(torch.minimum(vmin, value.min()))
            vmax.copy_(torch.maximum(vmax, value.max()))
    return (value - vmin) / (vmax - vmin)


def full_layout(split_sizes: Sequence[Sequence[int]],
                args_keys: Sequence[str], learn_voicing: bool,
                learn_f0: bool) -> Layout:
    sizes, keys = tuple(tuple(s) for s in split_sizes), tuple(args_keys)
    if learn_voicing:
        sizes, keys = ((1,),) + sizes, ("voicing_logits",) + keys
    if learn_f0:
        sizes, keys = ((1,),) + sizes, ("f0",) + keys
    return sizes, keys


class VocoderParameterEncoderInterface(nn.Module):
    def __init__(self, backbone: nn.Module, split_sizes=(), args_keys=(),
                 learn_voicing: bool = False, learn_f0: bool = True,
                 f0_min: float = 80.0, f0_max: float = 1000.0):
        super().__init__()
        self.backbone = backbone
        self.layout = full_layout(split_sizes, args_keys, learn_voicing,
                                  learn_f0)
        self.f0_min = f0_min
        self.f0_max = f0_max

    def forward(self, x: Sig, f0: Optional[Sig] = None, train: bool = False
                ) -> Dict[str, Any]:
        h = self.backbone(x, f0=f0, train=train)
        params: Dict[str, Any] = {}
        for key, group in split_heads(h, *self.layout).items():
            if key == "f0":
                logits = group[0]
                f0_hat = torch.exp(
                    torch.sigmoid(logits.data)
                    * (math.log(self.f0_max) - math.log(self.f0_min))
                    + math.log(self.f0_min))
                params["f0"] = Sig(f0_hat, logits.hop)
            elif key == "voicing_logits":
                params["voicing_logits"] = group[0]
            else:
                params[key] = group
        return params
