"""Noise sources (counterpart of ``golf_tpu.models.noise``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.sig import Sig
from .ctrl import Controllable


class NoiseInterface(Controllable):
    pass


class StandardNormalNoise(NoiseInterface):
    """Standard normal noise shaped like ``ref``, drawn from ``generator``
    (a ``torch.Generator`` on ``ref``'s device). ``noise`` replaces the draw
    with a given tensor of the same shape, so a test can feed two
    implementations the same field."""

    def forward(self, ref: Sig, *args,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, **kwargs) -> Sig:
        if noise is not None:
            if tuple(noise.shape) != ref.shape:
                raise ValueError(f"noise {tuple(noise.shape)} != {ref.shape}")
            return ref.new(noise.to(ref.data))
        return ref.new(torch.randn(ref.shape, generator=generator,
                                   dtype=ref.dtype, device=ref.data.device))
