"""Harmonic-plus-noise synthesizer, the DDSP / SawSing / NHV topology
(counterpart of ``golf_tpu.models.hpn``).

Harmonic branch -> ``harm_filter``, noise branch -> ``noise_filter``, their
sum -> the LTI ``end_filter``. The voicing multiplies the *phase*, before
the oscillator (``SourceFilterSynth`` gates the waveform instead), so with
a voicing that needs a gradient the lookup's phase needs one too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.sig import Sig
from .ctrl import Synth


class HarmonicPlusNoiseSynth(Synth):
    ctrl_names = ("harm_oscillator", "noise_generator", "harm_filter",
                  "noise_filter", "end_filter")

    def __init__(self, harm_oscillator: nn.Module, noise_generator: nn.Module,
                 harm_filter: nn.Module, noise_filter: nn.Module,
                 end_filter: nn.Module):
        super().__init__()
        self.harm_oscillator = harm_oscillator
        self.noise_generator = noise_generator
        self.harm_filter = harm_filter
        self.noise_filter = noise_filter
        self.end_filter = end_filter

    def forward(self, phase: Sig,
                harm_oscillator_params: Tuple[Sig, ...] = (),
                noise_generator_params: Tuple[Sig, ...] = (),
                harm_filter_params: Tuple[Sig, ...] = (),
                noise_filter_params: Tuple[Sig, ...] = (),
                end_filter_params: Tuple[Sig, ...] = (),
                voicing: Optional[Sig] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, **other_params) -> Sig:
        if voicing is not None:
            phase = phase * voicing
        harm_osc = self.harm_oscillator(phase, *harm_oscillator_params)
        noise_sig = self.noise_generator(harm_osc, *noise_generator_params,
                                         generator=generator, noise=noise)
        harm_osc = self.harm_filter(harm_osc, *harm_filter_params)
        noise_sig = self.noise_filter(noise_sig, *noise_filter_params)
        return self.end_filter(harm_osc + noise_sig, *end_filter_params)
