"""Source-filter synthesizer, the GOLF topology (counterpart of
``golf_tpu.models.sf``).

Glottal source (hard-gated by voicing at 0.5 when given), plus filtered
noise, through the time-varying all-pole ``end_filter`` and the LTI
``room_filter``. With a ``target`` the synthesizer runs in the excitation
domain instead: the end filter's ``reverse`` scales the source and
inverse-filters the target, the room filter is not run, and the pair
(source, inverse-filtered target) is returned. Under time sharding the
voicing gate is localized to the rank's window.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.sig import Sig, sig_where
from ..parallel import seqpar
from .ctrl import Synth


class SourceFilterSynth(Synth):
    ctrl_names = ("harm_oscillator", "noise_generator", "noise_filter",
                  "end_filter", "room_filter")

    def __init__(self, harm_oscillator: nn.Module, noise_generator: nn.Module,
                 noise_filter: nn.Module, end_filter: nn.Module,
                 room_filter: Optional[nn.Module] = None,
                 subtract_harmonics: bool = True):
        super().__init__()
        self.harm_oscillator = harm_oscillator
        self.noise_generator = noise_generator
        self.noise_filter = noise_filter
        self.end_filter = end_filter
        self.room_filter = room_filter
        self.subtract_harmonics = subtract_harmonics

    def forward(self, phase: Sig,
                harm_oscillator_params: Tuple[Sig, ...] = (),
                noise_generator_params: Tuple[Sig, ...] = (),
                noise_filter_params: Tuple[Sig, ...] = (),
                end_filter_params: Tuple[Sig, ...] = (),
                room_filter_params: Tuple[Sig, ...] = (),
                voicing: Optional[Sig] = None, target: Optional[Sig] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, **other_params):
        harm_osc = self.harm_oscillator(phase, *harm_oscillator_params)
        if voicing is not None:
            env = seqpar.current()
            if env is not None and voicing.hop > 1:
                voicing = seqpar.localize(voicing, env, 1)
            harm_osc = harm_osc * sig_where(voicing > 0.5, voicing, 0.0)
        noise_sig = self.noise_generator(harm_osc, *noise_generator_params,
                                         generator=generator, noise=noise)
        src = harm_osc + self.noise_filter(noise_sig, *noise_filter_params)
        if self.subtract_harmonics:
            src = src - self.noise_filter(harm_osc, *noise_filter_params)
        if target is not None:
            return self.end_filter.reverse(src, target, *end_filter_params)
        out = self.end_filter(src, *end_filter_params)
        if self.room_filter is None:
            return out
        return self.room_filter(out, *room_filter_params)
