"""Harmonic-plus-noise synthesizer, the DDSP / SawSing / NHV topology
(counterpart of ``golf_tpu.models.hpn``).

Harmonic branch -> ``harm_filter``, noise branch -> ``noise_filter``, their
sum -> the LTI ``end_filter``. The voicing multiplies the *phase*, before
the oscillator (``SourceFilterSynth`` gates the waveform instead), so with
a voicing that needs a gradient the lookup's phase needs one too. Under
time sharding the voicing is localized to the rank's window first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.sig import Sig, bcast_len
from ..parallel import seqpar
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
        env = seqpar.current()
        # time-sharded, each stage knows its unsharded input's length: the
        # noise is drawn over the source's, the filters pad past theirs
        n = {} if env is None else self.stage_lens(
            env.t_global, harm_oscillator_params, noise_generator_params,
            harm_filter_params, noise_filter_params, voicing)
        if voicing is not None:
            if env is not None and voicing.hop > 1:
                # the rank's phase is its window: so must the voicing be
                voicing = seqpar.localize(voicing, env, 1)
            phase = phase * voicing
        harm_osc = self.harm_oscillator(phase, *harm_oscillator_params)
        kw = {"t_global": n["harm"]} if n else {}
        noise_sig = self.noise_generator(harm_osc, *noise_generator_params,
                                         generator=generator, noise=noise,
                                         **kw)
        harm_osc = seqpar.stage(self.harm_filter, harm_osc,
                                harm_filter_params, n.get("harm"))
        noise_sig = seqpar.stage(self.noise_filter, noise_sig,
                                 noise_filter_params, n.get("noise"))
        return seqpar.stage(self.end_filter, harm_osc + noise_sig,
                            end_filter_params, n.get("both"))

    def stage_lens(self, t_phase: int, harm_oscillator_params=(),
                   noise_generator_params=(), harm_filter_params=(),
                   noise_filter_params=(), voicing: Optional[Sig] = None,
                   **other_params) -> dict:
        """The steps of each stage's unsharded output for a phase of
        ``t_phase`` steps and these ctrl shapes: the harmonic source (the
        noise's reference), the noise, and the sum of the filtered two."""
        if voicing is not None:
            t_phase = bcast_len(t_phase, voicing)
        harm = self.harm_oscillator.out_len(t_phase, *harm_oscillator_params)
        noise = self.noise_generator.out_len(harm, *noise_generator_params)
        both = min(self.harm_filter.out_len(harm, *harm_filter_params),
                   self.noise_filter.out_len(noise, *noise_filter_params))
        return {"harm": harm, "noise": noise, "both": both}

    def out_len(self, t_phase: int, harm_oscillator_params=(),
                noise_generator_params=(), harm_filter_params=(),
                noise_filter_params=(), end_filter_params=(),
                voicing: Optional[Sig] = None, **other_params) -> int:
        """The steps of ``forward``'s output for a phase of ``t_phase``
        steps and these ctrl shapes."""
        both = self.stage_lens(t_phase, harm_oscillator_params,
                               noise_generator_params, harm_filter_params,
                               noise_filter_params, voicing)["both"]
        return self.end_filter.out_len(both, *end_filter_params)
