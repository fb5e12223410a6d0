"""Source-filter synthesizer, the GOLF topology (counterpart of
``golf_tpu.models.sf``).

Glottal source (hard-gated by voicing at 0.5 when given), plus filtered
noise, through the time-varying all-pole ``end_filter`` and the LTI
``room_filter``. With a ``target`` the synthesizer runs in the excitation
domain instead: the end filter's ``reverse`` scales the source and
inverse-filters the target, the room filter is not run, and the pair
(source, inverse-filtered target) is returned. Under time sharding the
voicing gate, thresholded at the voicing's frame rate as the unsharded
product makes it, is localized to the rank's window.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.sig import Sig, bcast_len, sig_where
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
        env = seqpar.current()
        # time-sharded, each stage knows its unsharded input's length: the
        # noise is drawn over the source's, the filters pad past theirs
        n = {} if env is None else self.stage_lens(
            env.t_global, harm_oscillator_params, noise_generator_params,
            noise_filter_params, end_filter_params, voicing)
        harm_osc = self.harm_oscillator(phase, *harm_oscillator_params)
        if voicing is not None:
            # the gate is made at the voicing's rate and then upsampled, so
            # under time sharding it is localized after the threshold
            gate = sig_where(voicing > 0.5, voicing, 0.0)
            if env is not None and gate.hop > 1:
                gate = seqpar.localize(gate, env, 1)
            harm_osc = harm_osc * gate
        kw = {"t_global": n["harm"]} if n else {}
        noise_sig = self.noise_generator(harm_osc, *noise_generator_params,
                                         generator=generator, noise=noise,
                                         **kw)
        src = harm_osc + seqpar.stage(self.noise_filter, noise_sig,
                                      noise_filter_params, n.get("noise"))
        if self.subtract_harmonics:
            src = src - seqpar.stage(self.noise_filter, harm_osc,
                                     noise_filter_params, n.get("harm"))
        if target is not None:
            return self.end_filter.reverse(src, target, *end_filter_params)
        out = seqpar.stage(self.end_filter, src, end_filter_params,
                           n.get("src"))
        if self.room_filter is None:
            return out
        return seqpar.stage(self.room_filter, out, room_filter_params,
                            n.get("end"))

    def stage_lens(self, t_phase: int, harm_oscillator_params=(),
                   noise_generator_params=(), noise_filter_params=(),
                   end_filter_params=(), voicing: Optional[Sig] = None,
                   **other_params) -> dict:
        """The steps of each stage's unsharded output for a phase of
        ``t_phase`` steps and these ctrl shapes: the gated harmonic source
        (the noise's reference), the noise, the filtered source and the end
        filter's output."""
        harm = self.harm_oscillator.out_len(t_phase, *harm_oscillator_params)
        if voicing is not None:
            harm = bcast_len(harm, voicing)
        noise = self.noise_generator.out_len(harm, *noise_generator_params)
        src = min(harm, self.noise_filter.out_len(noise,
                                                  *noise_filter_params))
        if self.subtract_harmonics:
            src = min(src, self.noise_filter.out_len(harm,
                                                     *noise_filter_params))
        return {"harm": harm, "noise": noise, "src": src,
                "end": self.end_filter.out_len(src, *end_filter_params)}

    def out_len(self, t_phase: int, harm_oscillator_params=(),
                noise_generator_params=(), noise_filter_params=(),
                end_filter_params=(), room_filter_params=(),
                voicing: Optional[Sig] = None, **other_params) -> int:
        """The steps of ``forward``'s output for a phase of ``t_phase``
        steps and these ctrl shapes."""
        end = self.stage_lens(t_phase, harm_oscillator_params,
                              noise_generator_params, noise_filter_params,
                              end_filter_params, voicing)["end"]
        if self.room_filter is None:
            return end
        return self.room_filter.out_len(end, *room_filter_params)
