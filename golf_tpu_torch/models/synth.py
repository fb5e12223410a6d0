"""Harmonic sources (counterpart of ``golf_tpu.models.synth``): the
glottal-flow wavetables and the additive sine banks.

The wavetable oscillator integrates a normalized-frequency phase (f0/sr) in
the phase's dtype (fp32 on every path; a test runs fp64) with the wrapped
cumsum, optionally at an oversampled rate, looks the wrapped phase up in a
per-frame blend of LF glottal-pulse tables, and decimates. The indexed
tables blend two neighbouring tables by a scalar index a frame; the
weighted ones mix all of them by a softmax a frame (``weight @ table``);
``WrappedPhaseDownsampledIndexedGlottalFlowTable`` takes a phase that is
already wrapped. The sine banks
take harmonic k's phase as k times one wrapped cumsum of the base phase.
Under time sharding (``parallel.seqpar``) the indexed tables, the sine
banks and the pulse train run on this rank's window (the phase by the
global wrapped cumsum, the frame-rate amplitudes localized); the weighted
tables have no sharded branch, as in ``golf_tpu``. The sources with one
have ``out_len``, the steps of their unsharded output; on the others it
raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.sig import Sig, bcast_len
from ..ops.dsp import wrapped_cumsum
from ..ops.lf import build_glottal_table
from ..ops.lookup import lookup_blocks
from ..ops.resample import decimate
from ..parallel import seqpar
from .ctrl import Controllable


class OscillatorInterface(Controllable):
    pass


def _bilinear_table_lookup(wrapped_phase: torch.Tensor, tables: torch.Tensor,
                           hop: int, row0: Optional[int] = None
                           ) -> torch.Tensor:
    """wrapped_phase: (B, T) in [0, 1); tables: (B, frames, S) at frame hop
    ``hop``. Every block of ``hop`` samples interpolates between the same
    two table rows, so time is reshaped to (blocks, hop). Returns (B, T).
    With ``row0`` (time sharding) the phase is a window whose first sample
    sits at frame ``row0``: the window's rows are sliced from the tables,
    edge-held past their end."""
    b, t = wrapped_phase.shape
    blocks = (t + hop - 1) // hop
    frames = tables.shape[1]
    if row0 is not None:
        need = blocks + 1
        tables = torch.cat([tables, tables[:, -1:].expand(-1, need, -1)],
                           dim=1)
        row0 = min(row0, tables.shape[1] - need)
        tables = tables[:, row0:row0 + need]
    elif frames < blocks + 1:
        tables = torch.cat(
            [tables, tables[:, -1:].expand(-1, blocks + 1 - frames, -1)],
            dim=1)
    ph = F.pad(wrapped_phase, (0, blocks * hop - t)).reshape(b, blocks, hop)
    out = lookup_blocks(ph, tables.contiguous(), hop)
    return out.reshape(b, blocks * hop)[:, :t]


class GlottalFlowTable(OscillatorInterface):
    """Precomputed LF glottal pulse table over a log-spaced Rd grid. The
    table is a buffer unless ``trainable``."""

    def __init__(self, table_size: int = 100, table_type: str = "derivative",
                 normalize_method: Optional[str] = "constant_power",
                 align_peak: bool = True, trainable: bool = False,
                 min_R_d: float = 0.3, max_R_d: float = 2.7,
                 lf_v2: bool = False, points: int = 1000):
        super().__init__()
        table = torch.from_numpy(build_glottal_table(
            table_size=table_size, table_type=table_type,
            normalize_method=normalize_method, align_peak=align_peak,
            min_R_d=min_R_d, max_R_d=max_R_d, lf_v2=lf_v2, points=points))
        if trainable:
            self.table = nn.Parameter(table)
        else:
            self.register_buffer("table", table)

    def generate(self, wrapped_phase: Sig, tables: Sig) -> Sig:
        if wrapped_phase.hop != 1:
            raise ValueError("wrapped phase must be at hop 1")
        return Sig(_bilinear_table_lookup(wrapped_phase.data, tables.data,
                                          tables.hop), 1)

    def _interp_tables(self, weight: Sig) -> Sig:
        """Scalar index in [0, 1] -> linear mix of adjacent tables."""
        num_tables = self.table.shape[0]
        raw = weight.data * (num_tables - 1)
        floor = torch.clamp(raw.long(), 0, num_tables - 2)
        p = (raw - floor)[..., None]
        t0 = self.table[floor]
        t1 = self.table[floor + 1]
        return Sig(t0 * (1 - p) + t1 * p, weight.hop)


class IndexedGlottalFlowTable(GlottalFlowTable):
    """Scalar-index table lookup with optional oversampled integration."""

    def __init__(self, oversampling: int = 1, equal_energy: bool = False,
                 **kwargs):
        super().__init__(**kwargs)
        self.oversampling = oversampling
        self.equal_energy = equal_energy

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (1,)

    def ctrl(self, logits: Sig) -> Tuple[Sig, ...]:
        return (Sig(torch.sigmoid(logits.data), logits.hop),)

    def forward(self, phase: Sig, table_select_weight: Sig,
                phase_offset: Optional[Sig] = None) -> Sig:
        if table_select_weight.ndim != 2:
            raise ValueError("table_select_weight must be (B, frames)")
        env = seqpar.current()
        if env is not None:
            return self._forward_sharded(phase, table_select_weight,
                                         phase_offset, env)
        interp = self._interp_tables(table_select_weight)
        k = self.oversampling
        if k > 1:
            interp = Sig(interp.data, interp.hop * k)
            phase = Sig(phase.data / k, phase.hop * k)
        up_phase = phase.reduce_hop_length()
        wrapped = wrapped_cumsum(up_phase.data)
        if phase_offset is not None:
            wrapped = torch.remainder(wrapped + phase_offset.data, 1)
        y = self.generate(Sig(wrapped, 1), interp)
        if self.equal_energy:
            y = Sig(y.data * torch.rsqrt(up_phase.data), 1)
        if k > 1:
            y = Sig(decimate(y.data, k), 1)
        return y

    def out_len(self, n: int, *params: Sig) -> int:
        return n

    def _forward_sharded(self, phase: Sig, table_select_weight: Sig,
                         phase_offset: Optional[Sig], env) -> Sig:
        """This shard's source: the oversampled phase of its window
        (``upsample_local``), the global wrapped cumsum, the lookup against
        its rows of the replicated table frames (B1, or B3a with B3b, on
        the card), then the halo-exchanged decimation."""
        if phase_offset is not None:
            raise NotImplementedError("phase_offset is not time-sharded")
        if phase.hop != 1:
            raise ValueError("time sharding expects a sample-rate phase")
        interp = self._interp_tables(table_select_weight)   # global frames
        k = self.oversampling
        ph = seqpar.upsample_local(phase.data / k, k, env) if k > 1 \
            else phase.data
        wrapped = seqpar.global_wrapped_cumsum(ph, env)
        hop_os = interp.hop * k
        t_os_loc = ph.shape[1]
        if t_os_loc % hop_os:
            raise ValueError(f"T_local {t_os_loc} is not a multiple of the "
                             f"table hop {hop_os}")
        out = _bilinear_table_lookup(
            wrapped, interp.data, hop_os,
            row0=seqpar.tidx(env) * (t_os_loc // hop_os))
        if self.equal_energy:
            pos = ph > 0
            out = out * torch.where(
                pos, torch.rsqrt(torch.where(pos, ph, torch.ones_like(ph))),
                torch.zeros_like(ph))
        if k > 1:
            # zero the oversampled tail past the global (T - 1) k, then
            # decimate with halos
            gidx = seqpar.tidx(env) * t_os_loc + torch.arange(
                t_os_loc, device=out.device)
            out = torch.where(gidx <= (env.t_global - 1) * k, out,
                              torch.zeros_like(out))
            out = seqpar.decimate_sharded(out, k, env)
        return Sig(out, 1)


class WeightedGlottalFlowTable(GlottalFlowTable):
    """A softmax mix over all ``table_size`` tables a frame: the frame's
    table is ``weight @ table`` ((B, frames, table_size) x (table_size,
    points)), looked up at the wrapped cumsum of the phase (no
    oversampling)."""

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.table.shape[0],)

    def ctrl(self, logits: Sig) -> Tuple[Sig, ...]:
        return (Sig(torch.softmax(logits.data, dim=2), logits.hop),)

    def forward(self, phase: Sig, table_select_weight: Sig,
                phase_offset: Optional[Sig] = None) -> Sig:
        if table_select_weight.ndim != 3:
            raise ValueError("table_select_weight must be (B, frames, "
                             "table_size)")
        weighted = Sig(table_select_weight.data @ self.table,
                       table_select_weight.hop)
        wrapped = wrapped_cumsum(phase.reduce_hop_length().data)
        if phase_offset is not None:
            wrapped = torch.remainder(wrapped + phase_offset.data, 1)
        return self.generate(Sig(wrapped, 1), weighted)


class Downsampler(nn.Module):
    """AvgPool(hop_rate) -> Linear -> GLU -> Linear over (B, T, C)."""

    def __init__(self, hop_rate: int, in_channels: int, out_channels: int):
        super().__init__()
        self.hop_rate = hop_rate
        self.dense0 = nn.Linear(in_channels, in_channels * 2)
        self.dense1 = nn.Linear(in_channels, out_channels)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        k = self.hop_rate
        pad = k // 2
        hp = F.pad(h, (0, 0, pad, pad))
        frames = (hp.shape[1] - k) // k + 1
        pooled = hp[:, :frames * k].reshape(
            hp.shape[0], frames, k, hp.shape[-1]).mean(dim=2)
        a, b = self.dense0(pooled).chunk(2, dim=-1)
        return self.dense1(a * torch.sigmoid(b))


class DownsampledIndexedGlottalFlowTable(IndexedGlottalFlowTable):
    """Hidden frames -> downsampler -> scalar table index at a ``hop_rate``
    times coarser hop. Used by every GOLF config."""

    def __init__(self, hop_rate: int = 10, in_channels: int = 64, **kwargs):
        super().__init__(**kwargs)
        self.hop_rate = hop_rate
        self.in_channels = in_channels
        self.model = Downsampler(hop_rate, in_channels, 1)

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.in_channels,)

    def ctrl(self, h: Sig) -> Tuple[Sig, ...]:
        out = self.model(h.data)[..., 0]
        return (Sig(torch.sigmoid(out), h.hop * self.hop_rate),)


class WrappedPhaseDownsampledIndexedGlottalFlowTable(
        DownsampledIndexedGlottalFlowTable):
    """``DownsampledIndexedGlottalFlowTable`` on a phase already wrapped to
    [0, 1) at hop 1: no cumsum and no oversampling. It has no sharded
    branch."""

    out_len = Controllable.out_len

    def forward(self, wrapped_phase: Sig, table_select_weight: Sig,
                phase_offset: Optional[Sig] = None) -> Sig:
        return self.generate(wrapped_phase,
                             self._interp_tables(table_select_weight))


class DownsampledWeightedGlottalFlowTable(WeightedGlottalFlowTable):
    """Hidden frames -> ``Downsampler`` with ``table_size`` outputs ->
    softmax table weights at a ``hop_rate`` times coarser hop."""

    def __init__(self, hop_rate: int = 10, in_channels: int = 64, **kwargs):
        super().__init__(**kwargs)
        self.hop_rate = hop_rate
        self.in_channels = in_channels
        self.model = Downsampler(hop_rate, in_channels, self.table.shape[0])

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.in_channels,)

    def ctrl(self, h: Sig) -> Tuple[Sig, ...]:
        return (Sig(torch.softmax(self.model(h.data), dim=-1),
                    h.hop * self.hop_rate),)


class HarmonicOscillator(OscillatorInterface):
    """Additive sine bank with hard anti-aliasing: harmonic k of the phase
    is k times one wrapped cumsum of the base phase (exact mod 1 for an
    integer k), and its amplitude is zero where k times the phase
    increment reaches 0.5 cycles a sample. ``phase_offset`` (B, T) at hop
    1 adds k times itself to harmonic k, ``initial_phase`` (B, n) its own
    cycles to each harmonic. Plain PyTorch, as ``golf_tpu`` computes it
    outside any kernel. Time-sharded, the rank's phase window integrates by
    the global wrapped cumsum and frame-rate amplitudes are localized to
    the window."""

    def forward(self, phase: Sig, amplitudes: Sig,
                initial_phase: Optional[torch.Tensor] = None,
                phase_offset: Optional[Sig] = None) -> Sig:
        n_harm = amplitudes.shape[-1]
        env = seqpar.current()
        if env is not None:
            if initial_phase is not None or phase_offset is not None:
                raise NotImplementedError(
                    "initial_phase and phase_offset are not time-sharded")
            if phase.hop != 1:
                raise ValueError("time sharding expects a sample-rate phase")
            up_phase = phase
            base = seqpar.global_wrapped_cumsum(phase.data, env)
            if amplitudes.hop > 1:
                amplitudes = seqpar.localize(amplitudes, env, 1)
        else:
            up_phase = phase.reduce_hop_length()
            base = wrapped_cumsum(up_phase.data)
        harm_series = torch.arange(1, n_harm + 1, dtype=base.dtype,
                                   device=base.device)
        inst = base[..., None] * harm_series
        if phase_offset is not None:
            inst = inst + phase_offset.data[..., None] * harm_series
        if initial_phase is not None:
            init = initial_phase.data if isinstance(initial_phase, Sig) \
                else initial_phase
            inst = inst + init[:, None, :]
        harm_freq = up_phase.data[..., None] * harm_series
        amp = amplitudes.reduce_hop_length().truncate(base.shape[1])
        t = min(amp.steps, base.shape[1])
        amp_d = torch.where(harm_freq[:, :t] >= 0.5, 0.0, amp.data[:, :t])
        return Sig(torch.einsum("btn,btn->bt",
                                torch.sin(inst[:, :t] * (2 * math.pi)),
                                amp_d), 1)

    def out_len(self, n: int, *params: Sig) -> int:
        return bcast_len(n, params[0]) if params else n


def _num_freq_bins(phase: torch.Tensor) -> torch.Tensor:
    """``0.5 / phase`` as a true division on every device (PyTorch's
    ``0.5 / tensor`` is the reciprocal times 0.5)."""
    return torch.full((), 0.5, dtype=phase.dtype,
                      device=phase.device) / phase


class AdditiveSynthesizer(HarmonicOscillator):
    """DDSP's additive bank: amplitudes exp(log_gain) * sigmoid(logits),
    scaled by 1/sqrt(0.5 / phase), the count of harmonics below
    Nyquist."""

    def __init__(self, num_harmonics: int = 150):
        super().__init__()
        self.num_harmonics = num_harmonics

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (1, self.num_harmonics)

    def ctrl(self, log_gain: Sig, amp_logits: Sig) -> Tuple[Sig, ...]:
        amp = torch.exp(log_gain.data)[..., None] * \
            torch.sigmoid(amp_logits.data)
        return (Sig(amp, amp_logits.hop),)

    def forward(self, phase: Sig, amplitudes: Sig, **kwargs) -> Sig:
        env = seqpar.current()
        if env is not None and amplitudes.hop > 1:
            # the frame-rate amplitudes of the rank's window, before the
            # product with its sample-rate phase
            amplitudes = seqpar.localize(amplitudes, env, 1)
        amplitudes = amplitudes * Sig(
            torch.rsqrt(_num_freq_bins(phase.data)), phase.hop)
        return super().forward(phase, amplitudes, **kwargs)


class V1AdditiveSynthesizer(HarmonicOscillator):
    """The ISMIR23 variant: sigmoid amplitudes normalised to sum 1, times
    exp(log_gain)."""

    def __init__(self, num_harmonics: int = 150):
        super().__init__()
        self.num_harmonics = num_harmonics

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (1, self.num_harmonics)

    def ctrl(self, log_gain: Sig, amp_logits: Sig) -> Tuple[Sig, ...]:
        s = torch.sigmoid(amp_logits.data)
        s = s / torch.sum(s, dim=-1, keepdim=True)
        return (Sig(torch.exp(log_gain.data)[..., None] * s,
                    amp_logits.hop),)


class SawToothOscillator(HarmonicOscillator):
    """Fixed 1/k amplitudes (SawSing)."""

    def __init__(self, num_harmonics: int = 155, gain: float = 0.4):
        super().__init__()
        self.num_harmonics = num_harmonics
        self.gain = gain

    def forward(self, phase: Sig, initial_phase=None, phase_offset=None,
                **kwargs) -> Sig:
        d = phase.data
        amps = 1.0 / torch.arange(1, self.num_harmonics + 1, dtype=d.dtype,
                                  device=d.device)
        amplitudes = Sig(amps.expand(*d.shape, self.num_harmonics),
                         phase.hop)
        return super().forward(phase, amplitudes, initial_phase,
                               phase_offset)


class PulseTrain(OscillatorInterface):
    """An impulse of amplitude rsqrt(phase increment) at each wrap of the
    phase; none at the first sample."""

    def forward(self, phase: Sig, phase_offset: Optional[Sig] = None) -> Sig:
        env = seqpar.current()
        if env is not None:
            if phase_offset is not None:
                raise NotImplementedError("phase_offset is not time-sharded")
            if phase.hop != 1:
                raise ValueError("time sharding expects a sample-rate phase")
            up = phase.data
            wrapped = seqpar.global_wrapped_cumsum(up, env)
            # the previous sample from the left neighbour; shard 0's first
            # sees 0, no wrap, as the unsharded first sample has no pulse
            prev = torch.cat([seqpar.halo_left(wrapped, 1, env),
                              wrapped[:, :-1]], dim=1)
            return Sig(torch.where((wrapped - prev) < 0, torch.rsqrt(up),
                                   0.0), 1)
        up = phase.reduce_hop_length().data
        wrapped = wrapped_cumsum(up)
        if phase_offset is not None:
            wrapped = torch.remainder(wrapped + phase_offset.data, 1)
        transition = (wrapped[:, 1:] - wrapped[:, :-1]) < 0
        pulses = torch.where(transition, torch.rsqrt(up[:, 1:]), 0.0)
        return Sig(torch.cat([torch.zeros_like(up[:, :1]), pulses], dim=1),
                   1)

    def out_len(self, n: int, *params: Sig) -> int:
        return n


class AdditivePulseTrain(HarmonicOscillator):
    """Band-limited pulse train: an all-ones bank of ``num_harmonics``
    scaled by rsqrt(0.5 / phase), the source of the Interspeech24 baseline
    decoders (NHV, MLSA, WORLD). The (B, T, n) bank is materialised, as in
    ``golf_tpu``."""

    def __init__(self, num_harmonics: int = 155):
        super().__init__()
        self.num_harmonics = num_harmonics

    def forward(self, phase: Sig, initial_phase=None, phase_offset=None,
                **kwargs) -> Sig:
        amp = torch.rsqrt(_num_freq_bins(phase.data))[..., None]
        amplitudes = Sig(amp.expand(*phase.shape, self.num_harmonics),
                         phase.hop)
        return super().forward(phase, amplitudes, initial_phase,
                               phase_offset)
