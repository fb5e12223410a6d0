"""Glottal-flow wavetable sources (counterpart of ``golf_tpu.models.synth``).

The oscillator integrates a normalized-frequency phase (f0/sr) in fp32 with
the wrapped cumsum, optionally at an oversampled rate, looks the wrapped
phase up in a per-frame blend of LF glottal-pulse tables, and decimates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.sig import Sig
from ..ops.dsp import wrapped_cumsum
from ..ops.lf import build_glottal_table
from ..ops.lookup import lookup_blocks
from ..ops.resample import decimate
from .ctrl import Controllable


class OscillatorInterface(Controllable):
    pass


def _bilinear_table_lookup(wrapped_phase: torch.Tensor, tables: torch.Tensor,
                           hop: int) -> torch.Tensor:
    """wrapped_phase: (B, T) in [0, 1); tables: (B, frames, S) at frame hop
    ``hop``. Every block of ``hop`` samples interpolates between the same
    two table rows, so time is reshaped to (blocks, hop). Returns (B, T)."""
    b, t = wrapped_phase.shape
    blocks = (t + hop - 1) // hop
    frames = tables.shape[1]
    if frames < blocks + 1:
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
        interp = self._interp_tables(table_select_weight)
        k = self.oversampling
        if k > 1:
            interp = Sig(interp.data, interp.hop * k)
            phase = Sig(phase.data / k, phase.hop * k)
        up_phase = phase.reduce_hop_length()
        wrapped = wrapped_cumsum(up_phase.data.float())
        if phase_offset is not None:
            wrapped = torch.remainder(wrapped + phase_offset.data, 1)
        y = self.generate(Sig(wrapped, 1), interp)
        if self.equal_energy:
            y = Sig(y.data * torch.rsqrt(up_phase.data), 1)
        if k > 1:
            y = Sig(decimate(y.data, k), 1)
        return y


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
