"""Encoder interface (counterpart of ``golf_tpu.models.enc``): a backbone
with one zero-initialised linear head, sliced into named parameter groups;
and ``F0EnergyEncoder``, a backbone on the spectrogram's energy at the
harmonics and half-harmonics of f0.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.sig import Sig, true_divide
from ..ops import stft as stft_ops
from ..parallel.collectives import all_min_max
from ..parallel.mesh import current_data
from ..utils import profiling
from .ctrl import split_heads
from .rnn import BiLSTM

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


def check_mode(module: nn.Module, train: bool) -> None:
    """``golf_tpu`` drives dropout and the batch norms from ``train``, the
    port from the module's mode: the two must agree."""
    if train != module.training:
        raise ValueError(
            f"train={train} but the encoder is in "
            f"{'train' if module.training else 'eval'} mode; call "
            f".train() or .eval() to match")


def _running_minmax(mdl: nn.Module, value: torch.Tensor, train: bool,
                    prefix: str = "log_spec") -> torch.Tensor:
    """Normalise by running min/max buffers (``{prefix}_min``/``_max``,
    starting at +inf/-inf), updated only in train mode (with the min/max
    over the data group in a data-parallel step)."""
    vmin = getattr(mdl, f"{prefix}_min")
    vmax = getattr(mdl, f"{prefix}_max")
    if train:
        with torch.no_grad():
            shard = current_data()
            lo, hi = all_min_max(value, shard.group) if shard is not None \
                else (value.min(), value.max())
            vmin.copy_(torch.minimum(vmin, lo))
            vmax.copy_(torch.maximum(vmax, hi))
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
        """The raw parameter groups; the layer ``encoder`` of
        ``utils.profiling``, whose ``encoder.head`` (opened by a backbone
        that has one) ends with ``params_from_head``."""
        x, f0 = profiling.enter("encoder", (x, f0))
        params = self.params_from_head(self.backbone(x, f0=f0, train=train))
        return profiling.leave("encoder", profiling.leave("encoder.head",
                                                          params))

    def params_from_head(self, h: Sig) -> Dict[str, Any]:
        """The head's rows (B, T, channels) -> the named raw parameter
        groups, with f0 mapped into [f0_min, f0_max]; pointwise in time, so
        a streaming encoder maps its rows as they come."""
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


class F0EnergyEncoder(BackboneModelInterface):
    """The power spectrogram (its last bin zeroed) sampled at f0 / 2 and
    at k f0 / 2 for k = 2 .. 2 ``num_bands`` (the nearest bin, rounding
    half to even; unvoiced frames take the pitch sr / num_bands / 2), its
    log normalised by the running min/max buffers ``log_energy_min``/
    ``_max``, with log(f0) as one more feature -> BiLSTM -> LayerNorm ->
    the zero-initialised head; f0 is required."""

    def __init__(self, out_channels: int, sr: int = 24000, n_fft: int = 2048,
                 win_length: int = 960, window: str = "hanning",
                 hop_length: int = 240, num_bands: int = 150,
                 lstm_hidden_size: int = 128, num_layers: int = 1):
        super().__init__()
        self.sr = sr
        self.n_fft = n_fft
        self.win_length = win_length
        self.window = window
        self.hop_length = hop_length
        self.num_bands = num_bands
        self.lstm = BiLSTM(2 * num_bands + 1, lstm_hidden_size, num_layers)
        # flax LayerNorm's epsilon is 1e-6 (torch's default is 1e-5)
        self.norm = nn.LayerNorm(2 * lstm_hidden_size, eps=1e-6)
        self.out_linear = self.make_out_linear(2 * lstm_hidden_size,
                                               out_channels)
        self.register_buffer("log_energy_min", torch.tensor(float("inf")))
        self.register_buffer("log_energy_max", torch.tensor(float("-inf")))

    def features(self, x: Sig, f0: Sig, train: bool) -> torch.Tensor:
        """The LSTM's input (B, T, 2 num_bands + 1); in train mode this
        updates the running min/max."""
        if x.hop != 1:
            raise ValueError("the encoder takes a signal at hop 1")
        spec = stft_ops.spectrogram(x.data, self.n_fft, self.hop_length,
                                    self.win_length, self.window, power=2.0,
                                    center=True).transpose(1, 2)
        spec = torch.cat([spec[..., :-1], torch.zeros_like(spec[..., -1:])],
                         dim=-1)                       # (B, T, bins)
        f0_d = f0.set_hop_length(self.hop_length).truncate(
            spec.shape[1]).data
        spec = spec[:, :f0_d.shape[1]]
        f0_nz = torch.where(f0_d > 0, f0_d, f0_d.new_tensor(
            self.sr / self.num_bands * 0.5))
        ks = torch.arange(1, self.num_bands + 0.5, 0.5, dtype=f0_d.dtype,
                          device=f0_d.device)
        harms = f0_nz[..., None] * ks
        harms = torch.cat([harms[..., :1] * 0.5, harms], dim=-1)
        idx = torch.clamp(torch.round(true_divide(
            harms, self.sr / self.n_fft)).long(), 0, spec.shape[-1] - 1)
        energy = torch.gather(spec, 2, idx)
        feat = _running_minmax(self, torch.log(energy + 1e-8), train,
                               "log_energy")
        return torch.cat([feat, torch.log(f0_nz)[..., None]], dim=-1)

    def forward(self, x: Sig, f0: Optional[Sig] = None,
                train: bool = False) -> Sig:
        check_mode(self, train)
        h = self.norm(self.lstm(self.features(x, f0, train)))
        return Sig(self.out_linear(h), self.hop_length)
