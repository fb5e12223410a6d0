"""Spectrogram conv-pyramid encoder, the Interspeech24 backbone
(counterpart of ``golf_tpu.models.unet``).

Spectrogram (or, with ``include_env_features``, the spectrogram and its
harmonic and noise envelopes, ``env_features``) -> log -> running min/max
-> stacked Conv2d/BN/ReLU/MaxPool frequency pyramid -> flatten -> BiLSTM
(or the ``LRUBlock``) -> LayerNorm -> zero-init head. Activations are NCHW
(batch, channels, freq, time); ``golf_tpu`` keeps NHWC, and its flatten
orders features as ``freq_idx * C + c``, so the pyramid's output is
permuted to (B, T, F, C) before the reshape.

``compute_dtype="bfloat16"`` runs the pyramid and the BiLSTM as
``golf_tpu`` does under it: the convolutions in bf16 on the fp32
parameters cast down, the batch norms as flax's ``BatchNorm(dtype=bf16)``
(statistics and normalisation in fp32, output rounded to bf16, running
statistics in fp32), the LSTM as ``rnn.fused_bilstm_layer``; the LRU
branch, the LayerNorm and the head stay fp32.

``UNetEncoderV2`` adds a learned embedding of a harmonic mask (the bins
within a quarter of a harmonic of f0) to the pyramid's input.
``TransformerEncoderBackbone`` replaces the pyramid by one strided conv
and four post-norm self-attention layers over frequency within each frame
(flax's ``MultiHeadDotProductAttention`` with its dropout mask shared by
every sequence and head), then a max-pool over frequency and the BiLSTM.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.sig import Sig, true_divide
from ..ops import stft as stft_ops
from ..ops.pyramid import pyramid_conv, pyramid_stage_eval
from ..ops.pyramid import strided_max as _strided_max
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import train_batch_norm
from ..utils import profiling
from .enc import BackboneModelInterface, _running_minmax, check_mode
from .lru import LRU
from .rnn import BiLSTM


class BatchNorm2d(nn.BatchNorm2d):
    """flax's ``BatchNorm`` in train mode: the running variance follows the
    biased batch variance (``nn.BatchNorm2d`` would take the unbiased one).
    In eval mode it is ``nn.BatchNorm2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return train_batch_norm(self, x)


def env_features(spec: torch.Tensor, f0_d: torch.Tensor, sample_rate: int,
                 n_fft: int, num_harmonics: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-local harmonic and noise envelope features: per frame, the
    power spectrum at the harmonic (k f0) and inter-harmonic ((k + 0.5) f0)
    bins, linearly remapped onto the FFT grid. spec (B, freq, T), already
    truncated to the f0 grid; f0_d (B, T). Returns feats (B, 3, freq, T) =
    [spec, harmonic envelope, noise envelope] and snr (B, 1, freq, T).
    Shared by the offline encoder and the stream."""
    spec_t = spec.transpose(1, 2)                      # (B, T, freq)
    intervals = sample_rate / n_fft
    freqs = torch.arange(n_fft // 2 + 1, device=spec.device,
                         dtype=spec.dtype) * intervals
    f0_full = torch.where(f0_d > 0, f0_d,
                          f0_d.new_tensor(sample_rate / 2
                                          / (num_harmonics - 1)))
    pickup = f0_full[..., None] * torch.arange(
        0.0, num_harmonics + 1, 0.5, device=spec.device, dtype=spec.dtype)
    # round half to even, as jnp.round
    idx = torch.clamp(torch.round(pickup / intervals).long(), 0,
                      spec_t.shape[2] - 1)
    energies = torch.gather(spec_t, 2, idx)
    harms_energy = energies[..., ::2]
    noise_energy = torch.cat([energies[..., :1], energies[..., 1::2]], -1)

    def interp(values, remap, noise):
        lo = torch.clamp(torch.floor(remap).long(), 0, num_harmonics - 2)
        p = remap - lo
        if noise:
            p = torch.where(lo == 0, (p - 0.5) * 2, p)
        p = torch.clamp(p, 0, 1)
        return ((1 - p) * torch.gather(values, 2, lo)
                + p * torch.gather(values, 2, lo + 1))

    harm_env = interp(harms_energy, freqs / f0_full[..., None], False)
    noise_env = interp(noise_energy, (freqs + f0_full[..., None] * 0.5)
                       / f0_full[..., None], True)
    harm_env = torch.maximum(harm_env, noise_env)
    feats = torch.stack([spec_t, harm_env, noise_env], dim=1)
    snr = (noise_env / (harm_env + noise_env + 1e-16)) * 2
    return feats.transpose(2, 3), snr[:, None].transpose(2, 3)


class ConvPyramid(nn.Module):
    """Conv2d((2s+1, 3)) + BN + ReLU + MaxPool((s, 1)) over frequency, in
    fp32 or (``dtype`` bf16) as ``golf_tpu``'s under a bf16 dtype.

    In fp32 each stage goes through ``ops.pyramid`` (on the card, the
    hand-written P1 kernels): in eval mode with no gradient the whole stage
    is ``pyramid_stage_eval``; otherwise the convolution is
    ``pyramid_conv``, then the batch norm (the training one in train
    mode), ReLU and the pool as torch ops. Other dtypes run the torch
    convolution."""

    def __init__(self, in_channels: int = 1,
                 channels: Sequence[int] = (16, 32, 64, 128),
                 strides: Sequence[int] = (4, 4, 4, 4),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.strides = tuple(strides)
        ins = (in_channels,) + tuple(channels[:-1])
        self.convs = nn.ModuleList(
            nn.Conv2d(i, o, kernel_size=(2 * s + 1, 3), padding=(s, 1))
            for i, o, s in zip(ins, channels, strides))
        # flax BatchNorm: eps 1e-5, running averages decay by 0.99
        self.norms = nn.ModuleList(
            BatchNorm2d(o, eps=1e-5, momentum=0.01) for o in channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if dt is not None:
            x = x.to(dt)
        fp32 = dt is None and x.dtype == torch.float32
        fused = fp32 and not self.training and not torch.is_grad_enabled()
        for conv, norm, s in zip(self.convs, self.norms, self.strides):
            if fused:
                x = pyramid_stage_eval(x.contiguous(), conv, norm, s)
                continue
            if fp32:
                x = norm(pyramid_conv(x.contiguous(), conv.weight, conv.bias))
            elif dt is None:
                x = norm(conv(x))
            else:
                # flax rounds the convolution to bf16, then adds the bias
                x = F.conv2d(x, conv.weight.to(dt), None, padding=conv.padding)
                x = norm((x + conv.bias.to(dt)[:, None, None]).float()).to(dt)
            x = _strided_max(F.relu(x), s, axis=2)
        return x


class LRUBlock(nn.Module):
    """Stacked LRU + MLP with a predicted carry-in state (``golf_tpu``'s
    ``LRUBlock``): a bias-free input projection, then per layer LayerNorm,
    ``zi`` from the last frame through ``zi_pred_re/im``, the LRU and an
    MLP (tanh-approximated GELU, as flax's ``nn.gelu``); no residual. The
    parameters carry ``golf_tpu``'s names (``dense{k}`` for ``Dense_k``)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0, mlp_factor: int = 4):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.dense0 = nn.Linear(input_size, hidden_size, bias=False)
        self.norms = nn.ModuleList(nn.LayerNorm(hidden_size, eps=1e-6)
                                   for _ in range(num_layers))
        for i in range(num_layers):
            for part in ("re", "im"):
                self.register_parameter(
                    f"zi_pred_{part}_{i}",
                    nn.Parameter(torch.zeros(hidden_size, hidden_size)))
            setattr(self, f"lru_{i}", LRU(hidden_size, hidden_size))
            setattr(self, f"dense{1 + 2 * i}",
                    nn.Linear(hidden_size, hidden_size * mlp_factor))
            setattr(self, f"dense{2 + 2 * i}",
                    nn.Linear(hidden_size * mlp_factor, hidden_size))

    def layer(self, i: int, h: torch.Tensor,
              zi: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer i over h (B, T, H) from the state ``zi`` (predicted from
        the last frame when None). Returns (output, the LRU's last
        state)."""
        hn = self.norms[i](h)
        if zi is None:
            zi = hn[:, -1].to(torch.complex64) @ torch.complex(
                getattr(self, f"zi_pred_re_{i}"),
                getattr(self, f"zi_pred_im_{i}"))
        y, last = getattr(self, f"lru_{i}")(hn, zi)
        ff = F.gelu(getattr(self, f"dense{1 + 2 * i}")(y), approximate="tanh")
        ff = getattr(self, f"dense{2 + 2 * i}")(ff)
        return F.dropout(ff, self.dropout, self.training), last

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dense0(x)
        for i in range(self.num_layers):
            h, _ = self.layer(i, h)
        return h


def _flat_rows(h: torch.Tensor) -> torch.Tensor:
    """(B, C, freq, T) -> (B, T, freq C), flattened as ``golf_tpu``'s NHWC
    (feature ``freq_idx * C + c``)."""
    b, c, fr, t = h.shape
    return h.permute(0, 3, 2, 1).reshape(b, t, fr * c)


class UNetEncoder(BackboneModelInterface):
    def __init__(self, out_channels: int, n_fft: int = 1024,
                 hop_length: int = 256,
                 channels: Sequence[int] = (16, 32, 64, 128),
                 strides: Sequence[int] = (4, 4, 4, 4),
                 lstm_hidden_size: int = 128, num_layers: int = 1,
                 dropout: float = 0.0, include_env_features: bool = False,
                 num_harmonics: int = 150, sample_rate: int = 22050,
                 f0_conditioning: bool = True, use_lru: bool = False,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.f0_conditioning = f0_conditioning
        self.include_env_features = include_env_features
        self.num_harmonics = num_harmonics
        self.sample_rate = sample_rate
        self.use_lru = use_lru
        # golf_tpu's compute_dtype: "bfloat16" or "bf16", else fp32
        self.dtype = torch.bfloat16 if compute_dtype in ("bfloat16", "bf16") \
            else None
        env = include_env_features and f0_conditioning
        # env features: spectrogram, two envelopes and the SNR
        self.pyramid = ConvPyramid(4 if env else 1, channels, strides,
                                   dtype=self.dtype)
        n_freq = n_fft // 2 + 1
        for s in strides:
            n_freq //= s
        lstm_in = n_freq * channels[-1] + (1 if f0_conditioning else 0)
        if use_lru:
            self.lru_block = LRUBlock(lstm_in, lstm_hidden_size, num_layers,
                                      dropout)
            width = lstm_hidden_size
        else:
            self.lstm = BiLSTM(lstm_in, lstm_hidden_size, num_layers, dropout,
                               dtype=self.dtype)
            width = 2 * lstm_hidden_size
        # flax LayerNorm's epsilon is 1e-6 (torch's default is 1e-5)
        self.norm = nn.LayerNorm(width, eps=1e-6)
        self.out_linear = self.make_out_linear(width, out_channels)
        self.register_buffer("log_spec_min", torch.tensor(float("inf")))
        self.register_buffer("log_spec_max", torch.tensor(float("-inf")))

    def features(self, x: Sig, f0: Optional[Sig], train: bool):
        """The pyramid's input (B, C, freq, T): the normalised log
        spectrogram (C = 1) or, with env features, the normalised log
        spectrogram and envelopes and the SNR (C = 4); and the frame-rate
        f0 (or None). In train mode this updates the running min/max."""
        if x.hop != 1:
            raise ValueError("the encoder takes a signal at hop 1")
        spec = stft_ops.spectrogram(x.data, self.n_fft, self.hop_length,
                                    power=2.0, center=True)
        f0_d = None
        if self.f0_conditioning:
            if f0 is None:
                raise ValueError("f0_conditioning needs f0")
            f0_d = f0.set_hop_length(self.hop_length).truncate(
                spec.shape[2]).data
            spec = spec[..., :f0_d.shape[-1]]
        snr = None
        if self.include_env_features and self.f0_conditioning:
            feats, snr = env_features(spec, f0_d, self.sample_rate,
                                      self.n_fft, self.num_harmonics)
        else:
            feats = spec[:, None]
        feature = _running_minmax(self, torch.log(feats + 1e-8), train)
        if snr is not None:
            feature = torch.cat([feature, snr], dim=1)
        return feature, f0_d

    def forward(self, x: Sig, f0: Optional[Sig] = None, train: bool = False
                ) -> Sig:
        """``train`` updates the running min/max; the batch norms and the
        recurrent stack's dropout follow the module's mode. ``golf_tpu``
        drives all three from ``train``, so the two must agree. The stages
        are the layers ``encoder.features``, ``encoder.pyramid``,
        ``encoder.lstm`` and ``encoder.head`` of ``utils.profiling``."""
        check_mode(self, train)
        feats = profiling.leave("encoder.features", self.features(
            *profiling.enter("encoder.features", (x, f0)), train))
        h = profiling.leave("encoder.pyramid", self.rows(
            *profiling.enter("encoder.pyramid", feats)))
        h = profiling.enter("encoder.lstm", h)
        if self.use_lru:
            h = self.lru_block(h.to(self.out_linear.weight.dtype))
        else:
            h = self.lstm(h)
        h = profiling.leave("encoder.lstm", h)
        return Sig(self.head(profiling.enter("encoder.head", h)),
                   self.hop_length)

    def rows(self, feature: torch.Tensor, f0_d: Optional[torch.Tensor]
             ) -> torch.Tensor:
        """The recurrent stack's input (B, T, freq' C [+ 1]): the conv
        pyramid's output flattened as ``golf_tpu`` does, and log1p(f0), in
        the compute dtype."""
        h = _flat_rows(self.pyramid(feature))
        if f0_d is not None:
            h = h[:, :f0_d.shape[-1]]
            h = torch.cat([h, torch.log1p(f0_d)[..., None].to(h.dtype)],
                          dim=-1)
        return h

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """LayerNorm and the output linear over the recurrent stack's
        output, in the parameters' dtype (fp32 under a bf16 compute
        dtype)."""
        return self.out_linear(self.norm(h.to(self.norm.weight.dtype)))


class UNetEncoderV2(BackboneModelInterface):
    """``UNetEncoder`` (without its options) whose pyramid also reads an
    ``embed_size`` embedding of the harmonic mask: bin k at frame t is in
    it when k sr / n_fft / f0 is above 0.75 and within 0.25 of an integer.
    f0 is required; the spectrogram is cut to its frames."""

    def __init__(self, out_channels: int, sr: int = 24000, embed_size: int = 8,
                 n_fft: int = 1024, hop_length: int = 256,
                 channels: Sequence[int] = (16, 32, 64, 128),
                 strides: Sequence[int] = (4, 4, 4, 4),
                 lstm_hidden_size: int = 128, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.sr = sr
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.embed = nn.Embedding(2, embed_size)
        self.pyramid = ConvPyramid(1 + embed_size, channels, strides)
        n_freq = n_fft // 2 + 1
        for s in strides:
            n_freq //= s
        self.lstm = BiLSTM(n_freq * channels[-1] + 1, lstm_hidden_size,
                           num_layers, dropout)
        self.norm = nn.LayerNorm(2 * lstm_hidden_size, eps=1e-6)
        self.out_linear = self.make_out_linear(2 * lstm_hidden_size,
                                               out_channels)
        self.register_buffer("log_spec_min", torch.tensor(float("inf")))
        self.register_buffer("log_spec_max", torch.tensor(float("-inf")))

    def features(self, x: Sig, f0: Sig, train: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The normalised log spectrogram (B, 1, freq, T) cut to the f0
        frames, and the frame-rate f0 (B, T); in train mode this updates
        the running min/max."""
        spec = stft_ops.spectrogram(x.data, self.n_fft, self.hop_length,
                                    power=2.0, center=True)
        feature = _running_minmax(self, torch.log(spec + 1e-8)[:, None],
                                  train)
        f0_d = f0.set_hop_length(self.hop_length).truncate(
            feature.shape[3]).data
        return feature[..., :f0_d.shape[1]], f0_d

    def harmonic_mask(self, n_freq: int, f0_d: torch.Tensor) -> torch.Tensor:
        """(B, freq, T) bool, in ``golf_tpu``'s order of operations: the
        bin's frequency (k sr, then divided by n_fft), over max(f0, 1e-6),
        then its fraction (exact in both)."""
        freqs = true_divide(
            (torch.arange(n_freq, device=f0_d.device) * self.sr).to(
                f0_d.dtype), self.n_fft)
        harms_index = freqs[None, :, None] / torch.clamp(
            f0_d[:, None, :], min=1e-6)
        frac = torch.remainder(harms_index, 1)
        return ((frac < 0.25) | (frac > 0.75)) & (harms_index > 0.75)

    def forward(self, x: Sig, f0: Optional[Sig] = None,
                train: bool = False) -> Sig:
        check_mode(self, train)
        feature, f0_d = self.features(x, f0, train)
        mask = self.harmonic_mask(feature.shape[2], f0_d)
        embed = self.embed(mask.long()).permute(0, 3, 1, 2)
        h = _flat_rows(self.pyramid(torch.cat([feature, embed], dim=1)))
        h = torch.cat([h, torch.log1p(f0_d)[..., None]], dim=-1)
        h = self.norm(self.lstm(h))
        return Sig(self.out_linear(h), self.hop_length * x.hop)


def sinusoidal(min_scale: float = 1.0, max_scale: float = 10000.0,
               shape: Tuple[int, int] = (512, 512)) -> np.ndarray:
    """1-D sinusoidal positional embedding (max_len, features), float32:
    sines in the first half of the features, cosines in the second (host
    numpy, copied from ``golf_tpu``)."""
    max_len, features = shape
    position = np.arange(max_len)[:, None]
    scale_factor = -math.log(max_scale / min_scale) / (features // 2 - 1)
    div_term = min_scale * np.exp(np.arange(features // 2) * scale_factor)
    rads = position * div_term
    pe = np.zeros((max_len, features), np.float32)
    pe[:, : features // 2] = np.sin(rads)
    pe[:, features // 2:] = np.cos(rads)
    return pe


# sequences of an attention layer's chunk: (1024, 4, 257, 257) fp32
# attention weights are 1.08 GB
ATTN_CHUNK = 1024


class AttentionLayer(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (``query``, ``key``,
    ``value`` and ``out`` projections with biases, the query divided by
    sqrt(head_dim)), then post-norm: LayerNorm(h + attention), a ReLU MLP
    of 4 c, LayerNorm(h + MLP)."""

    def __init__(self, channels: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.query, self.key, self.value, self.out = (
            nn.Linear(channels, channels) for _ in range(4))
        self.norm1 = nn.LayerNorm(channels, eps=1e-6)
        self.ff1 = nn.Linear(channels, 4 * channels)
        self.ff2 = nn.Linear(4 * channels, channels)
        self.norm2 = nn.LayerNorm(channels, eps=1e-6)

    def forward(self, h: torch.Tensor, keep: Optional[torch.Tensor],
                memory: Optional[torch.Tensor] = None) -> torch.Tensor:
        """h (N, L, c) the queries; the keys and values from ``memory``
        (N, S, c) when given (cross-attention, as flax's ``attn(x,
        memory)``), else from h; ``keep`` the (L, S) dropout multiplier
        (kept / keep probability) shared by all N sequences and heads, or
        None."""
        n, length, c = h.shape
        d = c // self.nhead
        kv = h if memory is None else memory

        def heads(proj, src):
            return proj(src).view(n, src.shape[1], self.nhead,
                                  d).transpose(1, 2)

        q = true_divide(heads(self.query, h), math.sqrt(d))
        w = torch.softmax(q @ heads(self.key, kv).transpose(-1, -2), dim=-1)
        if keep is not None:
            w = w * keep
        a = (w @ heads(self.value, kv)).transpose(1, 2).reshape(n, length, c)
        h = self.norm1(h + self.out(a))
        return self.norm2(h + self.ff2(F.relu(self.ff1(h))))


class TransformerEncoderBackbone(BackboneModelInterface):
    """The normalised log spectrogram -> Conv2d (``kernel_size``, stride
    ``stride`` over frequency) -> batch norm -> leaky ReLU (0.2) ->
    sinusoidal positions -> ``num_attn_layers`` ``AttentionLayer``s over
    the frequency tokens of each frame -> LayerNorm -> max-pool over
    frequency (``maxpool_stride``) -> with log1p(f0), BiLSTM -> LayerNorm ->
    the zero-initialised head. f0 is required. ``dropout`` drops attention
    weights (one (L, L) mask a layer, as flax's ``broadcast_dropout``) and
    the BiLSTM's inter-layer outputs.

    The attention runs ``ATTN_CHUNK`` sequences at a time, and when a
    gradient is needed each chunk's layers are recomputed in the backward
    (``torch.utils.checkpoint``): at B = 64 x 2 s of vctk the 12 864
    sequences' attention weights would take ~27 GB a layer to keep."""

    def __init__(self, out_channels: int, n_fft: int = 1024,
                 hop_length: int = 256, emb_channels: int = 32,
                 kernel_size: Sequence[int] = (5, 3), stride: int = 2,
                 maxpool_stride: int = 64, nhead: int = 4,
                 num_attn_layers: int = 4, lstm_hidden_size: int = 128,
                 dropout: float = 0.1, num_layers: int = 1):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.maxpool_stride = maxpool_stride
        self.dropout = dropout
        k1, k2 = kernel_size
        self.convs = nn.ModuleList([nn.Conv2d(
            1, emb_channels, (k1, k2), stride=(stride, 1),
            padding=(k1 // 2, k2 // 2))])
        self.norms = nn.ModuleList([BatchNorm2d(emb_channels, eps=1e-5,
                                                momentum=0.01)])
        n_freq = (n_fft // 2 + 1 + 2 * (k1 // 2) - k1) // stride + 1
        self.register_buffer("pe", torch.from_numpy(sinusoidal(
            shape=(n_freq, emb_channels))), persistent=False)
        self.layers = nn.ModuleList(AttentionLayer(emb_channels, nhead)
                                    for _ in range(num_attn_layers))
        self.final_norm = nn.LayerNorm(emb_channels, eps=1e-6)
        self.lstm = BiLSTM((n_freq // maxpool_stride) * emb_channels + 1,
                           lstm_hidden_size, num_layers, dropout)
        self.norm = nn.LayerNorm(2 * lstm_hidden_size, eps=1e-6)
        self.out_linear = self.make_out_linear(2 * lstm_hidden_size,
                                               out_channels)
        self.register_buffer("log_spec_min", torch.tensor(float("inf")))
        self.register_buffer("log_spec_max", torch.tensor(float("-inf")))

    def features(self, x: Sig, f0: Optional[Sig], train: bool
                 ) -> torch.Tensor:
        """The normalised log spectrogram (B, 1, freq, T); in train mode
        this updates the running min/max."""
        if x.hop != 1:
            raise ValueError("the encoder takes a signal at hop 1")
        spec = stft_ops.spectrogram(x.data, self.n_fft, self.hop_length,
                                    power=2.0, center=True)
        return _running_minmax(self, torch.log(spec + 1e-8)[:, None], train)

    def dropout_masks(self, length: int, device) -> List[Optional[torch.Tensor]]:
        """One (L, L) multiplier a layer in train mode with dropout, drawn
        from the default generator as the BiLSTM's dropout is; else None."""
        if not self.training or self.dropout <= 0:
            return [None] * len(self.layers)
        keep = 1.0 - self.dropout
        return [(torch.rand((length, length), device=device) < keep).float()
                / keep for _ in self.layers]

    def attend(self, h: torch.Tensor, *keeps) -> torch.Tensor:
        for layer, keep in zip(self.layers, keeps):
            h = layer(h, keep)
        return self.final_norm(h)

    def forward(self, x: Sig, f0: Optional[Sig] = None,
                train: bool = False) -> Sig:
        check_mode(self, train)
        feature = self.convs[0](self.features(x, f0, train))
        feature = F.leaky_relu(self.norms[0](feature), 0.2)
        b, c, fr, t = feature.shape
        h = feature.permute(0, 3, 2, 1).reshape(b * t, fr, c) + self.pe
        keeps = self.dropout_masks(fr, h.device)
        recompute = torch.is_grad_enabled() and h.requires_grad
        h = torch.cat([
            checkpoint(self.attend, part, *keeps, use_reentrant=False)
            if recompute else self.attend(part, *keeps)
            for part in h.split(ATTN_CHUNK)])
        h = _strided_max(h.reshape(b, t, fr, c), self.maxpool_stride, axis=2)
        h = h.reshape(b, t, -1)
        f0_d = f0.set_hop_length(self.hop_length).truncate(h.shape[1]).data
        h = torch.cat([h[:, :f0_d.shape[1]], torch.log1p(f0_d)[..., None]],
                      dim=-1)
        h = self.norm(self.lstm(h))
        return Sig(self.out_linear(h), self.hop_length)
