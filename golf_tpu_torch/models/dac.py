"""DAC-24kHz encoder embedder (counterpart of ``golf_tpu.models.dac``),
the reference's default FAD embedding (``fad_torch.py --embedder dac``):
1024-d latents at 24 kHz over 5 s windows at 50 % overlap, each window
normalised to -16 LUFS.

The encoder is descript-audio-codec's (dac/model/dac.py), with its
``block.*`` Sequential layout and plain ``Conv1d``s whose weights are the
folded weight-norm kernels (``state_dict_from_dac`` folds a
``weights.pth``'s ``weight_g``/``weight_v`` pairs, or torch's parametrize
layout, as ``golf_tpu/models/dac.py:139-190`` does):

  Encoder = Conv1d(1, 64, k7 p3)
            -> EncoderBlock(128, s2) -> EncoderBlock(256, s4)
            -> EncoderBlock(512, s5) -> EncoderBlock(1024, s8)
            -> Snake1d -> Conv1d(1024, 1024, k3 p1)
  EncoderBlock(d, s) = ResidualUnit(d/2, dil 1, 3, 9) -> Snake1d
            -> Conv1d(d/2, d, k=2s, stride s, p=ceil(s/2))
  ResidualUnit(d, dil) = Snake1d -> Conv1d(d, d, k7, dil, p=3 dil)
            -> Snake1d -> Conv1d(d, d, k1); out = x[trim] + block(x)
  snake(x) = x + sin^2(alpha x) / (alpha + 1e-9)

Pretrained weights are not in the repository; ``random_state_dict`` gives
architecture-only weights. ``integrated_loudness`` and ``dac_windows`` are
host numpy, copied from ``golf_tpu``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device

SAMPLE_RATE = 24000
ENCODER_DIM = 64
ENCODER_RATES = (2, 4, 5, 8)
LATENT_DIM = ENCODER_DIM * 2 ** len(ENCODER_RATES)   # 1024
HOP = int(np.prod(ENCODER_RATES))                    # 320


class Snake1d(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + torch.sin(self.alpha * x) ** 2 / (self.alpha + 1e-9)


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.block = nn.Sequential(
            Snake1d(dim),
            nn.Conv1d(dim, dim, 7, dilation=dilation, padding=3 * dilation),
            Snake1d(dim), nn.Conv1d(dim, dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        pad = (x.shape[-1] - y.shape[-1]) // 2
        if pad > 0:
            x = x[..., pad:-pad]
        return x + y


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int):
        super().__init__()
        h = dim // 2
        self.block = nn.Sequential(
            ResidualUnit(h, 1), ResidualUnit(h, 3), ResidualUnit(h, 9),
            Snake1d(h), nn.Conv1d(h, dim, 2 * stride, stride=stride,
                                  padding=math.ceil(stride / 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class DACEncoder(nn.Module):
    """(B, 1, T) waveform -> (B, 1024, T // 320) latents."""

    def __init__(self, d_model: int = ENCODER_DIM,
                 strides: Sequence[int] = ENCODER_RATES,
                 d_latent: int = LATENT_DIM):
        super().__init__()
        block = [nn.Conv1d(1, d_model, 7, padding=3)]
        for s in strides:
            d_model *= 2
            block.append(EncoderBlock(d_model, s))
        block += [Snake1d(d_model), nn.Conv1d(d_model, d_latent, 3,
                                              padding=1)]
        self.block = nn.Sequential(*block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


# ---------------------------------------------------------------------------
# descript-audio-codec state dicts (weight-norm folding)
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


_WN = ((".weight_g", ".weight_v"),
       (".parametrizations.weight.original0",
        ".parametrizations.weight.original1"))


def state_dict_from_dac(sd: Dict) -> Dict[str, torch.Tensor]:
    """A descript-audio-codec state dict (the whole DAC, whose encoder's
    keys start with ``encoder.``, or the encoder alone) -> ``DACEncoder``'s
    state dict: each weight-norm pair folded, w = g v / ||v|| over (in, k)
    per output channel (in float32, as ``golf_tpu``), the other tensors as
    they are."""
    if any(k.startswith("encoder.") for k in sd):
        sd = {k[len("encoder."):]: v for k, v in sd.items()
              if k.startswith("encoder.")}
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        pair = next((p for p in _WN if key.endswith(p[1])), None)
        if pair is not None:
            prefix = key[:-len(pair[1])]
            g, v = _np(sd[prefix + pair[0]]), _np(value)
            norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
            out[prefix + ".weight"] = torch.from_numpy(
                g * v / np.maximum(norm, 1e-12))
        elif not any(key.endswith(p[0]) for p in _WN):
            out[key] = torch.from_numpy(_np(value).copy())
    return out


def random_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded architecture-only weights (PyTorch's default init)."""
    torch.manual_seed(seed)
    return DACEncoder().state_dict()


# ---------------------------------------------------------------------------
# fadtk DAC24k embedding protocol (host numpy, copied from golf_tpu)
# ---------------------------------------------------------------------------

def _k_weighting_coeffs(fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """ITU-R BS.1770-4 K-weighting as two biquads (pyloudnorm /
    audiotools coefficients): stage-1 spherical-head high shelf,
    stage-2 RLB high pass."""
    def shelf(G, Q, fc):
        A = 10.0 ** (G / 40.0)
        w0 = 2.0 * np.pi * fc / fs
        alpha = np.sin(w0) / (2.0 * Q)
        b = np.array([A * ((A + 1) + (A - 1) * np.cos(w0)
                           + 2 * np.sqrt(A) * alpha),
                      -2 * A * ((A - 1) + (A + 1) * np.cos(w0)),
                      A * ((A + 1) + (A - 1) * np.cos(w0)
                           - 2 * np.sqrt(A) * alpha)])
        a = np.array([(A + 1) - (A - 1) * np.cos(w0)
                      + 2 * np.sqrt(A) * alpha,
                      2 * ((A - 1) - (A + 1) * np.cos(w0)),
                      (A + 1) - (A - 1) * np.cos(w0)
                      - 2 * np.sqrt(A) * alpha])
        return b / a[0], a / a[0]

    def highpass(Q, fc):
        w0 = 2.0 * np.pi * fc / fs
        alpha = np.sin(w0) / (2.0 * Q)
        b = np.array([(1 + np.cos(w0)) / 2, -(1 + np.cos(w0)),
                      (1 + np.cos(w0)) / 2])
        a = np.array([1 + alpha, -2 * np.cos(w0), 1 - alpha])
        return b / a[0], a / a[0]

    b1, a1 = shelf(3.99984385397, 0.7071752369554196, 1681.974450955533)
    b2, a2 = highpass(0.5003270373238773, 38.13547087602444)
    return np.stack([b1, b2]), np.stack([a1, a2])


def integrated_loudness(wav: np.ndarray, sr: int) -> float:
    """BS.1770-4 gated integrated loudness (mono), pyloudnorm semantics:
    K-weighting, 400 ms blocks / 75 % overlap, -70 LUFS absolute gate,
    -10 LU relative gate."""
    from scipy.signal import lfilter

    x = np.asarray(wav, np.float64).reshape(-1)
    bs, as_ = _k_weighting_coeffs(sr)
    for b, a in zip(bs, as_):
        x = lfilter(b, a, x)
    block = int(0.4 * sr)
    step = int(0.1 * sr)
    if len(x) < block:
        x = np.pad(x, (0, block - len(x)))
    n = (len(x) - block) // step + 1
    starts = np.arange(n) * step
    ms = np.array([np.mean(x[s:s + block] ** 2) for s in starts])
    with np.errstate(divide="ignore"):
        lb = -0.691 + 10 * np.log10(np.maximum(ms, 1e-30))
    keep = lb > -70.0
    if not np.any(keep):
        return -70.0
    rel_thresh = -0.691 + 10 * np.log10(np.mean(ms[keep])) - 10.0
    keep = keep & (lb > rel_thresh)
    if not np.any(keep):
        return -70.0
    return float(-0.691 + 10 * np.log10(np.mean(ms[keep])))


def dac_windows(wav: np.ndarray, sr: int) -> np.ndarray:
    """fadtk DAC24k preprocessing (reference fad.py:36-54): resample to
    24 kHz, normalize to -16 LUFS, clamp peaks to 1, zero-pad to a
    multiple of the 5 s window, 50 %-overlap windows -> (n_win, W)."""
    wav = np.asarray(wav, np.float64).reshape(-1)
    if sr != SAMPLE_RATE:
        from math import gcd

        from scipy.signal import resample_poly
        g = gcd(sr, SAMPLE_RATE)
        wav = resample_poly(wav, SAMPLE_RATE // g, sr // g)
        sr = SAMPLE_RATE
    # audiotools normalize(-16) + ensure_max_of_audio()
    gain_db = -16.0 - max(integrated_loudness(wav, sr), -70.0)
    wav = wav * 10.0 ** (gain_db / 20.0)
    peak = np.abs(wav).max()
    if peak > 1.0:
        wav = wav / peak
    # win_len = ((5.0 * sr) // 4) * 4 samples (divisible by 4)
    win = int(((5.0 * sr) // 4) * 4)
    hop = win // 2
    dur = len(wav) / sr
    pad_len = int(math.ceil(dur / (win / sr)) * win)
    wav = np.pad(wav, (0, max(0, pad_len - len(wav))))
    starts = np.arange(0, len(wav) - win + 1, hop)
    return np.stack([wav[s:s + win] for s in starts]).astype(np.float32)


class DACEmbedder:
    """``embed(wav, sr) -> (n_frames, 1024)`` for ``fad_torch.py``: one
    window at a time through the encoder on ``device`` (CUDA unless
    ``"cpu"``)."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], device=None):
        self.device = resolve_device(device)
        self.model = DACEncoder()
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    def embed(self, wav: np.ndarray, sr: int) -> np.ndarray:
        embs = []
        with torch.inference_mode():
            for w in dac_windows(wav, sr):
                x = torch.from_numpy(w)[None, None].to(self.device)
                embs.append(self.model(x)[0].T.cpu().numpy())
        return np.concatenate(embs, axis=0)
