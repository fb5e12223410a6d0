"""STFT, spectrogram and mel spectrogram (counterpart of
``golf_tpu.ops.stft``): torchaudio ``Spectrogram`` semantics, center=True
with reflect padding, win_length = n_fft unless given, not normalized; the
mel filterbank is host numpy, copied from ``golf_tpu``."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .dsp import get_window_fn


def frame_signal(x: torch.Tensor, frame_length: int, hop: int,
                 center: bool = True, pad_mode: str = "reflect"
                 ) -> torch.Tensor:
    """(..., T) -> (..., F, frame_length), torch.stft framing."""
    if center:
        pad = frame_length // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=pad_mode)
        x = x.reshape(*lead, x.shape[-1])
    return x.unfold(-1, frame_length, hop)


def _padded_window(window: str, n_fft: int,
                   win_length: Optional[int]) -> np.ndarray:
    """The window of ``win_length`` centred in ``n_fft`` zeros (float64)."""
    win_length = win_length or n_fft
    w = np.zeros(n_fft)
    ofs = (n_fft - win_length) // 2
    w[ofs:ofs + win_length] = get_window_fn(window)(win_length)
    return w


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None, window: str = "hann",
         center: bool = True, onesided: bool = True,
         pad_mode: str = "reflect") -> torch.Tensor:
    """torch.stft-compatible. Returns complex (..., n_bins, n_frames)."""
    w = _padded_window(window, n_fft, win_length)
    frames = frame_signal(x, n_fft, hop_length, center, pad_mode)
    frames = frames * torch.as_tensor(w, dtype=x.dtype, device=x.device)
    if onesided:
        spec = torch.fft.rfft(frames, dim=-1)
    else:
        spec = torch.fft.fft(frames, dim=-1)
    return spec.transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          win_length: Optional[int] = None, window: str = "hann",
          center: bool = True, onesided: bool = True,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT with the window-square overlap-add normalisation
    (torch.istft semantics). spec: (..., n_bins, n_frames). The frames are
    added in strips of one hop; the normalisation does not depend on the
    data and is host numpy (float64, floored at 1e-11, cast to the frames'
    dtype: float32 in the models, as ``golf_tpu``'s)."""
    w = _padded_window(window, n_fft, win_length)
    frames_spec = spec.transpose(-1, -2)           # (..., F, n_bins)
    if onesided:
        frames = torch.fft.irfft(frames_spec, n=n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(frames_spec, dim=-1).real
    frames = frames * torch.as_tensor(w, dtype=frames.dtype,
                                      device=frames.device)

    n_frames = frames.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)
    lead = frames.shape[:-2]
    flat = frames.reshape(-1, n_frames, n_fft)
    q = -(-n_fft // hop_length)                    # strips per frame
    fr = F.pad(flat, (0, q * hop_length - n_fft)).reshape(
        -1, n_frames, q, hop_length)
    buf = fr.new_zeros((fr.shape[0], n_frames + q, hop_length))
    for j in range(q):
        buf[:, j:j + n_frames] += fr[:, :, j]
    y = buf.reshape(fr.shape[0], -1)[:, :out_len]

    wsq = np.zeros(out_len)
    for i in range(n_frames):
        wsq[i * hop_length:i * hop_length + n_fft] += w * w
    y = y / torch.as_tensor(np.maximum(wsq, 1e-11), dtype=y.dtype,
                            device=y.device)
    y = y.reshape(*lead, out_len)
    if center:
        y = y[..., n_fft // 2:out_len - n_fft // 2]
    if length is not None:
        y = y[..., :length]
    return y


def spectrogram(x: torch.Tensor, n_fft: int, hop_length: int,
                win_length: Optional[int] = None, window: str = "hann",
                power: Optional[float] = 2.0, center: bool = True,
                pad_mode: str = "reflect") -> torch.Tensor:
    """power=None returns complex; 1 magnitude; 2 power spectrum."""
    s = stft(x, n_fft, hop_length, win_length, window, center,
             pad_mode=pad_mode)
    if power is None:
        return s
    mag = torch.abs(s)
    if power == 1.0:
        return mag
    return mag ** power


def hz_to_mel(f, mel_scale: str = "htk"):
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def mel_to_hz(m, mel_scale: str = "htk"):
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sample_rate: int, norm: Optional[str] = None,
                    mel_scale: str = "htk") -> np.ndarray:
    """torchaudio.functional.melscale_fbanks equivalent: (n_freqs, n_mels),
    float64 inside, float32 out (host numpy, as in ``golf_tpu``)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min = hz_to_mel(f_min, mel_scale)
    m_max = hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])
        fb *= enorm[None, :]
    return fb.astype(np.float32)


def melspectrogram(x: torch.Tensor, sample_rate: int, n_fft: int,
                   hop_length: int, n_mels: int,
                   win_length: Optional[int] = None, window: str = "hann",
                   f_min: float = 0.0, f_max: Optional[float] = None,
                   power: float = 2.0, center: bool = True,
                   mel_scale: str = "htk") -> torch.Tensor:
    """torchaudio MelSpectrogram equivalent: (..., n_mels, F)."""
    f_max = f_max or sample_rate / 2
    spec = spectrogram(x, n_fft, hop_length, win_length, window, power,
                       center)
    fb = torch.from_numpy(melscale_fbanks(
        n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate,
        mel_scale=mel_scale)).to(spec)
    return torch.matmul(spec.transpose(-1, -2), fb).transpose(-1, -2)
