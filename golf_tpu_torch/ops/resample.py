"""Anti-aliased decimation (counterpart of ``golf_tpu.ops.resample``), and
``resample_poly``, scipy's polyphase resampler on the device (the tools'
resampling: ``scripts/resample_dir_torch.py``, ``eval_pesq_torch.py``)."""

from __future__ import annotations

from math import gcd

import numpy as np
import torch
import torch.nn.functional as F

from .fftsize import conv_fft_size


def sinc_kernel(q: int, zeros: int = 56, roll_off: float = 0.945
                ) -> np.ndarray:
    """Kaiser-windowed sinc lowpass for decimation by q, cutoff
    ``roll_off * (sr/2q)``."""
    cutoff = roll_off * 0.5 / q
    half = int(zeros * q)
    t = np.arange(-half, half + 1, dtype=np.float64)
    beta = 14.769656459379492
    win = np.kaiser(2 * half + 1, beta)
    k = 2 * cutoff * np.sinc(2 * cutoff * t) * win
    return (k / k.sum()).astype(np.float32)


def _polyphase_taps(kernel: np.ndarray, q: int) -> np.ndarray:
    """(q, 2z+1) kernel phases k'_p[u] = k[qu - p] (zero outside)."""
    taps = kernel.shape[0]
    z = ((taps - 1) // 2) // q
    u = np.arange(2 * z + 1)
    kk = np.zeros((q, 2 * z + 1), np.float32)
    for p in range(q):
        idx = q * u - p
        valid = (idx >= 0) & (idx < taps)
        kk[p, valid] = kernel[idx[valid]]
    return kk


def decimate(x: torch.Tensor, q: int, kernel: np.ndarray | None = None
             ) -> torch.Tensor:
    """'Same'-padded lowpass then stride q: (B, T) -> (B, ceil(T/q)).

    Polyphase FFT form: x splits into its q phases x_p[v] = x[qv + p], each
    convolved with the matching kernel phase at the decimated rate, so
    out[m] = sum_p (x_p * k'_p)[m + Z] with Z = half/q.
    """
    if kernel is None:
        kernel = sinc_kernel(q)
    kern = np.asarray(kernel, np.float32)
    half = (kern.shape[0] - 1) // 2
    if half % q:
        raise ValueError(f"kernel half-width {half} is not a multiple of {q}")
    z = half // q
    t = x.shape[-1]
    out_len = -(-t // q)
    xp = torch.nn.functional.pad(x, (0, out_len * q - t))
    xp = xp.reshape(*x.shape[:-1], out_len, q).transpose(-1, -2)
    nfft = conv_fft_size(out_len + 2 * z)
    kk = torch.as_tensor(_polyphase_taps(kern, q), dtype=x.dtype,
                         device=x.device)
    xf = torch.fft.rfft(xp, n=nfft, dim=-1)            # (B, q, F)
    kf = torch.fft.rfft(kk, n=nfft, dim=-1)            # (q, F)
    conv = torch.fft.irfft(torch.sum(xf * kf, dim=-2), n=nfft, dim=-1)
    return conv[..., z:z + out_len]


def _output_len(len_h: int, in_len: int, up: int, down: int) -> int:
    return ((in_len - 1) * up + len_h - 1) // down + 1


def resample_poly(x: np.ndarray, up: int, down: int, device) -> np.ndarray:
    """``scipy.signal.resample_poly(x, up, down)`` for a 1-D signal, its
    upfirdn as one float64 ``conv1d`` on ``device``."""
    from scipy.signal import firwin

    g = gcd(up, down)
    up, down = up // g, down // g
    x = np.asarray(x, np.float64)
    if up == down == 1:
        return x.copy()
    n_in = x.shape[0]
    n_out = n_in * up // down + bool(n_in * up % down)
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate,
               window=("kaiser", 5.0)) * up
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while _output_len(len(h) + n_pre_pad + n_post_pad, n_in, up,
                      down) < n_out + n_pre_remove:
        n_post_pad += 1
    h = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    xt = torch.from_numpy(x).to(device)
    xu = xt.new_zeros((n_in - 1) * up + 1)
    xu[::up] = xt
    ht = torch.from_numpy(h[::-1].copy()).to(device)
    y = F.conv1d(xu[None, None], ht[None, None], padding=len(h) - 1)[0, 0]
    y = y[::down][n_pre_remove:n_pre_remove + n_out]
    return y.cpu().numpy()
