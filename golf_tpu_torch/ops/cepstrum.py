"""Mel-cepstral analysis and synthesis, and the LPC <-> reflection
coefficient <-> log-area-ratio chain (counterpart of the ``freqt``,
``mcep``, ``mc2sp_log``, ``minimum_phase_response``, ``lpc2rc``,
``rc2lar``, ``lar2rc``, ``lpc_from_frames``, ``pqmf_filters`` and
``pqmf_analysis`` part of ``golf_tpu.ops.cepstrum``).

* ``freqt``: Oppenheim frequency transform (all-pass warping) of cepstra.
* ``mcep``: mel-cepstrum of amplitude-spectrum frames: the warped real
  cepstrum (SPTK's initial estimate), then optional Newton iterations with
  Levenberg damping on the mel log-spectral-approximation criterion.
* ``mc2sp_log``: mel-cepstrum -> log-magnitude half spectrum (the MLSA
  filters' transfer function), ``minimum_phase_response`` its complex
  minimum-phase response.
* ``lpc_from_frames``: windowed frames -> [gain, a1..ap] by the
  autocorrelation and ``levinson`` (LPCNet's ground-truth LPC);
  ``lpc2rc`` (step-down), ``rc2lar`` and ``lar2rc``.
* ``pqmf_filters``: the cosine-modulated (pseudo-QMF) analysis bank, host
  scipy; ``pqmf_analysis``: its non-decimated "same"-padded convolution.

The design-time matrices (``_freqt_matrix``, ``_warped_cos_basis``) and
the PQMF bank are host-side numpy, copied from ``golf_tpu``.
"""

from __future__ import annotations

from functools import lru_cache

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import firwin, kaiser_beta

from .dsp import levinson, minimum_phase_spectrum, mirror_spectrum


@lru_cache(maxsize=None)
def _freqt_matrix(in_order: int, out_order: int, alpha: float) -> np.ndarray:
    """Linear map implementing the Oppenheim recursion; (M1+1, M2+1)."""
    m1, m2 = in_order + 1, out_order + 1
    a = np.zeros((m1, m2))
    # run the recursion on unit vectors
    for i in range(m1):
        c = np.zeros(m1)
        c[i] = 1.0
        d = np.zeros(m2)
        for n in range(m1 - 1, -1, -1):
            prev = d.copy()
            d[0] = c[n] + alpha * prev[0]
            if m2 > 1:
                d[1] = (1 - alpha * alpha) * prev[0] + alpha * prev[1]
            for m in range(2, m2):
                d[m] = prev[m - 1] + alpha * (prev[m] - d[m - 1])
        a[i] = d
    return a


@lru_cache(maxsize=None)
def _warped_cos_basis(n_bins: int, cep_order: int,
                      alpha: float) -> np.ndarray:
    """phi_m(w) = cos(m * beta(w)) on the half-spectrum grid, where beta is
    the first-order all-pass warped frequency: the mel log-spectrum model is
    linear in the mel-cepstrum, S(w) = sum_m c_m phi_m(w). Returns
    (n_bins, cep_order+1)."""
    w = np.linspace(0.0, np.pi, n_bins)
    beta = w + 2.0 * np.arctan2(alpha * np.sin(w),
                                1.0 - alpha * np.cos(w))
    m = np.arange(cep_order + 1)
    return np.cos(beta[:, None] * m[None, :])


def freqt(c: torch.Tensor, out_order: int, alpha: float) -> torch.Tensor:
    """Frequency-transform cepstra along the last axis."""
    mat = torch.as_tensor(_freqt_matrix(c.shape[-1] - 1, out_order,
                                        float(alpha)),
                          dtype=c.dtype, device=c.device)
    return c @ mat


def mcep(amp_spec: torch.Tensor, cep_order: int, alpha: float = 0.0,
         eps: float = 1e-8, n_iter: int = 0) -> torch.Tensor:
    """Amplitude-spectrum frames (..., n_fft//2+1) -> mel-cepstrum
    (..., cep_order+1). ``n_iter`` Newton steps on E = mean[exp(R) - R - 1],
    R = 2(log|X| - S(c)), from the warped real cepstrum."""
    n_bins = amp_spec.shape[-1]
    n_fft = 2 * (n_bins - 1)
    log_mag = torch.log(torch.clamp(amp_spec, min=eps))
    c = torch.fft.ifft(mirror_spectrum(log_mag),
                       dim=-1).real            # real cepstrum, length n_fft
    half = n_fft // 2
    # one-sided cosine-series coefficients: log|X(w)| = c[0]
    # + 2 sum_{1<=m<half} c[m] cos(wm) + c[half] cos(w half)
    c0 = torch.cat([c[..., :1], 2.0 * c[..., 1:half], c[..., half:half + 1]],
                   dim=-1)
    mc = freqt(c0, cep_order, alpha)
    if n_iter <= 0:
        return mc

    phi = torch.as_tensor(_warped_cos_basis(n_bins, cep_order, float(alpha)),
                          dtype=log_mag.dtype, device=log_mag.device)
    # trapezoid quadrature weights over the half spectrum
    qw = torch.ones(n_bins, dtype=log_mag.dtype, device=log_mag.device)
    qw[0] = qw[-1] = 0.5
    eye = torch.eye(cep_order + 1, dtype=log_mag.dtype, device=log_mag.device)
    for _ in range(n_iter):
        s = mc @ phi.T
        er = torch.exp(torch.clamp(2.0 * (log_mag - s), -30.0, 30.0))
        grad = -2.0 * ((er - 1.0) * qw) @ phi
        hess = 4.0 * torch.einsum("...b,bm,bn->...mn", er * qw, phi, phi)
        # Levenberg damping keeps early steps stable far from the optimum
        hess = hess + 1e-4 * torch.diagonal(hess, dim1=-2, dim2=-1).sum(
            -1)[..., None, None] * eye
        mc = mc - torch.linalg.solve(hess, grad[..., None])[..., 0]
    return mc


def mc2sp_log(mc: torch.Tensor, n_fft: int, alpha: float = 0.0,
              lin_order: Optional[int] = None) -> torch.Tensor:
    """Mel-cepstrum -> log-magnitude half spectrum (..., n_fft//2+1): the
    unwarped cepstrum to ``lin_order`` (default n_fft//2), then a cosine
    matrix built in float32 as ``golf_tpu`` builds it."""
    if lin_order is None:
        lin_order = n_fft // 2
    c_lin = freqt(mc, lin_order, -alpha)
    m = torch.arange(c_lin.shape[-1], device=mc.device)
    w = torch.arange(n_fft // 2 + 1, dtype=torch.float32,
                     device=mc.device) * (2 * math.pi / n_fft)
    cos = torch.cos(w[:, None] * m[None, :]).to(c_lin.dtype)
    return c_lin @ cos.T


def minimum_phase_response(log_mag_half: torch.Tensor) -> torch.Tensor:
    """Half-spectrum log-magnitude -> the complex minimum-phase frequency
    response, one-sided."""
    n_bins = log_mag_half.shape[-1]
    return minimum_phase_spectrum(mirror_spectrum(log_mag_half))[
        ..., :n_bins]


def lpc2rc(a: torch.Tensor) -> torch.Tensor:
    """Step-down recursion: a1..ap -> reflection coefficients k1..kp, each
    division's denominator 1 - k^2 floored at 1e-9."""
    p = a.shape[-1]
    cur = a
    ks = []
    for n in range(p, 0, -1):
        k = cur[..., n - 1:n]
        ks.append(k)
        if n > 1:
            head = cur[..., :n - 1]
            cur = (head - k * torch.flip(head, (-1,))) / torch.clamp(
                1 - k * k, min=1e-9)
    return torch.cat(ks[::-1], dim=-1)


def rc2lar(k: torch.Tensor, clip: float = 0.999) -> torch.Tensor:
    """Reflection coefficients, clipped to +-clip, -> log area ratios."""
    k = torch.clamp(k, -clip, clip)
    return torch.log((1 + k) / (1 - k))


def lar2rc(g: torch.Tensor) -> torch.Tensor:
    return torch.tanh(g / 2)


def lpc_from_frames(frames: torch.Tensor, order: int,
                    window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frames (..., L) -> [gain, a1..ap] (diffsptk's LPC): window, the
    autocorrelation through a 2L-point FFT divided by L, Levinson, and the
    gain sqrt(max(prediction error, 1e-12))."""
    if window is not None:
        frames = frames * window
    length = frames.shape[-1]
    spec = torch.fft.rfft(frames, 2 * length, dim=-1)
    r = torch.fft.irfft(torch.abs(spec) ** 2, 2 * length,
                        dim=-1)[..., :order + 1] / length
    a = levinson(r, order)
    err = r[..., 0] + torch.sum(a[..., 1:] * r[..., 1:], dim=-1)
    gain = torch.sqrt(torch.clamp(err, min=1e-12))
    return torch.cat([gain[..., None], a[..., 1:]], dim=-1)


def pqmf_filters(n_bands: int, filter_order: int,
                 alpha: float = 100.0) -> np.ndarray:
    """Pseudo-QMF analysis filters (n_bands, filter_order + 1), float32: a
    Kaiser-windowed prototype low-pass at pi / (2 n_bands) (``alpha`` the
    stop-band attenuation in dB, 0 for no window), cosine-modulated."""
    taps = filter_order
    beta = kaiser_beta(alpha) if alpha > 0 else 0.0
    cutoff = 0.5 / n_bands
    proto = firwin(taps + 1, cutoff, window=("kaiser", beta))
    k = np.arange(taps + 1)
    filters = np.zeros((n_bands, taps + 1))
    for b in range(n_bands):
        phase = (-1) ** b * np.pi / 4
        filters[b] = 2 * proto * np.cos(
            (2 * b + 1) * np.pi / (2 * n_bands) * (k - taps / 2) + phase)
    return filters.astype(np.float32)


def pqmf_analysis(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """Non-decimated analysis x (B, T) -> (B, n_bands, T): each band the
    true convolution of x with its filter, "same"-padded ((taps - 1) // 2
    on the left); ``conv1d`` correlates, so the bank is flipped."""
    taps = filters.shape[-1]
    pad_l = (taps - 1) // 2
    xp = F.pad(x, (pad_l, taps - 1 - pad_l))[:, None]
    return F.conv1d(xp, torch.flip(filters, (-1,))[:, None])
