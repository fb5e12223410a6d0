"""Mel-cepstral analysis and synthesis (counterpart of the ``freqt``,
``mcep``, ``mc2sp_log`` and ``minimum_phase_response`` part of
``golf_tpu.ops.cepstrum``).

* ``freqt``: Oppenheim frequency transform (all-pass warping) of cepstra.
* ``mcep``: mel-cepstrum of amplitude-spectrum frames: the warped real
  cepstrum (SPTK's initial estimate), then optional Newton iterations with
  Levenberg damping on the mel log-spectral-approximation criterion.
* ``mc2sp_log``: mel-cepstrum -> log-magnitude half spectrum (the MLSA
  filters' transfer function), ``minimum_phase_response`` its complex
  minimum-phase response.

The design-time matrices (``_freqt_matrix``, ``_warped_cos_basis``) are
host-side numpy, copied from ``golf_tpu``.
"""

from __future__ import annotations

from functools import lru_cache

import math
from typing import Optional

import numpy as np
import torch

from .dsp import minimum_phase_spectrum, mirror_spectrum


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
