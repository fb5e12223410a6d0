"""DSP primitives (counterpart of ``golf_tpu.ops.dsp``)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import get_window as _scipy_get_window

PHASE_BLOCK = 240


def _mod1_scan(totals: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``(u + v) % 1`` along dim 1, log-depth
    (Hillis-Steele): every intermediate stays in [0, 2)."""
    out = totals
    n = totals.shape[1]
    shift = 1
    while shift < n:
        out = torch.cat(
            [out[:, :shift], torch.remainder(out[:, shift:]
                                             + out[:, :-shift], 1)], dim=1)
        shift *= 2
    return out


class _WrappedCumsum(torch.autograd.Function):
    """``golf_tpu``'s custom VJP (ops/dsp.py:60-72): d out_t / d x_s =
    1[s <= t] almost everywhere (the mod-1 wraps have unit slope), so the
    cotangent is the reversed inclusive cumsum."""

    @staticmethod
    def forward(ctx, x, block):
        b, t = x.shape
        nb = -(-t // block)
        xp = F.pad(x, (0, nb * block - t))
        # each block's running sum accumulates in float64 and is rounded
        # once a sample: what PyTorch's float32 cumsum does on the CPU (bit
        # for bit), and not on CUDA, where a block's float32 roundings
        # entered every later block's offset (3.5e-5 cycles after 6 s of
        # the 96 kHz oversampled phase on an H100; tools/stream_precision.py)
        local = torch.cumsum(xp.reshape(b, nb, block).double(),
                             dim=-1).to(x.dtype)
        off = _mod1_scan(torch.remainder(local[..., -1], 1))
        off_excl = torch.cat([torch.zeros_like(off[:, :1]), off[:, :-1]],
                             dim=1)
        out = torch.remainder(torch.remainder(local, 1)
                              + off_excl[..., None], 1)
        return out.reshape(b, nb * block)[:, :t]

    @staticmethod
    def backward(ctx, g):
        return reversed_cumsum(g), None


def reversed_cumsum(g: torch.Tensor) -> torch.Tensor:
    """``out_s = sum_{t >= s} g_t`` along dim 1, accumulated in float64 and
    rounded once a sample: what PyTorch's float32 cumsum does on the CPU
    (bit for bit), where on CUDA it accumulates in float32."""
    return torch.flip(torch.cumsum(torch.flip(g, (1,)).double(), dim=1),
                      (1,)).to(g.dtype)


def wrapped_cumsum(x: torch.Tensor, block: int = PHASE_BLOCK
                   ) -> torch.Tensor:
    """Inclusive cumsum of ``x`` along dim 1, reduced mod 1, with a rounding
    error that does not grow with the length.

    A plain ``cumsum(x) % 1`` carries ``ulp(cumsum[-1])`` of error, which at
    the oversampled lengths of a 6 s clip (576 000 samples) is audible once
    scaled by a harmonic index. Here each ``block`` of samples is summed
    locally (magnitude <= block/2 cycles) and the wrapped block totals are
    combined by a mod-1 scan, so the error stays ~ulp(block/2) +
    depth*ulp(2). Differentiable, with the reversed cumsum as its adjoint.
    """
    return _WrappedCumsum.apply(x, block)


def get_window_fn(window: str = "hann") -> Callable[[int], np.ndarray]:
    """Periodic windows for hann/hamming/blackman/bartlett (torch's
    default), scipy's symmetric ones otherwise."""
    torch_like = {"hann", "hanning", "hamming", "blackman", "bartlett"}

    def fn(n: int) -> np.ndarray:
        if n == 1:
            return np.ones(1)
        if window in torch_like:
            name = {"hanning": "hann"}.get(window, window)
            return _scipy_get_window(name, n, fftbins=True).astype(np.float64)
        return np.asarray(_scipy_get_window(window, n), dtype=np.float64)

    return fn


def unfold(x: torch.Tensor, size: int, step: int) -> torch.Tensor:
    """Sliding windows (..., T) -> (..., F, size), F = (T - size)//step + 1.
    A strided view: no copy."""
    return x.unfold(-1, size, step)


def rc2lpc(rc: torch.Tensor) -> torch.Tensor:
    """Reflection coefficients -> LPC by the step-up recursion. rc:
    (..., order) in (-1, 1); returns a1..ap of A(z) = 1 + sum a_i z^-i."""
    order = rc.shape[-1]
    if order == 1:
        return rc
    k0 = rc[..., :1]
    cur = torch.cat([torch.ones_like(k0), k0], dim=-1)
    for n in range(1, order):
        prev = torch.cat([cur, torch.zeros_like(k0)], dim=-1)
        cur = prev + rc[..., n:n + 1] * torch.flip(prev, (-1,))
    return cur[..., 1:]


def levinson(r: torch.Tensor, order: int) -> torch.Tensor:
    """Levinson-Durbin: autocorrelation (..., order+1) -> LPC [1, a1..ap],
    in r's dtype, the prediction error floored at 1e-9 in each reflection
    coefficient's division, the sums in ``golf_tpu``'s order."""
    a = [torch.ones_like(r[..., 0])] + [None] * order
    err = r[..., 0]
    for i in range(1, order + 1):
        acc = r[..., i]
        for j in range(1, i):
            acc = acc + a[j] * r[..., i - j]
        k = -acc / torch.clamp(err, min=1e-9)
        a = [a[0]] + [a[j] + k * a[i - j] for j in range(1, i)] + [k] \
            + a[i + 1:]
        err = err * (1 - k * k)
    return torch.stack(a, dim=-1)


def fir_filt(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Sample-wise time-varying causal FIR, ``h`` flipped against causally
    padded windows: ``y[n] = sum_k h[n, k] * x[n - (K-1) + k]``. x (B, T),
    h (B, T, K) -> (B, T). Up to 128 taps as K shifted slices of x,
    longer as a strided window view and one product, as ``golf_tpu``."""
    k = h.shape[-1]
    t = x.shape[1]
    xp = F.pad(x, (k - 1, 0))
    hf = torch.flip(h, (-1,))
    if k <= 128:
        y = hf[:, :, 0] * xp[:, :t]
        for j in range(1, k):
            y = y + hf[:, :, j] * xp[:, j:j + t]
        return y
    frames = unfold(xp, k, 1)[:, :t]              # (B, T, K)
    return torch.einsum("btk,btk->bt", frames, hf)


def hilbert(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """FFT analytic signal (scipy's semantics); complex from real. The
    one-sided mask is host numpy."""
    n = x.shape[dim]
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1:n // 2] = 2
    else:
        h[0] = 1
        h[1:(n + 1) // 2] = 2
    shape = [1] * x.ndim
    shape[dim] = n
    mask = torch.as_tensor(h, dtype=x.dtype, device=x.device).reshape(shape)
    return torch.fft.ifft(torch.fft.fft(x, dim=dim) * mask, dim=dim)


def mirror_spectrum(half: torch.Tensor) -> torch.Tensor:
    """Half spectrum (..., n//2+1) -> the even full spectrum (..., n)."""
    return torch.cat([half, torch.flip(half, (-1,))[..., 1:-1]], dim=-1)


def minimum_phase_spectrum(log_mag: torch.Tensor) -> torch.Tensor:
    """Full-spectrum log-magnitude -> the complex minimum-phase response
    ``exp(log_mag - i * imag(hilbert(log_mag)))``."""
    return torch.exp(torch.complex(log_mag, -hilbert(log_mag).imag))


def minimum_phase_fir(log_mag: torch.Tensor) -> torch.Tensor:
    """Half-spectrum log-magnitude frames -> minimum-phase FIR kernels of
    length n_fft: mirror the spectrum, the Hilbert transform for the phase,
    then an inverse FFT."""
    return torch.fft.ifft(minimum_phase_spectrum(mirror_spectrum(log_mag)),
                          dim=-1).real


def zero_phase_fir(log_mag: torch.Tensor) -> torch.Tensor:
    """Half-spectrum log-magnitude -> zero-phase (centred) FIR: irfft then
    fftshift."""
    fir = torch.fft.irfft(torch.exp(log_mag), dim=-1)
    return torch.fft.fftshift(fir, dim=-1)


def get_radiation_time_filter(num_zeros: int = 16,
                              window_fn: Callable[[int], np.ndarray] = None
                              ) -> np.ndarray:
    """The radiation (differentiator-like) FIR, host numpy, as
    ``golf_tpu``'s: ``(cos(pi t) - sinc(t)) / t`` over t in
    [-num_zeros, num_zeros], 0 at t = 0, optionally windowed."""
    t = np.arange(-num_zeros, num_zeros + 1)
    pi_t = t * np.pi
    tmp = np.cos(pi_t) - np.sinc(t)  # np.sinc(t) == sin(pi t)/(pi t)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = tmp / t
    out[num_zeros] = 0
    if window_fn is not None:
        out = out * window_fn(out.shape[0])
    return out


def freq2cent(f0):
    """Hz -> cents above A4 (host numpy, as ``golf_tpu``'s)."""
    return 1200 * np.log2(f0 / 440)
