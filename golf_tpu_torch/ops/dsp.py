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


def zero_phase_fir(log_mag: torch.Tensor) -> torch.Tensor:
    """Half-spectrum log-magnitude -> zero-phase (centred) FIR: irfft then
    fftshift."""
    fir = torch.fft.irfft(torch.exp(log_mag), dim=-1)
    return torch.fft.fftshift(fir, dim=-1)


def freq2cent(f0):
    """Hz -> cents above A4 (host numpy, as ``golf_tpu``'s)."""
    return 1200 * np.log2(f0 / 440)
