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


# ---------------------------------------------------------------------------
# Polynomial products and the biquad / LSP parameterisations
# (golf_tpu/ops/dsp.py:165-345): the same divide-and-conquer order and the
# same direct sums, so the rounding matches
# ---------------------------------------------------------------------------

def poly_product_pair(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Full convolution of coefficient arrays along the last dim by FFT:
    (..., n) and (..., m) -> (..., n + m - 1)."""
    out_len = c1.shape[-1] + c2.shape[-1] - 1
    n = 2 * out_len
    return torch.fft.irfft(torch.fft.rfft(c1, n=n) * torch.fft.rfft(c2, n=n),
                           n=n)[..., :out_len]


def _shifted_sum(terms, n_out: int) -> torch.Tensor:
    """sum_i terms[i] placed at offset i of a length-``n_out`` last axis,
    added in order from zero."""
    out = None
    for i, term in enumerate(terms):
        placed = F.pad(term, (i, n_out - i - term.shape[-1]))
        out = placed if out is None else out + placed
    return out


def _poly_product_pair_direct(c1: torch.Tensor, c2: torch.Tensor
                              ) -> torch.Tensor:
    """The direct full convolution: the outer product's anti-diagonals
    summed row by row, in row order."""
    n, m = c1.shape[-1], c2.shape[-1]
    outer = c1[..., :, None] * c2[..., None, :]
    return _shifted_sum([outer[..., i, :] for i in range(n)], n + m - 1)


def coeff_product(polynomials: torch.Tensor) -> torch.Tensor:
    """Product of N polynomials, (N, B, k) -> (B, (k - 1) N + 1): halves
    multiplied recursively, the shorter factor second, by direct
    convolution."""
    n = polynomials.shape[0]
    if n == 1:
        return polynomials[0]
    c1 = coeff_product(polynomials[n // 2:])
    c2 = coeff_product(polynomials[:n // 2])
    if c1.shape[-1] > c2.shape[-1]:
        c1, c2 = c2, c1
    return _poly_product_pair_direct(c2, c1)


def complex2biquads(roots: torch.Tensor) -> torch.Tensor:
    """Complex roots -> the sections [1, -2 Re r, |r|^2] of their conjugate
    pairs."""
    if not roots.is_complex():
        raise TypeError("complex2biquads takes complex roots")
    a1 = -2 * roots.real
    a2 = torch.abs(roots) ** 2
    return torch.stack([torch.ones_like(a1), a1, a2], dim=-1)


def params2biquads(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """A stable section [1, a1, a2] from two parameters in [-1, 1]."""
    a1 = 2 * p1
    a1_abs = torch.abs(a1)
    a2 = 0.5 * ((2 - a1_abs) * p2 + a1_abs)
    return torch.stack([torch.ones_like(a1), a1, a2], dim=-1)


def biquads2lpc(biquads: torch.Tensor) -> torch.Tensor:
    """(..., n_sections, 3) -> (..., 2 n_sections): the sections' product
    without its leading 1."""
    if biquads.shape[-1] != 3:
        raise ValueError(f"biquads must end in 3, got {tuple(biquads.shape)}")
    lead = biquads.shape[:-2]
    flat = biquads.reshape((-1,) + tuple(biquads.shape[-2:]))
    prod = coeff_product(flat.transpose(0, 1))
    return prod.reshape(tuple(lead) + (prod.shape[-1],))[..., 1:]


def get_logits2biquads(rep_type: str, max_abs_pole: float = 0.99
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Logits (..., 2) -> stable sections (..., 3): ``coef`` (the
    coefficients in the stability triangle), ``conj`` (a conjugate pair by
    magnitude and cosine) or ``real`` (two real roots)."""
    if rep_type == "coef":
        def f(logits):
            a1 = torch.tanh(logits[..., 0]) * max_abs_pole * 2
            a1_abs = torch.abs(a1)
            a2 = 0.5 * ((2 - a1_abs) * torch.tanh(logits[..., 1])
                        * max_abs_pole + a1_abs)
            return torch.stack([torch.ones_like(a1), a1, a2], dim=-1)
    elif rep_type == "conj":
        def f(logits):
            mag = torch.sigmoid(logits[..., 0]) * max_abs_pole
            cos = torch.tanh(logits[..., 1])
            return torch.stack([torch.ones_like(mag), -2 * mag * cos,
                                mag * mag], dim=-1)
    elif rep_type == "real":
        def f(logits):
            z1 = torch.tanh(logits[..., 0]) * max_abs_pole
            z2 = torch.tanh(logits[..., 1]) * max_abs_pole
            return torch.stack([torch.ones_like(z1), -z1 - z2, z1 * z2],
                               dim=-1)
    else:
        raise ValueError(f"Unknown rep_type: {rep_type}")
    return f


def _conv_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full 1-D convolution along the last axis (a polynomial product), the
    terms a * b_i added in order of i."""
    n, m = a.shape[-1], b.shape[-1]
    return _shifted_sum([a * b[..., i:i + 1] for i in range(m)], n + m - 1)


def lsp2lpc(lsp: torch.Tensor) -> torch.Tensor:
    """Line-spectral frequencies -> the LPC polynomial [1, a1..ap]. lsp
    (..., order + 1): element 0 (the gain slot) is ignored, elements
    1..order are the frequencies in (0, pi), ascending. Returns
    (..., order + 1). The odd-indexed frequencies make P, the even-indexed
    Q: P(z) = (1 - z^-1) prod, Q(z) = (1 + z^-1) prod at even order; P(z)
    = prod, Q(z) = (1 - z^-2) prod at odd order; A = (P + Q) / 2."""
    w = lsp[..., 1:]
    order = w.shape[-1]

    def poly_from_cos(ws):
        c = torch.cos(ws)
        bi = torch.stack([torch.ones_like(c), -2 * c, torch.ones_like(c)],
                         dim=-1)
        lead = bi.shape[:-2]
        if bi.shape[-2] == 0:
            return lsp.new_ones(tuple(lead) + (1,))
        flat = bi.reshape((-1,) + tuple(bi.shape[-2:]))
        prod = coeff_product(flat.transpose(0, 1))
        return prod.reshape(tuple(lead) + (prod.shape[-1],))

    p1 = poly_from_cos(w[..., ::2])
    p2 = poly_from_cos(w[..., 1::2])
    one = lsp.new_ones(p1.shape[:-1] + (1,))
    zero = torch.zeros_like(one)
    if order % 2 == 0:
        d1 = torch.cat([one, zero], -1) - torch.cat([zero, one], -1)
        d2 = torch.cat([one, zero], -1) + torch.cat([zero, one], -1)
        big_p = _conv_last(p1, d1)
        big_q = _conv_last(p2, d2)
    else:
        big_p = p1
        big_q = _conv_last(p2, torch.cat([one, zero, -one], -1))
    n = max(big_p.shape[-1], big_q.shape[-1])
    big_p = F.pad(big_p, (0, n - big_p.shape[-1]))
    big_q = F.pad(big_q, (0, n - big_q.shape[-1]))
    return (0.5 * (big_p + big_q))[..., :order + 1]


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


def smooth_phase_offset(phase_offset: torch.Tensor) -> torch.Tensor:
    """Unwrap phase-offset jumps into [-0.5, 0.5) increments along dim 1:
    the first offset, then the cumulative sum of ``(diff + 0.5) % 1 -
    0.5``. ``torch.remainder`` takes the divisor's sign, as ``jnp``'s
    ``%`` does, so a difference of -0.5 or 0.5 becomes -0.5 in both."""
    diffs = torch.remainder(torch.diff(phase_offset, dim=1) + 0.5, 1) - 0.5
    return torch.cumsum(torch.cat([phase_offset[:, :1], diffs], dim=1),
                        dim=1)


def freq2cent(f0):
    """Hz -> cents above A4 (host numpy, as ``golf_tpu``'s)."""
    return 1200 * np.log2(f0 / 440)
