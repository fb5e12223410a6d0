"""Time-varying and time-invariant synthesis filters (counterpart of the
GOLF part of ``golf_tpu.models.filters``).

* ``LTVMinimumPhaseFilterPrecise`` (GOLF-ss): sample-wise time-varying
  all-pole filter over the whole clip (``ops.allpole.allpole``).
* ``LTVMinimumPhaseFilter`` (GOLF-ff): constant-coefficient LPC per
  overlapping window (``ops.allpole.allpole_const``) + windowed overlap-add.
* ``LTVZeroPhaseFIRFilter``: frame-wise zero-phase FIR noise shaping by FFT.
* ``LTIAcousticFilter``: identity + strictly causal learned taps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.sig import Sig
from ..ops.allpole import allpole, allpole_const
from ..ops.dsp import get_window_fn, rc2lpc, unfold, zero_phase_fir
from ..ops.fftsize import conv_fft_size
from .ctrl import Controllable


class FilterInterface(Controllable):
    pass


class LTVFilterInterface(FilterInterface):
    pass


def _overlap_add(frames: torch.Tensor, window: torch.Tensor, hop: int,
                 padding: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed overlap-add with conv_transpose semantics: returns (signal,
    normalization), the latter the overlap-add of the window itself.
    frames: (B, F, W); output length (F-1)*hop - 2*padding + W."""
    b, f, w = frames.shape
    q = -(-w // hop)                       # strips per frame
    wpad = q * hop
    fr = F.pad(frames * window, (0, wpad - w)).reshape(b, f, q, hop)
    buf = frames.new_zeros((b, f + q, hop))
    for j in range(q):
        buf[:, j:j + f] += fr[:, :, j]
    full = buf.reshape(b, -1)[:, :(f - 1) * hop + w]

    wstrip = F.pad(window.expand(f, w), (0, wpad - w)).reshape(f, q, hop)
    nbuf = frames.new_zeros((f + q, hop))
    for j in range(q):
        nbuf[j:j + f] += wstrip[:, j]
    norm = nbuf.reshape(-1)[:(f - 1) * hop + w]
    if padding:
        full = full[:, padding:-padding]
        norm = norm[padding:-padding]
    return full, norm


def _fft_frame_conv(frames: torch.Tensor, kernels: torch.Tensor, hop: int,
                    correlate: bool) -> torch.Tensor:
    """Per-frame linear convolution (or correlation) by FFT. frames
    (B, F, L), kernels (B, F, K) -> (B, F, hop), the segment
    [K-1, K-1+hop) of the full convolution."""
    k = kernels.shape[-1]
    nfft = conv_fft_size(frames.shape[-1] + k - 1)
    kern = torch.flip(kernels, (-1,)) if correlate else kernels
    conv = torch.fft.irfft(torch.fft.rfft(frames, n=nfft)
                           * torch.fft.rfft(kern, n=nfft), n=nfft)
    return conv[..., k - 1:k - 1 + hop]


class LTVMinimumPhaseFilterPrecise(LTVFilterInterface):
    """Sample-wise time-varying all-pole filter (GOLF-ss).

    ctrl: (log_gain, lpc_logits) -> (exp(log_gain), LPC coefficients by
    ``rc2lpc(tanh(logits) * max_abs_value)``. The other parameterisations
    of ``golf_tpu`` are not ported yet.
    """

    def __init__(self, lpc_order: Optional[int] = None,
                 lpc_parameterisation: str = "rc2lpc",
                 max_abs_value: float = 1.0):
        super().__init__()
        if lpc_parameterisation != "rc2lpc":
            raise NotImplementedError(
                f"lpc_parameterisation {lpc_parameterisation!r} is not "
                f"ported; only 'rc2lpc' is")
        self.lpc_order = lpc_order
        self.lpc_parameterisation = lpc_parameterisation
        self.max_abs_value = max_abs_value

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return () if self.lpc_order is None else (1, self.lpc_order)

    def ctrl(self, log_gain: Sig, lpc_logits: Sig) -> Tuple[Sig, ...]:
        a = rc2lpc(torch.tanh(lpc_logits.data) * self.max_abs_value)
        return (Sig(torch.exp(log_gain.data), log_gain.hop),
                Sig(a, lpc_logits.hop))

    def forward(self, ex: Sig, gain: Sig, a: Sig) -> Sig:
        exg = ex * gain                       # hop-broadcast multiply
        a_up = a.reduce_hop_length()
        t = min(exg.steps, a_up.steps)
        return Sig(allpole(exg.data[:, :t].contiguous(),
                           a_up.data[:, :t].contiguous()), 1)


class LTVMinimumPhaseFilter(LTVMinimumPhaseFilterPrecise):
    """Frame-wise approximation (GOLF-ff): constant-coefficient LPC on each
    overlapping window, then windowed overlap-add."""

    def __init__(self, window: str = "hanning", window_length: int = 960,
                 centred: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.window_length = window_length
        self.centred = centred
        win = get_window_fn(window)(window_length)
        self.register_buffer("win", torch.tensor(win, dtype=torch.float32),
                             persistent=False)

    def forward(self, ex: Sig, gain: Sig, a: Sig) -> Sig:
        hop = gain.hop
        ws = self.window_length
        if ws < 2 * hop:
            raise ValueError(f"window {ws} < 2 * hop {hop}")
        padding = ws // 2
        exg = (ex if self.centred else Sig(ex.data[:, hop // 2:], 1)) * gain
        frames = unfold(F.pad(exg.data, (padding, padding)), ws, hop)
        f = min(frames.shape[1], a.steps)
        b = frames.shape[0]
        p = a.shape[-1]
        filtered = allpole_const(frames[:, :f].reshape(-1, ws).contiguous(),
                                 a.data[:, :f].reshape(-1, p).contiguous())
        y, norm = _overlap_add(filtered.reshape(b, f, ws), self.win, hop,
                               padding)
        y = y / norm
        if not self.centred:
            y = F.pad(y[:, None], (hop // 2, 0), mode="reflect")[:, 0]
        return Sig(y, 1)


class LTVZeroPhaseFIRFilter(LTVFilterInterface):
    """Frame-wise zero-phase FIR via FFT correlation; the noise filter of
    every shipped GOLF config."""

    def __init__(self, window: str = "hanning", n_mag: Optional[int] = None,
                 conv_method: str = "fft"):
        super().__init__()
        if conv_method != "fft":
            raise NotImplementedError(f"conv_method {conv_method!r}")
        self.window = window
        self.n_mag = n_mag

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.n_mag,) if self.n_mag else ()

    def ctrl(self, x: Sig) -> Tuple[Sig, ...]:
        return (x,)

    def forward(self, ex: Sig, log_mag: Sig) -> Sig:
        hop = log_mag.hop
        kernel = zero_phase_fir(log_mag.data)
        k = kernel.shape[-1]
        kernel = kernel * torch.as_tensor(get_window_fn(self.window)(k),
                                          dtype=kernel.dtype,
                                          device=kernel.device)
        padding = (k - 1) // 2
        frames = unfold(F.pad(ex.data, (padding, padding)), k + hop - 1, hop)
        f = min(frames.shape[1], kernel.shape[1])
        out = _fft_frame_conv(frames[:, :f], kernel[:, :f], hop,
                              correlate=True)
        return Sig(out.reshape(ex.shape[0], -1), 1)


class LTIAcousticFilter(FilterInterface):
    """Learnable LTI FIR: identity + strictly causal learned taps,
    ``out[n] = x[n] + sum_k kernel[k] x[n - L + 1 + k]`` over delays
    1..L-1, as one rfft/irfft convolution. The kernel starts at zero."""

    def __init__(self, length: int = 128, conv_method: str = "fft"):
        super().__init__()
        if conv_method != "fft":
            raise NotImplementedError(f"conv_method {conv_method!r}")
        self.length = length
        self.kernel = nn.Parameter(torch.zeros(length - 1))

    def forward(self, ex: Sig) -> Sig:
        x = ex.data
        t = x.shape[-1]
        l = self.length - 1
        nfft = 1 << (t + l - 1).bit_length()
        conv = torch.fft.irfft(
            torch.fft.rfft(x[:, :-1], n=nfft)
            * torch.fft.rfft(torch.flip(self.kernel, (0,)), n=nfft), n=nfft)
        out = F.pad(conv[:, :t - 1], (1, 0))
        return ex + Sig(out, 1)
