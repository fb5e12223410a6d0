"""Time-varying and time-invariant synthesis filters (counterpart of
``golf_tpu.models.filters``).

* ``LTVMinimumPhaseFilterPrecise`` (GOLF-ss): sample-wise time-varying
  all-pole filter over the whole clip (``ops.allpole.allpole``).
* ``LTVMinimumPhaseFilter`` (GOLF-ff): constant-coefficient LPC per
  overlapping window (``ops.allpole.allpole_const``) + windowed overlap-add.
* ``LTVZeroPhaseFIRFilter``: frame-wise zero-phase FIR noise shaping by FFT;
  ``LTVZeroPhaseFIRFilterPrecise`` its sample-wise twin (GOLF-fs),
  ``LTVAPZeroPhaseFIRFilter`` its aperiodicity variant.
* ``LTVMinimumPhaseFIRFilter`` and its ``Precise`` twin: minimum-phase FIR
  from log-magnitude frames, frame-wise by FFT or sample-wise.
* ``LTVPQMF``: a PQMF analysis bank with a gain a band, summed.
* ``LTIAcousticFilter``: identity + strictly causal learned taps;
  ``LTIRadiationFilter``: the fixed 33-tap radiation FIR;
  ``LTIComplexConjAllpassFilter`` and ``LTIRealCoeffAllpassFilter``:
  learned allpass filters, ``lfilter`` (B2 on the card) on the whole clip.
* The Interspeech24 baselines' spectral filters, all by (inverse) STFT:
  ``LTVCepFilter`` (NHV's harmonic filter), ``LTVMLSAFilter`` (MLSA,
  ``freq-domain`` or the ``multi-stage`` Taylor cascade), its variants
  ``LTVMLSAFilter2`` and ``LTVAPFilter``, and ``DiffWorldSPFilter``
  (∇WORLD).

Under time sharding (``parallel.seqpar``) ``LTVMinimumPhaseFilterPrecise``,
``LTVMinimumPhaseFilter``, the frame-wise FIR filters, ``LTVPQMF``,
``LTIAcousticFilter`` and the spectral filters run on the rank's window with
their boundary exchanges (``stft_filter_sharded`` for the spectral ones);
the sample-wise FIRs, the radiation filter and the allpass filters have no
sharded branch, as in ``golf_tpu``. The filters with one have ``out_len``,
the steps of their unsharded output; on the others it raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.sig import Sig, bcast_len
from ..ops import stft as stft_ops
from ..ops.allpole import allpole, allpole_const, lfilter
from ..ops.cepstrum import (freqt, mc2sp_log, mcep, minimum_phase_response,
                            pqmf_analysis, pqmf_filters)
from ..ops.dsp import (biquads2lpc, coeff_product, complex2biquads,
                       fir_filt, get_logits2biquads,
                       get_radiation_time_filter, get_window_fn, lsp2lpc,
                       minimum_phase_fir, minimum_phase_spectrum,
                       params2biquads, rc2lpc, unfold, zero_phase_fir)
from ..ops.fftsize import conv_fft_size
from ..parallel import seqpar
from .ctrl import Controllable


class FilterInterface(Controllable):
    pass


class LTVFilterInterface(FilterInterface):
    def reverse(self, ex: Sig, y: Sig, *params):
        """The inverse (excitation-domain) mode: ``ex`` scaled as the
        forward scales it, and ``y`` run through the inverse filter."""
        raise NotImplementedError


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


def _stft_filter_sharded(env, x: torch.Tensor, h: torch.Tensor, n_fft: int,
                         hop: int, window: str, ctrl_frames: int,
                         onesided: bool) -> torch.Tensor:
    """``seqpar.stft_filter_sharded`` on the unsharded input's length and
    its ``min(spectrum frames, ctrl frames)``."""
    n_in = env.in_len or env.t_global
    return seqpar.stft_filter_sharded(
        x, h, n_fft, hop, window, env, onesided=onesided, n_in=n_in,
        n_frames=min(_stft_frames(n_in, n_fft, hop, True), ctrl_frames))


def _stft_frames(n: int, n_fft: int, hop: int, center: bool) -> int:
    """Frames of ``ops.stft.stft`` on n samples."""
    return (n + (2 * (n_fft // 2) if center else 0) - n_fft) // hop + 1


def _istft_len(frames: int, n_fft: int, hop: int, center: bool,
               length: Optional[int] = None) -> int:
    """Samples of ``ops.stft.istft`` of ``frames`` frames."""
    n = n_fft + hop * (frames - 1) - (2 * (n_fft // 2) if center else 0)
    return n if length is None else min(n, length)


class LTVMinimumPhaseFilterPrecise(LTVFilterInterface):
    """Sample-wise time-varying all-pole filter (GOLF-ss).

    ctrl: (log_gain, lpc_logits) -> (exp(log_gain), LPC coefficients) by
    one of five stable parameterisations (``_logits2lpc``): ``rc2lpc``
    (reflection coefficients), the biquad cascades ``coef``, ``conj`` and
    ``real`` (two logits a section), and ``lsp2lpc`` (line spectral
    frequencies from a softmax over order + 1 logits).
    """

    PARAMETERISATIONS = ("rc2lpc", "coef", "conj", "real", "lsp2lpc")

    def __init__(self, lpc_order: Optional[int] = None,
                 lpc_parameterisation: str = "rc2lpc",
                 max_abs_value: float = 1.0):
        super().__init__()
        if lpc_parameterisation not in self.PARAMETERISATIONS:
            raise ValueError(
                f"Unknown lpc_parameterisation: {lpc_parameterisation}")
        self.lpc_order = lpc_order
        self.lpc_parameterisation = lpc_parameterisation
        self.max_abs_value = max_abs_value

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        if self.lpc_order is None:
            return ()
        return (1, self.lpc_order
                + (1 if self.lpc_parameterisation == "lsp2lpc" else 0))

    def _logits2lpc(self, logits: torch.Tensor) -> torch.Tensor:
        rep = self.lpc_parameterisation
        if rep in ("coef", "conj", "real"):
            l2b = get_logits2biquads(rep, self.max_abs_value)
            return biquads2lpc(l2b(logits.reshape(*logits.shape[:-1], -1,
                                                  2)))
        if rep == "rc2lpc":
            return rc2lpc(torch.tanh(logits) * self.max_abs_value)
        w = torch.cumsum(torch.softmax(logits, -1), -1)
        return lsp2lpc(torch.roll(w, 1, -1) * math.pi)[..., 1:]

    def ctrl(self, log_gain: Sig, lpc_logits: Sig) -> Tuple[Sig, ...]:
        return (Sig(torch.exp(log_gain.data), log_gain.hop),
                Sig(self._logits2lpc(lpc_logits.data), lpc_logits.hop))

    def forward(self, ex: Sig, gain: Sig, a: Sig) -> Sig:
        env = seqpar.current()
        if env is not None:
            # time-sharded: the gain and coefficients of this rank's window,
            # then the filter with the affine-summary boundary exchange
            g = seqpar.localize(gain, env, 1) if gain.hop > 1 else gain
            a_loc = seqpar.localize(a, env, 1) if a.hop > 1 else a
            return Sig(seqpar.allpole_sharded(ex.data * g.data, a_loc.data,
                                              env), 1)
        exg = ex * gain                       # hop-broadcast multiply
        a_up = a.reduce_hop_length()
        t = min(exg.steps, a_up.steps)
        return Sig(allpole(exg.data[:, :t].contiguous(),
                           a_up.data[:, :t].contiguous()), 1)

    def out_len(self, n: int, gain: Sig, a: Sig) -> int:
        return bcast_len(bcast_len(n, gain), a)

    def reverse(self, ex: Sig, y: Sig, gain: Sig, a: Sig
                ) -> Tuple[Sig, Sig]:
        """(ex * gain, y through the FIR [1, a] of every sample): the
        target in the excitation domain. Inherited by GOLF-ff, whose
        inverse is sample-wise too, as in ``golf_tpu``."""
        a_up = a.reduce_hop_length().data
        fir = torch.cat([torch.ones_like(a_up[..., :1]), a_up], dim=-1)
        t = min(y.steps, fir.shape[1])
        return ex * gain, Sig(fir_filt(y.data[:, :t], fir[:, :t]), 1)


class LTVMinimumPhaseFilter(LTVMinimumPhaseFilterPrecise):
    """Frame-wise approximation (GOLF-ff): constant-coefficient LPC on each
    overlapping window, then windowed overlap-add."""

    def __init__(self, window: str = "hanning", window_length: int = 960,
                 centred: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.window = window
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
        env = seqpar.current()
        if env is not None:
            return Sig(self._forward_sharded(ex, gain, a, env), 1)
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


    def _forward_sharded(self, ex: Sig, gain: Sig, a: Sig, env
                         ) -> torch.Tensor:
        """This rank's frames (B2 on the card) and the overlap-add with its
        neighbours' spilled edges (``seqpar.frame_ola_sharded``)."""
        if not self.centred:
            raise ValueError("the time-sharded GOLF-ff filter needs centred")
        exg = ex.data * seqpar.localize(gain, env, 1).data
        a_l = seqpar.localize_frames(a, env).data          # (B, F_loc, p)
        p = a_l.shape[-1]

        def per_frame(frames):
            b, f, w = frames.shape
            out = allpole_const(frames.reshape(-1, w).contiguous(),
                                a_l.reshape(-1, p).contiguous())
            return out.reshape(b, f, w)

        return seqpar.frame_ola_sharded(
            per_frame, exg, get_window_fn(self.window)(self.window_length),
            gain.hop, env)

    def out_len(self, n: int, gain: Sig, a: Sig) -> int:
        hop, ws = gain.hop, self.window_length
        pad = ws // 2
        exg = bcast_len(n if self.centred else n - hop // 2, gain)
        f = min((exg + 2 * pad - ws) // hop + 1, a.steps)
        out = (f - 1) * hop + ws - 2 * pad
        return out if self.centred else out + hop // 2


class SampleBasedLTVMinimumPhaseFilter(LTVMinimumPhaseFilterPrecise):
    """Deprecated alias of ``LTVMinimumPhaseFilterPrecise``, kept for
    configs and checkpoints."""


class LTVMinimumPhaseFIRFilterPrecise(LTVFilterInterface):
    """Sample-wise minimum-phase FIR: the kernel of every frame (its
    window's first half set to 1), linearly upsampled to every sample and
    applied causally (``fir_filt``)."""

    def __init__(self, window: str = "hanning", n_mag: Optional[int] = None):
        super().__init__()
        self.window = window
        self.n_mag = n_mag

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.n_mag,) if self.n_mag else ()

    def ctrl(self, x: Sig) -> Tuple[Sig, ...]:
        return (x,)

    def _window_kernel(self, kernel: torch.Tensor) -> torch.Tensor:
        k = kernel.shape[-1]
        w = np.asarray(get_window_fn(self.window)(k))
        w[:k // 2] = 1.0
        return kernel * torch.as_tensor(w, dtype=kernel.dtype,
                                        device=kernel.device)

    def forward(self, ex: Sig, log_mag: Sig) -> Sig:
        kernel = self._window_kernel(minimum_phase_fir(log_mag.data))
        up = Sig(kernel, log_mag.hop).reduce_hop_length()
        t = min(ex.steps, up.steps)
        return Sig(fir_filt(ex.data[:, :t], up.data[:, :t]), 1)


class LTVMinimumPhaseFIRFilter(LTVMinimumPhaseFIRFilterPrecise):
    """Frame-wise minimum-phase FIR: causal padding, then one FFT
    convolution a frame. ``conv_method`` is kept and not read: every value
    runs the FFT convolution, as in ``golf_tpu``."""

    def __init__(self, window: str = "hanning", n_mag: Optional[int] = None,
                 conv_method: str = "fft"):
        super().__init__(window, n_mag)
        self.conv_method = conv_method

    def forward(self, ex: Sig, log_mag: Sig) -> Sig:
        hop = log_mag.hop
        kernel = self._window_kernel(minimum_phase_fir(log_mag.data))
        k = kernel.shape[-1]
        env = seqpar.current()
        if env is not None:
            # causal: a left halo of K - 1 samples, the rank's frame rows
            kl = seqpar.localize_frames(Sig(kernel, hop), env)
            return Sig(seqpar.fir_frame_conv_sharded(
                ex.data, kl.data, hop, k - 1, False, env), 1)
        frames = unfold(F.pad(ex.data, (k - 1, 0)), k + hop - 1, hop)
        f = min(frames.shape[1], kernel.shape[1])
        out = _fft_frame_conv(frames[:, :f], kernel[:, :f], hop,
                              correlate=False)
        return Sig(out.reshape(ex.shape[0], -1), 1)

    def out_len(self, n: int, log_mag: Sig) -> int:
        return min(n // log_mag.hop, log_mag.steps) * log_mag.hop


class LTVZeroPhaseFIRFilterPrecise(LTVFilterInterface):
    """Sample-wise zero-phase FIR (GOLF-fs's noise filter): the windowed
    kernel of every frame, linearly upsampled to every sample, applied to
    the centred window of the excitation around that sample. Plain
    PyTorch, as ``golf_tpu`` computes it outside any kernel; the windows are
    a strided view, the upsampled kernels (B, T, K) a tensor."""

    def __init__(self, window: str = "hanning", n_mag: Optional[int] = None):
        super().__init__()
        self.window = window
        self.n_mag = n_mag

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.n_mag,) if self.n_mag else ()

    def ctrl(self, x: Sig) -> Tuple[Sig, ...]:
        return (x,)

    def _window_kernel(self, kernel: torch.Tensor) -> torch.Tensor:
        w = get_window_fn(self.window)(kernel.shape[-1])
        return kernel * torch.as_tensor(w, dtype=kernel.dtype,
                                        device=kernel.device)

    def forward(self, ex: Sig, log_mag: Sig) -> Sig:
        kernel = self._window_kernel(zero_phase_fir(log_mag.data))
        up = Sig(kernel, log_mag.hop).reduce_hop_length()
        k = kernel.shape[-1]
        pl = (k - 1) // 2
        frames = unfold(F.pad(ex.data, (pl, k - 1 - pl)), k, 1)
        t = min(frames.shape[1], up.steps)
        return Sig(torch.einsum("btk,btk->bt", frames[:, :t],
                                up.data[:, :t]), 1)


class LTVZeroPhaseFIRFilter(LTVZeroPhaseFIRFilterPrecise):
    """Frame-wise zero-phase FIR via FFT correlation; the noise filter of
    every shipped GOLF config. ``conv_method`` is kept and not read, as in
    ``golf_tpu``."""

    def __init__(self, window: str = "hanning", n_mag: Optional[int] = None,
                 conv_method: str = "fft"):
        super().__init__(window, n_mag)
        self.conv_method = conv_method

    def forward(self, ex: Sig, log_mag: Sig) -> Sig:
        hop = log_mag.hop
        kernel = self._window_kernel(zero_phase_fir(log_mag.data))
        k = kernel.shape[-1]
        padding = (k - 1) // 2
        env = seqpar.current()
        if env is not None:
            kl = seqpar.localize_frames(Sig(kernel, hop), env)
            return Sig(seqpar.fir_frame_conv_sharded(
                ex.data, kl.data, hop, padding, True, env), 1)
        frames = unfold(F.pad(ex.data, (padding, padding)), k + hop - 1, hop)
        f = min(frames.shape[1], kernel.shape[1])
        out = _fft_frame_conv(frames[:, :f], kernel[:, :f], hop,
                              correlate=True)
        return Sig(out.reshape(ex.shape[0], -1), 1)

    def out_len(self, n: int, log_mag: Sig) -> int:
        hop = log_mag.hop
        k = zero_phase_fir(log_mag.data[:1, :1]).shape[-1]
        frames = (n + 2 * ((k - 1) // 2) - (k + hop - 1)) // hop + 1
        return min(frames, log_mag.steps) * hop


class LTVAPZeroPhaseFIRFilter(LTVZeroPhaseFIRFilter):
    """Aperiodicity variant: the ctrl is ``log(sigmoid(x) * sqrt(n_fft))``,
    n_fft = 2 (n_mag - 1)."""

    def ctrl(self, x: Sig) -> Tuple[Sig, ...]:
        n_fft = 2 * (self.n_mag - 1)
        return (Sig(torch.log(torch.sigmoid(x.data) * math.sqrt(n_fft)),
                    x.hop),)


class LTIAcousticFilter(FilterInterface):
    """Learnable LTI FIR: identity + strictly causal learned taps,
    ``out[n] = x[n] + sum_k kernel[k] x[n - L + 1 + k]`` over delays
    1..L-1, as one rfft/irfft convolution whatever ``conv_method`` says
    (``golf_tpu`` keeps the field and does not read it). The kernel starts
    at zero."""

    def __init__(self, length: int = 128, conv_method: str = "fft"):
        super().__init__()
        self.conv_method = conv_method
        self.length = length
        self.kernel = nn.Parameter(torch.zeros(length - 1))

    def forward(self, ex: Sig) -> Sig:
        x = ex.data
        t = x.shape[-1]
        l = self.length - 1
        env = seqpar.current()
        if env is not None:
            # strictly causal taps: a left halo of L - 1 samples, then one
            # valid FFT correlation a shard
            ext = torch.cat([seqpar.halo_left(x, l, env), x], dim=1)
            nfft = 1 << (ext.shape[1] + l - 2).bit_length()
            conv = torch.fft.irfft(
                torch.fft.rfft(ext, n=nfft)
                * torch.fft.rfft(torch.flip(self.kernel, (0,)), n=nfft),
                n=nfft)
            return ex + Sig(conv[:, l - 1:l - 1 + t], 1)
        nfft = 1 << (t + l - 1).bit_length()
        conv = torch.fft.irfft(
            torch.fft.rfft(x[:, :-1], n=nfft)
            * torch.fft.rfft(torch.flip(self.kernel, (0,)), n=nfft), n=nfft)
        out = F.pad(conv[:, :t - 1], (1, 0))
        return ex + Sig(out, 1)

    def out_len(self, n: int) -> int:
        return n


class LTIRadiationFilter(FilterInterface):
    """The fixed radiation FIR (``get_radiation_time_filter``, 2 *
    num_zeros + 1 taps, windowed) as a centred correlation."""

    def __init__(self, num_zeros: int = 16, window: str = "hanning"):
        super().__init__()
        k = get_radiation_time_filter(num_zeros, get_window_fn(window))
        self.register_buffer("kernel", torch.tensor(k, dtype=torch.float32),
                             persistent=False)

    def forward(self, ex: Sig) -> Sig:
        pad = self.kernel.shape[0] // 2
        xp = F.pad(ex.data, (pad, pad))[:, None, :]
        w = self.kernel.to(xp.dtype)[None, None, :]
        return Sig(F.conv1d(xp, w)[:, 0, :], 1)


def _allpass_logits(num_roots: int) -> nn.Parameter:
    """(1, num_roots) logits, uniform with flax's variance_scaling(gain^2,
    fan_avg), gain 5/3 (tanh's): torch's Xavier-uniform bound."""
    w = torch.empty(1, num_roots)
    nn.init.xavier_uniform_(w, gain=5.0 / 3.0)
    return nn.Parameter(w)


def _allpass(ex: Sig, biquads: torch.Tensor) -> Sig:
    """The allpass with denominator the sections' product a and numerator
    a reversed, by ``lfilter``."""
    a = coeff_product(biquads[:, None, :])[0]
    return Sig(lfilter(ex.data, a, torch.flip(a, (0,))), 1)


class LTVPQMF(LTVFilterInterface):
    """A PQMF analysis bank of ``n_mag`` bands (``pqmf_filters``,
    ``filter_order`` + 1 taps; ``alpha`` <= 0 means 100 dB), each band
    scaled by its own exp(log_gain) at the frame hop, then summed."""

    def __init__(self, n_mag: int = 16, filter_order: int = 127,
                 alpha: float = 0.0):
        super().__init__()
        self.n_mag = n_mag
        bank = pqmf_filters(n_mag, filter_order, alpha if alpha > 0 else 100.0)
        self.register_buffer("filters", torch.from_numpy(bank),
                             persistent=False)

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.n_mag,)

    def ctrl(self, x: Sig) -> Tuple[Sig, ...]:
        return (x,)

    def forward(self, ex: Sig, log_gain: Sig) -> Sig:
        gain = Sig(torch.exp(log_gain.data), log_gain.hop)
        env = seqpar.current()
        if env is not None:
            # the bank's "same" padding from the neighbours' halos, the
            # gains localized to the rank's window
            x = ex.data
            taps = self.filters.shape[-1]
            pad_l = (taps - 1) // 2
            ext = torch.cat([seqpar.halo_left(x, pad_l, env), x,
                             seqpar.halo_right(x, taps - 1 - pad_l, env)],
                            dim=1)
            bands = F.conv1d(ext[:, None], torch.flip(
                self.filters.to(x.dtype), (-1,))[:, None])
            g = seqpar.localize(gain, env, 1).data     # (B, T_loc, bands)
            return Sig(torch.sum(bands.transpose(1, 2) * g, dim=2), 1)
        bands = pqmf_analysis(ex.data, self.filters.to(ex.dtype))
        filtered = Sig(bands.transpose(1, 2), 1) * gain
        return Sig(filtered.data.sum(dim=2), 1)

    def out_len(self, n: int, log_gain: Sig) -> int:
        return bcast_len(n, log_gain)


class LTIComplexConjAllpassFilter(FilterInterface):
    """Learnable LTI allpass from ``num_roots`` conjugate pole pairs:
    magnitude ``sigmoid * max_abs_value``, cosine ``tanh``."""

    def __init__(self, num_roots: int = 8, max_abs_value: float = 0.99):
        super().__init__()
        self.max_abs_value = max_abs_value
        self.magnitude_logits = _allpass_logits(num_roots)
        self.cos_logits = _allpass_logits(num_roots)

    def forward(self, ex: Sig) -> Sig:
        mag = torch.sigmoid(self.magnitude_logits[0]) * self.max_abs_value
        cos = torch.tanh(self.cos_logits[0])
        sin = torch.sqrt(torch.clamp(1 - cos ** 2, min=0.0))
        return _allpass(ex, complex2biquads(torch.complex(mag * cos,
                                                          mag * sin)))


class LTIRealCoeffAllpassFilter(FilterInterface):
    """Learnable LTI allpass from ``num_roots`` stable sections
    (``params2biquads`` of two tanh logits)."""

    def __init__(self, num_roots: int = 8, max_abs_value: float = 0.99):
        super().__init__()
        self.max_abs_value = max_abs_value
        self.logits1 = _allpass_logits(num_roots)
        self.logits2 = _allpass_logits(num_roots)

    def forward(self, ex: Sig) -> Sig:
        return _allpass(ex, params2biquads(
            torch.tanh(self.logits1[0]) * self.max_abs_value,
            torch.tanh(self.logits2[0]) * self.max_abs_value))


# ---------------------------------------------------------------------------
# Mel-cepstral and spectral-envelope filters
# ---------------------------------------------------------------------------

class LTVMLSAFilter(LTVFilterInterface):
    """Differentiable MLSA synthesis filter on mel-cepstrum frames (hop
    ``frame_period``), ``x`` cut to whole frames.

    * ``freq-domain`` (and ``single-stage``): mel-cepstrum -> log spectrum
      (``mc2sp_log``) -> its minimum-phase response (or ``exp`` of it when
      ``phase`` is not minimum) -> a product with the one-sided STFT of x ->
      the inverse STFT at x's length.
    * ``multi-stage``: the Taylor cascade ``exp(c0) * sum_{q<=Q} C^q x / q!``
      of the unwarped cepstrum (``freqt`` to ``cep_order``), C the FIR of
      taps c_1..c_K held within each frame: one FFT convolution a frame
      and stage.

    Time-sharded, the rank's window takes its own frame rows: the spectral
    route through ``seqpar.stft_filter_sharded``, each Taylor stage through
    ``seqpar.fir_frame_conv_sharded`` with a causal halo of K samples (K at
    most T_loc).
    """

    def __init__(self, filter_order: int = 24, frame_period: int = 240,
                 alpha: float = 0.46, gamma: float = 0.0,
                 mode: str = "freq-domain", cep_order: Optional[int] = None,
                 frame_length: int = 1024, fft_length: int = 1024,
                 window: str = "hanning", phase: str = "minimum",
                 taylor_order: int = 20):
        super().__init__()
        self.filter_order = filter_order
        self.frame_period = frame_period
        self.alpha = alpha
        self.gamma = gamma
        self.mode = mode
        self.cep_order = cep_order
        self.frame_length = frame_length
        self.fft_length = fft_length
        self.window = window
        self.phase = phase
        self.taylor_order = taylor_order

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.filter_order + 1,)

    def ctrl(self, x: Sig) -> Tuple[Sig, ...]:
        return (x,)

    def _filter_freq_domain(self, x: torch.Tensor, mc_d: torch.Tensor,
                            ctrl_frames: int) -> torch.Tensor:
        n_fft = self.fft_length
        hop = self.frame_period
        # multi-stage truncates the unwarped cepstrum at cep_order (this
        # realization runs with it in LTVMLSAFilter2), freq-domain takes
        # the full half-spectrum order
        lin_order = (self.cep_order or None) if self.mode == "multi-stage" \
            else None
        log_mag = mc2sp_log(mc_d, n_fft, self.alpha, lin_order=lin_order)
        if self.phase in ("minimum", "min"):
            h = minimum_phase_response(log_mag)
        else:
            h = torch.exp(log_mag)
        env = seqpar.current()
        if env is not None:
            # the unsharded x is cut to whole frames: it reflects there
            n_in = (env.in_len or env.t_global) // hop * hop
            return seqpar.stft_filter_sharded(
                x, h, n_fft, hop, self.window, env, onesided=True,
                n_in=n_in, n_frames=min(n_in // hop, ctrl_frames))
        spec = stft_ops.stft(x, n_fft, hop, window=self.window, center=True)
        f = min(spec.shape[-1], h.shape[1])
        return stft_ops.istft(
            spec[..., :f] * h[:, :f].transpose(1, 2), n_fft, hop,
            window=self.window, center=True, length=x.shape[1])

    def _filter_multi_stage(self, x: torch.Tensor,
                            mc_d: torch.Tensor) -> torch.Tensor:
        hop = self.frame_period
        k_ord = self.cep_order or 4 * self.filter_order
        c_lin = freqt(mc_d, k_ord, -self.alpha)       # (B, F, K+1)
        gain = torch.exp(c_lin[..., 0])               # (B, F)
        taps = F.pad(c_lin[..., 1:], (1, 0))
        b, t = x.shape
        frames = mc_d.shape[1]
        env = seqpar.current()

        def tv_fir(u: torch.Tensor) -> torch.Tensor:
            if env is not None:
                return seqpar.fir_frame_conv_sharded(u, taps, hop, k_ord,
                                                     False, env)
            fr = unfold(F.pad(u, (k_ord, 0)), hop + k_ord, hop)
            seg = _fft_frame_conv(fr[:, :frames], taps, hop, correlate=False)
            return seg.reshape(b, -1)

        acc = x
        term = x
        for q in range(1, self.taylor_order + 1):
            term = tv_fir(term) / q
            acc = acc + term
        return acc * torch.repeat_interleave(gain, hop, dim=1)[:, :t]

    def _whole_frames(self, ex: Sig, mc: Sig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x cut to whole frames, their rows of mc); time-sharded, the
        rank's window and its rows."""
        if mc.hop != self.frame_period:
            raise ValueError(f"mc hop {mc.hop} != {self.frame_period}")
        env = seqpar.current()
        if env is not None:
            return ex.data, seqpar.localize_frames(mc, env).data
        frames = ex.data.shape[1] // self.frame_period
        return (ex.data[:, :frames * self.frame_period],
                mc.data[:, :frames])

    def forward(self, ex: Sig, mc: Sig, **kwargs) -> Sig:
        x, mc_d = self._whole_frames(ex, mc)
        if self.mode == "multi-stage":
            return Sig(self._filter_multi_stage(x, mc_d), 1)
        return Sig(self._filter_freq_domain(x, mc_d, mc.steps), 1)

    def _freq_domain_len(self, n: int, mc: Sig) -> int:
        hop = self.frame_period
        frames = n // hop
        f = min(_stft_frames(frames * hop, self.fft_length, hop, True),
                frames, mc.steps)
        return _istft_len(f, self.fft_length, hop, True, frames * hop)

    def out_len(self, n: int, mc: Sig) -> int:
        if self.mode == "multi-stage":
            return min(n // self.frame_period, mc.steps) * self.frame_period
        return self._freq_domain_len(n, mc)


class LTVMLSAFilter2(LTVMLSAFilter):
    """The spectral realization, whatever ``mode`` says."""

    def forward(self, ex: Sig, mc: Sig, **kwargs) -> Sig:
        x, mc_d = self._whole_frames(ex, mc)
        return Sig(self._filter_freq_domain(x, mc_d, mc.steps), 1)

    def out_len(self, n: int, mc: Sig) -> int:
        return self._freq_domain_len(n, mc)


class LTVAPFilter(LTVMLSAFilter):
    """Aperiodicity through MLSA: ctrl is ``mcep(sigmoid(x))``; zero phase
    by default."""

    def __init__(self, n_mag: int = 257, phase: str = "zero", **kwargs):
        super().__init__(phase=phase, **kwargs)
        self.n_mag = n_mag

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.n_mag,)

    def ctrl(self, x: Sig) -> Tuple[Sig, ...]:
        return (Sig(mcep(torch.sigmoid(x.data), self.filter_order,
                         self.alpha), x.hop),)


class LTVCepFilter(LTVFilterInterface):
    """NHV's harmonic filter: cepstrum frames -> a log magnitude (zero-,
    then reflect-padded to n_fft, real FFT) -> zero-phase or, by the
    Hilbert transform, minimum-phase response -> a product with the
    two-sided STFT -> the two-sided inverse STFT, without ``length``: the
    output is (frames - 1) * hop long."""

    def __init__(self, filter_order: int = 240, n_fft: int = 1024,
                 window: str = "hanning", hop_length: int = 240,
                 phase: str = "zero"):
        super().__init__()
        self.filter_order = filter_order
        self.n_fft = n_fft
        self.window = window
        self.hop_length = hop_length
        self.phase = phase

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.filter_order + 1,)

    def ctrl(self, x: Sig) -> Tuple[Sig, ...]:
        return (x,)

    def forward(self, ex: Sig, ceps: Sig, **kwargs) -> Sig:
        if ceps.hop != self.hop_length:
            raise ValueError(f"ceps hop {ceps.hop} != {self.hop_length}")
        n_fft = self.n_fft
        env = seqpar.current()
        c = ceps.data if env is None else \
            seqpar.localize_frames(ceps, env).data
        c = F.pad(c, (0, n_fft // 2 - self.filter_order))
        b, f, n = c.shape
        c = F.pad(c.reshape(b * f, 1, n), (0, n_fft // 2 - 1),
                  mode="reflect").reshape(b, f, n_fft)
        log_mag = torch.fft.fft(c, dim=-1).real       # (B, F, n_fft)
        if self.phase == "zero":
            h = torch.exp(log_mag)
        else:
            h = minimum_phase_spectrum(log_mag)
        if env is not None:
            return Sig(_stft_filter_sharded(
                env, ex.data, h, n_fft, self.hop_length, self.window,
                ceps.steps, onesided=False), 1)
        h = h.transpose(1, 2)                         # (B, n_fft, F)
        spec = stft_ops.stft(ex.data, n_fft, self.hop_length,
                             window=self.window, center=True, onesided=False)
        f = min(spec.shape[-1], h.shape[-1])
        return Sig(stft_ops.istft(spec[..., :f] * h[..., :f], n_fft,
                                  self.hop_length, window=self.window,
                                  center=True, onesided=False), 1)

    def out_len(self, n: int, ceps: Sig) -> int:
        f = min(_stft_frames(n, self.n_fft, self.hop_length, True),
                ceps.steps)
        return _istft_len(f, self.n_fft, self.hop_length, True)


class DiffWorldSPFilter(LTVFilterInterface):
    """∇WORLD's spectral-envelope filter: mel bins -> the non-negative part
    of the mel filterbank's pseudo-inverse (a buffer, host numpy from the
    float32 filterbank, as ``golf_tpu``'s) -> the square root of the
    envelope -> a product with the one-sided STFT -> the inverse STFT."""

    def __init__(self, n_mels: int = 80, n_fft: int = 1024,
                 hop_length: int = 240, f_min: float = 0.0,
                 f_max: float = 12000.0, sample_rate: int = 24000,
                 center: bool = True, window: str = "hanning"):
        super().__init__()
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.center = center
        self.window = window
        fb = stft_ops.melscale_fbanks(n_fft // 2 + 1, f_min, f_max, n_mels,
                                      sample_rate)
        inv_fb = np.maximum(np.linalg.pinv(fb), 0.0)
        self.register_buffer("inv_fb", torch.tensor(inv_fb,
                                                    dtype=torch.float32),
                             persistent=False)

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.n_mels,)

    def ctrl(self, x: Sig) -> Tuple[Sig, ...]:
        return (Sig(torch.exp(x.data), x.hop),)

    def forward(self, ex: Sig, mel_sp: Sig) -> Sig:
        if mel_sp.hop != self.hop_length:
            raise ValueError(f"mel hop {mel_sp.hop} != {self.hop_length}")
        env = seqpar.current()
        if env is not None:
            if not self.center:
                raise ValueError("the time-sharded DiffWorldSPFilter needs "
                                 "center")
            sp = seqpar.localize_frames(mel_sp, env).data @ \
                self.inv_fb.to(mel_sp.dtype)
            return Sig(_stft_filter_sharded(
                env, ex.data, torch.sqrt(torch.clamp(sp, min=0.0)),
                self.n_fft, self.hop_length, self.window, mel_sp.steps,
                onesided=True), 1)
        sp = mel_sp.data @ self.inv_fb.to(mel_sp.dtype)  # (B, F, bins)
        sp = torch.sqrt(torch.clamp(sp, min=0.0)).transpose(1, 2)
        spec = stft_ops.stft(ex.data, self.n_fft, self.hop_length,
                             window=self.window, center=self.center)
        f = min(spec.shape[-1], sp.shape[-1])
        return Sig(stft_ops.istft(spec[..., :f] * sp[..., :f], self.n_fft,
                                  self.hop_length, window=self.window,
                                  center=self.center), 1)

    def out_len(self, n: int, mel_sp: Sig) -> int:
        f = min(_stft_frames(n, self.n_fft, self.hop_length, self.center),
                mel_sp.steps)
        return _istft_len(f, self.n_fft, self.hop_length, self.center)
