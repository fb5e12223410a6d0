"""WORLD analysis and synthesis on the host (counterpart of
``golf_tpu.utils.world_lite``, copied as it is). Pure numpy in float64:

* ``dio``: log-spaced lowpass channels, four event sequences a channel,
  the most stable candidate, then contour cleaning and a spectral
  refinement. The vocoder's and LPCNet's test steps score the f0 they
  re-estimate from the synthesised audio; ``golf_tpu``'s default
  ``utils.native.dio`` (``method="dio"``) is this function; ``get_f0``
  calls it with pyworld's signature.
* ``dio_yin``: the YIN (CMND) estimator a frame, the numpy twin of
  ``native/worldlite.cpp``'s ``wl_dio``.
* ``cheaptrick``, ``d4c`` and ``synthesize``: the spectral envelope, the
  band aperiodicity and the resynthesis of the WORLD baseline
  (``tasks/world_ae.py``); ``synthesize`` draws its noise from a numpy
  generator seeded with ``seed``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# f0 estimation — DIO (multi-band candidates + stability selection)
# ---------------------------------------------------------------------------

def _lowpass_fft(x: np.ndarray, fs: int, cutoff: float) -> np.ndarray:
    """Zero-phase lowpass via FFT masking with a raised-cosine rolloff."""
    n = len(x)
    spec = np.fft.rfft(x)
    freq = np.fft.rfftfreq(n, 1.0 / fs)
    roll = cutoff * 0.25
    gain = np.clip((cutoff + roll - freq) / (2 * roll), 0.0, 1.0)
    gain = 0.5 - 0.5 * np.cos(np.pi * gain)
    return np.fft.irfft(spec * gain, n)


def _event_intervals(times: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Event times -> (midpoint times, instantaneous f0 samples)."""
    if len(times) < 2:
        return np.zeros(0), np.zeros(0)
    iv = np.diff(times)
    good = iv > 0
    return (0.5 * (times[1:] + times[:-1]))[good], 1.0 / iv[good]


def _zero_crossing_times(y: np.ndarray, fs: int,
                         negative: bool) -> np.ndarray:
    s = -y if negative else y
    idx = np.where((s[:-1] < 0) & (s[1:] >= 0))[0]
    if idx.size == 0:
        return np.zeros(0)
    frac = -s[idx] / (s[idx + 1] - s[idx] + 1e-20)
    return (idx + frac) / fs


def _channel_candidates(flt: np.ndarray, fs: int, t_frames: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """DIO's four event sequences on one filtered channel: negative/
    positive zero crossings, peaks, dips. Returns (f0 candidate per
    frame, deviation per frame)."""
    ests = []
    for sig, neg in ((flt, False), (flt, True)):
        tt, ff = _event_intervals(_zero_crossing_times(sig, fs, neg))
        ests.append((tt, ff))
    dy = np.diff(flt)
    for neg in (False, True):
        tt, ff = _event_intervals(_zero_crossing_times(dy, fs, neg))
        ests.append((tt, ff))
    per_frame = []
    for tt, ff in ests:
        if len(tt) < 2:
            per_frame.append(np.zeros_like(t_frames))
        else:
            per_frame.append(np.interp(t_frames, tt, ff,
                                       left=ff[0], right=ff[-1]))
    per_frame = np.stack(per_frame)                  # (4, F)
    cand = per_frame.mean(0)
    dev = per_frame.std(0)
    return cand, dev


def dio(x: np.ndarray, fs: int, f0_floor: float = 65.0,
        f0_ceil: float = 1047.0, frame_period: float = 5.0,
        channels_in_octave: float = 2.0,
        threshold: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """DIO f0 estimation (WORLD's algorithm structure): log-spaced
    lowpass filter bank, four fundamental-candidate event sequences per
    channel (zero crossings/peaks/dips of the filtered waveform), the
    candidate with the smallest cross-event deviation wins, then
    contour cleaning + spectral refinement. Reference surface:
    ``models/utils.py:596-602`` (pyworld.dio)."""
    x = np.asarray(x, np.float64)
    x = x - x.mean()
    hop = int(fs * frame_period / 1000)
    n_frames = len(x) // hop + 1
    t_frames = np.arange(n_frames) * hop / fs

    n_oct = math.log2(f0_ceil / f0_floor)
    n_ch = max(2, int(math.ceil(n_oct * channels_in_octave)) + 1)
    bounds = f0_floor * 2.0 ** (np.arange(n_ch) / channels_in_octave)
    bounds = bounds[bounds <= f0_ceil * 1.1]

    cands, devs = [], []
    for fc in bounds:
        flt = _lowpass_fft(x, fs, cutoff=fc * 1.4)
        cand, dev = _channel_candidates(flt, fs, t_frames)
        # a channel is only credible if its candidate lies near the band
        bad = (cand < fc * 0.45) | (cand > fc * 1.6) | \
              (cand < f0_floor) | (cand > f0_ceil)
        rel_dev = dev / np.maximum(cand, 1e-9)
        rel_dev[bad] = np.inf
        cands.append(cand)
        devs.append(rel_dev)
    cands = np.stack(cands)
    devs = np.stack(devs)
    best = devs.argmin(0)
    ar = np.arange(n_frames)
    f0 = cands[best, ar]
    best_dev = devs[best, ar]
    voiced = best_dev < 0.18
    f0 = np.where(voiced, f0, 0.0)

    # contour cleaning: drop isolated voiced points and octave jumpers
    for i in range(1, n_frames - 1):
        if f0[i] > 0 and f0[i - 1] == 0 and f0[i + 1] == 0:
            f0[i] = 0.0
    med = _median3(f0)
    jump = (f0 > 0) & (med > 0) & (np.abs(np.log2(
        np.maximum(f0, 1e-9) / np.maximum(med, 1e-9))) > 0.6)
    f0[jump] = med[jump]

    # spectral refinement (StoneMask-style): reweight with the measured
    # fundamental peak
    f0 = _refine_f0(x, fs, f0, t_frames)
    return f0, t_frames


def _median3(f0: np.ndarray) -> np.ndarray:
    if len(f0) < 3:
        return f0.copy()
    st = np.stack([np.roll(f0, 1), f0, np.roll(f0, -1)])
    out = np.median(st, axis=0)
    out[0], out[-1] = f0[0], f0[-1]
    return out


def _refine_f0(x: np.ndarray, fs: int, f0: np.ndarray,
               t_frames: np.ndarray) -> np.ndarray:
    """Refine each voiced frame by the parabolic-interpolated spectral
    peak nearest the candidate fundamental, and confirm voicing with the
    RAW signal's normalized autocorrelation at the period (narrowband-
    filtered noise can fool the event-deviation test; true periodicity
    cannot be faked in the unfiltered signal)."""
    out = f0.copy()
    n = len(x)
    for i, (cf0, tc) in enumerate(zip(f0, t_frames)):
        if cf0 <= 0:
            continue
        win_len = int(3 * fs / cf0)
        center = int(tc * fs)
        idx = np.clip(center + np.arange(win_len) - win_len // 2, 0, n - 1)
        raw = x[idx]
        period = max(2, int(round(fs / cf0)))
        if len(raw) > 2 * period + 2:
            a_s, b_s = raw[:-period], raw[period:]
            denom = math.sqrt(float(np.sum(a_s ** 2)) *
                              float(np.sum(b_s ** 2))) + 1e-12
            if float(np.sum(a_s * b_s)) / denom < 0.45:
                out[i] = 0.0
                continue
        seg = raw * np.hanning(win_len)
        nfft = int(2 ** math.ceil(math.log2(win_len * 4)))
        mag = np.abs(np.fft.rfft(seg, nfft))
        bin_f0 = cf0 * nfft / fs
        lo = max(1, int(bin_f0 * 0.7))
        hi = min(len(mag) - 2, int(bin_f0 * 1.35))
        if hi <= lo:
            continue
        k = lo + int(np.argmax(mag[lo:hi + 1]))
        a, b, c = mag[k - 1], mag[k], mag[k + 1]
        denom = a - 2 * b + c
        delta = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
        refined = (k + delta) * fs / nfft
        if 0.7 * cf0 < refined < 1.35 * cf0:
            out[i] = refined
    return out


def dio_yin(x: np.ndarray, fs: int, f0_floor: float = 65.0,
            f0_ceil: float = 1047.0, frame_period: float = 5.0,
            channels_in_octave: float = 2.0,
            threshold: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """Round-1 YIN (CMND) estimator, kept as the fast bulk-data-prep path
    (the native C++ kernel implements this one)."""
    x = np.asarray(x, np.float64)
    hop = int(fs * frame_period / 1000)
    tau_min = max(2, int(fs / f0_ceil))
    tau_max = int(fs / f0_floor)
    win = 2 * tau_max
    n_frames = len(x) // hop + 1
    f0 = np.zeros(n_frames)
    xp = np.pad(x, (0, win + tau_max + 1))
    for i in range(n_frames):
        seg = xp[i * hop: i * hop + win]
        f0[i] = _yin_pitch(seg, fs, tau_min, tau_max, threshold)
    t = np.arange(n_frames) * frame_period / 1000
    return f0, t


def _yin_pitch(seg: np.ndarray, fs: int, tau_min: int, tau_max: int,
               threshold: float) -> float:
    w = len(seg) // 2
    n = len(seg)
    # YIN cross term r(tau) = sum_{i<w} seg[i] * seg[i+tau], via FFT
    fa = np.fft.rfft(seg[:w], 2 * n)
    fb = np.fft.rfft(seg, 2 * n)
    cc = np.fft.irfft(np.conj(fa) * fb)[:w + 1]
    cum = np.cumsum(seg ** 2)
    pow0 = cum[w - 1]
    pow_tau = cum[w - 1 + np.arange(w + 1)] - np.concatenate(
        [[0], cum[np.arange(w)]])
    d = pow0 + pow_tau - 2 * cc
    d = np.maximum(d, 0)
    # cumulative mean normalized difference
    denom = np.cumsum(d[1:]) / np.arange(1, w + 1)
    cmnd = np.ones(w + 1)
    cmnd[1:] = d[1:] / np.maximum(denom, 1e-12)
    tau_max = min(tau_max, w - 1)
    below = np.where(cmnd[tau_min:tau_max] < threshold)[0]
    if below.size:
        tau = tau_min + below[0]
        # walk to local minimum
        while tau + 1 < tau_max and cmnd[tau + 1] < cmnd[tau]:
            tau += 1
    else:
        tau = tau_min + int(np.argmin(cmnd[tau_min:tau_max]))
        if cmnd[tau] > 0.5:
            return 0.0
    # parabolic interpolation
    if 1 <= tau < w - 1:
        a, b, c = cmnd[tau - 1], cmnd[tau], cmnd[tau + 1]
        denom2 = a - 2 * b + c
        if abs(denom2) > 1e-12:
            tau = tau + 0.5 * (a - c) / denom2
    return fs / tau if tau > 0 else 0.0


# ---------------------------------------------------------------------------
# Spectral envelope (CheapTrick-style)
# ---------------------------------------------------------------------------

def cheaptrick(x: np.ndarray, f0: np.ndarray, t: np.ndarray, fs: int,
               fft_size: Optional[int] = None,
               default_f0: float = 500.0) -> np.ndarray:
    """f0-adaptive windowed power spectrum + spectral smoothing + liftering.
    Returns (n_frames, fft_size//2+1) power envelope."""
    x = np.asarray(x, np.float64)
    if fft_size is None:
        fft_size = 2 ** math.ceil(math.log2(3 * fs / 71.0 + 1))
    half = fft_size // 2
    n_frames = len(f0)
    sp = np.zeros((n_frames, half + 1))
    freq = np.arange(half + 1) * fs / fft_size
    q1 = -0.15
    for i in range(n_frames):
        cf0 = f0[i] if f0[i] > 0 else default_f0
        center = int(t[i] * fs)
        win_len = min(int(3 * fs / cf0) // 2 * 2 + 1, fft_size)
        idx = center + np.arange(win_len) - win_len // 2
        idx = np.clip(idx, 0, len(x) - 1)
        win = np.hanning(win_len)
        seg = x[idx] * win
        # window-power normalization: without it the envelope level would
        # depend on f0 through the 3*T0 window length
        power = np.abs(np.fft.rfft(seg, fft_size)) ** 2 / np.sum(win ** 2)
        power += 1e-12
        # DC correction (WORLD): mirror the spectrum around f0 into the
        # sub-f0 region so the envelope doesn't dip below the first
        # harmonic
        bf0 = int(round(cf0 / (fs / fft_size)))
        if 0 < 2 * bf0 < half:
            power[:bf0] = power[:bf0] + power[2 * bf0: bf0: -1]
        # rectangular smoothing of width 2/3 f0: exact boxcar average via
        # the cumulative integral with DC mirroring (WORLD's
        # LinearSmoothing), not a discrete convolve — sub-bin width and
        # boundary handling matter for envelope accuracy
        width_bins = (2 * cf0 / 3) / (fs / fft_size)
        mirrored = np.concatenate([power[1:][::-1], power,
                                   power[-2:][::-1]])
        cum = np.concatenate([[0.0], np.cumsum(mirrored)])
        pos = np.arange(half + 1) + half          # center in mirrored
        lo_q = pos - width_bins / 2 + 0.5
        hi_q = pos + width_bins / 2 + 0.5

        def interp_cum(q):
            qi = np.clip(q, 0, len(cum) - 1.001)
            base = np.floor(qi).astype(int)
            return cum[base] + (qi - base) * (cum[base + 1] - cum[base])

        smoothed = (interp_cum(hi_q) - interp_cum(lo_q)) / width_bins
        # log-domain liftering: log_sp IS the one-sided spectrum, so
        # irfft alone yields the (even, real) cepstrum — mirroring by
        # hand and passing the full array to irfft would reinterpret it
        # as a one-sided spectrum of twice the length
        log_sp = np.log(smoothed)
        cep = np.fft.irfft(log_sp)[:half + 1]
        quef = np.arange(half + 1) / fs
        lifter = np.sinc(cf0 * quef)
        lifter_c = (1 + 2 * q1) - 2 * q1 * np.cos(
            2 * np.pi * quef * cf0)
        cep = cep * lifter * lifter_c
        cep_full = np.concatenate([cep, cep[-2:0:-1]])
        sp[i] = np.exp(np.fft.rfft(cep_full).real[:half + 1])
    return sp


# ---------------------------------------------------------------------------
# Aperiodicity (D4C-lite)
# ---------------------------------------------------------------------------

def d4c(x: np.ndarray, f0: np.ndarray, t: np.ndarray, fs: int,
        fft_size: Optional[int] = None,
        frequency_interval: float = 3000.0) -> np.ndarray:
    """Band aperiodicity (D4C structure): coarse aperiodicity is MEASURED
    per frequency band (centers every ``frequency_interval`` Hz, as in
    WORLD) from the pitch-synchronous normalized autocorrelation of the
    band-passed signal around each frame, then log-interpolated over the
    full FFT grid. Reference surface: ``ltng/world_ae.py:36-41``
    (pyworld.d4c). Returns (n_frames, fft_size//2+1) aperiodicity."""
    x = np.asarray(x, np.float64)
    if fft_size is None:
        fft_size = 2 ** math.ceil(math.log2(3 * fs / 71.0 + 1))
    half = fft_size // 2
    n_frames = len(f0)
    ap = np.ones((n_frames, half + 1)) * 0.999
    freq = np.arange(half + 1) * fs / fft_size

    # coarse band centers: 3 kHz spacing like WORLD (plus the edges)
    n_bands = max(1, int(fs / 2 / frequency_interval))
    centers = np.arange(1, n_bands + 1) * frequency_interval
    centers = centers[centers < fs / 2 - 500]
    if centers.size == 0:
        centers = np.asarray([fs / 4])

    # band-passed copies of the whole signal (zero-phase FFT masking)
    n = len(x)
    spec = np.fft.rfft(x)
    fgrid = np.fft.rfftfreq(n, 1.0 / fs)
    bands = []
    for fc in centers:
        lo, hi = max(50.0, fc - frequency_interval), fc + frequency_interval
        gain = np.clip(np.minimum(fgrid - lo, hi - fgrid)
                       / (0.25 * frequency_interval), 0.0, 1.0)
        bands.append(np.fft.irfft(spec * gain, n))

    coarse_freq = np.concatenate([[0.0], centers, [fs / 2]])
    for i in range(n_frames):
        if f0[i] <= 0:
            continue
        period = max(2, int(round(fs / f0[i])))
        center = int(t[i] * fs)
        w = 3 * period
        s0, s1 = max(0, center - w), min(n, center + w)
        if s1 - s0 < 2 * period + 2:
            continue
        coarse = np.empty(len(centers))
        for bi, bx in enumerate(bands):
            seg = bx[s0:s1]
            a = seg[:-period]
            b = seg[period:]
            denom = math.sqrt(float(np.sum(a * a)) *
                              float(np.sum(b * b))) + 1e-12
            r = float(np.sum(a * b)) / denom
            coarse[bi] = math.sqrt(max(1e-6, 1.0 - max(r, 0.0) ** 2))
        coarse = np.clip(coarse, 1e-3, 0.999)
        # log-domain interpolation over the full grid; edges follow
        # WORLD's convention (low edge near-periodic floor, Nyquist
        # fully aperiodic)
        cvals = np.concatenate([[coarse[0]], coarse, [0.999]])
        ap[i] = np.exp(np.interp(freq, coarse_freq, np.log(cvals)))
    return np.clip(ap, 1e-3, 0.999)


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

def synthesize(f0: np.ndarray, sp: np.ndarray, ap: np.ndarray, fs: int,
               frame_period: float = 5.0, seed: int = 0) -> np.ndarray:
    """WORLD synthesis: phase-coherent time-domain harmonic bank for the
    periodic part (amplitudes sampled from sqrt(sp)·sqrt(1-ap²) along
    each harmonic's trajectory — bin-quantized frame-OLA harmonics would
    comb-filter under vibrato) + frame-OLA spectrally-shaped noise for
    the aperiodic part."""
    rng = np.random.default_rng(seed)
    hop = int(fs * frame_period / 1000)
    n_frames = len(f0)
    bins = sp.shape[1]
    fft_size = 2 * (bins - 1)
    out_len = n_frames * hop
    tt = np.arange(out_len)

    # ---- periodic part: time-domain harmonic bank ----------------------
    frame_of_t = np.minimum(tt / hop, n_frames - 1)
    fi = np.floor(frame_of_t).astype(int)
    fw = frame_of_t - fi
    fi1 = np.minimum(fi + 1, n_frames - 1)
    f0_t = f0[fi] * (1 - fw) + f0[fi1] * fw
    f0_t = np.where((f0[fi] > 0) & (f0[fi1] > 0), f0_t,
                    np.maximum(f0[fi], f0[fi1]) * (fw > 0.5))
    voiced_t = f0_t > 0
    phase = np.cumsum(np.where(voiced_t, f0_t, 0.0)) / fs
    y = np.zeros(out_len)
    if voiced_t.any():
        f0_safe = np.where(voiced_t, f0_t, 100.0)
        max_harm = int(fs / 2 / max(f0[f0 > 0].min(), 1e-3)) \
            if (f0 > 0).any() else 0
        df = fs / fft_size
        for k in range(1, max_harm + 1):
            fk = k * f0_safe
            alive = voiced_t & (fk < fs / 2 - df)
            if not alive.any():
                break
            # bilinear sample of sp and ap along the trajectory
            bq = fk / df
            b0 = np.clip(bq.astype(int), 0, bins - 2)
            bwt = bq - b0
            spk = (sp[fi, b0] * (1 - bwt) + sp[fi, b0 + 1] * bwt) \
                * (1 - fw) + (sp[fi1, b0] * (1 - bwt)
                              + sp[fi1, b0 + 1] * bwt) * fw
            apk = (ap[fi, b0] * (1 - bwt) + ap[fi, b0 + 1] * bwt) \
                * (1 - fw) + (ap[fi1, b0] * (1 - bwt)
                              + ap[fi1, b0 + 1] * bwt) * fw
            # pulse-train-through-envelope amplitude convention:
            # a_k = 2 f0/fs * sqrt(density) (see analysis normalization)
            amp = 2.0 * (f0_safe / fs) * np.sqrt(
                np.maximum(spk, 1e-12) * fft_size / 6.0)
            amp = amp * np.sqrt(np.maximum(1 - apk ** 2, 0.0)) * alive
            y += amp * np.sin(2 * np.pi * k * phase)

    # ---- aperiodic part: frame-OLA shaped noise ------------------------
    yn = np.zeros(out_len + 2 * fft_size)
    wsum = np.zeros_like(yn)
    win = np.hanning(fft_size)
    for i in range(n_frames):
        env = np.sqrt(np.maximum(sp[i], 1e-12))
        apw = np.clip(ap[i], 1e-3, 0.999)
        noise_spec = (rng.standard_normal(bins)
                      + 1j * rng.standard_normal(bins)) / math.sqrt(2)
        spec = env * apw * noise_spec * math.sqrt(fft_size)
        frame = np.fft.fftshift(np.fft.irfft(spec)) * win
        start = i * hop
        yn[start:start + fft_size] += frame
        wsum[start:start + fft_size] += win ** 2
    yn = yn[fft_size // 2: fft_size // 2 + out_len]
    wsum = wsum[fft_size // 2: fft_size // 2 + out_len]
    # independent frames overlap-add: variance grows with sum(win^2), so
    # normalize by its square root to recover the target noise PSD
    y = y + yn / np.sqrt(np.maximum(wsum, 1e-6))
    return y.astype(np.float64)


def get_f0(x: np.ndarray, fs: int, f0_floor: float = 65.0,
           f0_ceil: float = 1047.0, frame_period: float = 5.0,
           channels_in_octave: float = 2.0):
    """pyworld-``get_f0`` partial equivalent (``models/utils.py:596-602``)."""
    return dio(x, fs, f0_floor=f0_floor, f0_ceil=f0_ceil,
               frame_period=frame_period,
               channels_in_octave=channels_in_octave)
