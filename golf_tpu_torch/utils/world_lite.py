"""DIO f0 estimation on the host (counterpart of the DIO part of
``golf_tpu.utils.world_lite``, copied as it is): log-spaced lowpass
channels, four event sequences a channel, the most stable candidate, then
contour cleaning and a spectral refinement. Pure numpy in float64; the
vocoder's test step scores the f0 it re-estimates from the synthesised
audio. ``golf_tpu``'s default ``utils.native.dio`` (``method="dio"``) is
this function.
"""

from __future__ import annotations

import math
from typing import Tuple

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
