"""SWIPE' pitch estimator (Camacho & Harris, JASA 2008), host-side numpy
(counterpart of ``golf_tpu.utils.swipe``, copied as it is): the
``pysptk.swipe`` equivalent of ``scripts/wav2f0_torch.py --method swipe``,
a sawtooth-waveform-inspired estimator that scores pitch candidates by the
normalized inner product between an ERB-scale square-root spectrum and a
cosine kernel with weight only at prime harmonics (the "prime" variant,
SWIPE').

This is a from-the-paper implementation: multi-resolution Hann STFTs with
power-of-two windows whose optimal pitch brackets each candidate,
loudness L = sqrt(|X|) interpolated on an ERB grid, per-candidate kernel
correlation, bilinear blending between the two bracketing window sizes,
and parabolic refinement over log2(pitch).
"""
from __future__ import annotations

import numpy as np

__all__ = ["swipe"]


def _hz2erbs(hz):
    return 6.44 * (np.log2(229.0 + hz) - 7.84)


def _erbs2hz(erbs):
    return 2.0 ** (erbs / 6.44 + 7.84) - 229.0


def _primes_upto(n: int) -> np.ndarray:
    if n < 2:
        return np.empty(0, dtype=np.int64)
    sieve = np.ones(n + 1, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(n ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i::i] = False
    return np.nonzero(sieve)[0]


def _kernel(f_erbs: np.ndarray, pc: float) -> np.ndarray:
    """SWIPE' kernel for one pitch candidate sampled at f_erbs (Hz)."""
    n = int(f_erbs[-1] / pc - 0.75)
    k = np.zeros_like(f_erbs)
    q = f_erbs / pc
    for i in np.concatenate(([1], _primes_upto(n))):
        a = np.abs(q - i)
        p = a < 0.25
        k[p] = np.cos(2 * np.pi * q[p])
        v = (0.25 < a) & (a < 0.75)
        k[v] += np.cos(2 * np.pi * q[v]) / 2
    k = k * np.sqrt(1.0 / f_erbs)
    pos = k > 0
    nrm = np.linalg.norm(k[pos])
    return k / nrm if nrm > 0 else k


def _pitch_strength(f_erbs: np.ndarray, L: np.ndarray,
                    pc: np.ndarray) -> np.ndarray:
    """Strength matrix (len(pc), frames) for loudness L (bins, frames)."""
    S = np.empty((len(pc), L.shape[1]), dtype=np.float64)
    # normalize loudness per frame
    nrm = np.linalg.norm(L, axis=0, keepdims=True)
    Ln = L / np.where(nrm > 0, nrm, 1.0)
    for j, p in enumerate(pc):
        S[j] = _kernel(f_erbs, p) @ Ln
    return S


def swipe(x: np.ndarray, fs: int, hopsize: int = 120,
          min: float = 65.0, max: float = 1047.0,
          threshold: float = 0.3, dlog2p: float = 1.0 / 48,
          dERBs: float = 0.1, woverlap: float = 0.5,
          otype: str = "f0") -> np.ndarray:
    """Estimate f0 with SWIPE'. Mirrors ``pysptk.swipe``'s interface:
    returns one value per ``hopsize`` samples; frames whose best pitch
    strength is below ``threshold`` are 0 (unvoiced).
    """
    x = np.asarray(x, dtype=np.float64)
    plim = (float(min), float(max))
    t_out = np.arange(0, len(x), hopsize) / fs  # output time grid

    # pitch candidates, log2-spaced
    log2pc = np.arange(np.log2(plim[0]), np.log2(plim[1]), dlog2p)
    pc = 2.0 ** log2pc
    S = np.zeros((len(pc), len(t_out)))

    # P2-WSs: power-of-2 window sizes bracketing 8*fs/pitch
    log_ws_max = int(round(np.log2(8 * fs / plim[0])))
    log_ws_min = int(round(np.log2(8 * fs / plim[1])))
    ws_list = 2 ** np.arange(log_ws_max, log_ws_min - 1, -1)
    p0 = 8.0 * fs / ws_list  # optimal pitch per window size
    # distance of each candidate from the "first" window's optimal pitch
    d = 1 + log2pc - np.log2(8 * fs / ws_list[0])

    # ERB-spaced frequency grid
    f_erbs = _erbs2hz(np.arange(_hz2erbs(pc[0] / 4), _hz2erbs(fs / 2.0),
                                dERBs))

    for i, ws in enumerate(ws_list):
        dn = int(np.maximum(1, np.round(8 * (1 - woverlap) * fs / p0[i])))
        # zero-pad for centred frames
        xz = np.concatenate([np.zeros(ws // 2), x,
                             np.zeros(dn + ws // 2)])
        n_frames = (len(xz) - ws) // dn + 1
        idx = np.arange(n_frames)[:, None] * dn + np.arange(ws)[None, :]
        frames = xz[idx] * np.hanning(ws)[None, :]
        X = np.fft.rfft(frames, axis=1)          # (frames, bins)
        f = np.fft.rfftfreq(ws, 1.0 / fs)
        ti = (np.arange(n_frames) * dn) / fs     # frame start times

        # loudness on the ERB grid
        mag = np.abs(X).T                        # (bins, frames)
        interp = np.empty((len(f_erbs), mag.shape[1]))
        for c in range(mag.shape[1]):
            interp[:, c] = np.interp(f_erbs, f, mag[:, c])
        L = np.sqrt(np.maximum(interp, 0.0))

        # candidates this window size participates in
        j = np.nonzero(np.abs(d - (i + 1)) < 1)[0]
        if len(j) == 0:
            continue
        Si = _pitch_strength(f_erbs, L, pc[j])

        # resample Si from ti grid to the output grid
        Si_t = np.empty((len(j), len(t_out)))
        for r in range(len(j)):
            Si_t[r] = np.interp(t_out, ti, Si[r])

        # blend weight: 1 at the window's optimal pitch, ->0 one octave off
        lam = 1.0 - np.abs(d[j] - (i + 1))
        S[j] += lam[:, None] * Si_t

    # best candidate per frame + parabolic refinement over log2(pitch)
    f0 = np.zeros(len(t_out))
    strength = S.max(axis=0)
    arg = S.argmax(axis=0)
    for n in range(len(t_out)):
        if strength[n] < threshold:
            continue
        jmax = arg[n]
        if 0 < jmax < len(pc) - 1:
            s0, s1, s2 = S[jmax - 1, n], S[jmax, n], S[jmax + 1, n]
            denom = s0 - 2 * s1 + s2
            delta = 0.5 * (s0 - s2) / denom if abs(denom) > 1e-12 else 0.0
            delta = np.clip(delta, -0.5, 0.5)
            f0[n] = 2.0 ** (log2pc[jmax] + delta * dlog2p)
        else:
            f0[n] = pc[jmax]
    if otype == "pitch":
        with np.errstate(divide="ignore"):
            out = np.where(f0 > 0, fs / np.where(f0 > 0, f0, 1.0), 0.0)
        return out
    return f0
