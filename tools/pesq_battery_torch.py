#!/usr/bin/env python
"""PESQ862 calibration battery on the port (counterpart of
``tools/pesq_battery.py``: the same degradations and the same JSON bit for
bit, scored by ``golf_tpu_torch.utils.pesq862``, which builds
``native/pesq862.cpp`` at first use and raises if the build fails; no
score is printed without the library).

Quantifies how the from-scratch C++ P.862 (native/pesq862.cpp) tracks the
ITU behavior on a standardized degradation battery. The `pesq` pip
package and the ITU binary cannot enter this zero-egress image, so the
quantitative anchor is the **MNRU ladder** (ITU-T P.810 modulated noise
reference unit) — the condition type P.862 was validated against — with
approximate published MOS-LQO anchor values, plus within-family
monotonicity (rank correlation vs degradation severity) for additive
noise, lowpass, hard clipping, and spectral holes.

Writes JSON to stdout.

Usage:
    python tools/pesq_battery_torch.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FS = 16000

# Approximate published P.862 MOS-LQO values on the MNRU Q ladder
# (ITU-T P.862 was validated to track MNRU conditions; this S-curve is
# the commonly reproduced shape from the P.862/P.862.1 validation data.
# Zero-egress image: values are from-memory literature approximations,
# used for CORRELATION, not absolute-error claims.)
MNRU_ANCHORS = {5: 1.25, 10: 1.6, 15: 2.1, 20: 2.6, 25: 3.1,
                30: 3.55, 35: 3.95, 40: 4.25, 45: 4.45}


def speech_like(seconds=4.0, seed=0, fs=FS):
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    f0 = 140.0 + 60.0 * np.sin(2 * np.pi * 0.7 * t + seed)
    phase = np.cumsum(f0) / fs
    env = (np.sin(2 * np.pi * 1.3 * t + 2 * seed) ** 2) * \
        (np.sin(2 * np.pi * 0.31 * t + seed) > -0.2)
    x = env * sum(np.sin(2 * np.pi * k * phase + 0.1 * k * k) / k
                  for k in range(1, 40))
    x = x + 0.002 * rng.standard_normal(len(t))
    return (x * 0.1).astype(np.float32)


def mnru(x, q_db, seed=0):
    """P.810 MNRU: speech-amplitude-modulated gaussian noise at Q dB."""
    rng = np.random.default_rng(1000 + seed)
    n = rng.standard_normal(len(x)).astype(np.float32)
    return (x * (1.0 + 10.0 ** (-q_db / 20.0) * n)).astype(np.float32)


def add_noise(x, snr_db, seed=0):
    rng = np.random.default_rng(2000 + seed)
    n = rng.standard_normal(len(x))
    n *= np.sqrt((x ** 2).mean() / (n ** 2).mean() / 10 ** (snr_db / 10))
    return (x + n).astype(np.float32)


def lowpass(x, cutoff_hz, fs=FS):
    from scipy.signal import butter, sosfiltfilt
    sos = butter(8, cutoff_hz / (fs / 2), output="sos")
    return sosfiltfilt(sos, x).astype(np.float32)


def clip(x, frac):
    lim = frac * np.abs(x).max()
    return np.clip(x, -lim, lim).astype(np.float32)


def spectral_holes(x, n_holes, seed=0, fs=FS):
    rng = np.random.default_rng(3000 + seed)
    X = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    for _ in range(n_holes):
        lo = rng.uniform(300, fs / 2 - 800)
        X[(freqs >= lo) & (freqs < lo + 500)] = 0
    return np.fft.irfft(X, len(x)).astype(np.float32)


def spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum() /
                 np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))


def pearson(a, b):
    a = np.asarray(a, float) - np.mean(a)
    b = np.asarray(b, float) - np.mean(b)
    return float((a * b).sum() / np.sqrt((a ** 2).sum() * (b ** 2).sum()))


def main() -> int:
    from golf_tpu_torch.utils import pesq862
    pesq862.library()

    n_seeds = 3
    out = {"fs": FS, "mode": "wb", "n_seeds": n_seeds}

    # ---- MNRU ladder vs published anchors --------------------------------
    qs = sorted(MNRU_ANCHORS)
    mnru_scores = []
    for q in qs:
        s = [pesq862.pesq(speech_like(seed=i), mnru(speech_like(seed=i),
                                                    q, seed=i), FS, "wb")
             for i in range(n_seeds)]
        mnru_scores.append(float(np.mean(s)))
    anchors = [MNRU_ANCHORS[q] for q in qs]
    out["mnru"] = {
        "q_db": qs, "pesq862": [round(v, 3) for v in mnru_scores],
        "anchor_mos_lqo": anchors,
        "spearman_vs_anchor": round(spearman(mnru_scores, anchors), 4),
        "pearson_vs_anchor": round(pearson(mnru_scores, anchors), 4),
        "max_abs_dev": round(float(np.max(np.abs(
            np.asarray(mnru_scores) - np.asarray(anchors)))), 3),
        "mean_abs_dev": round(float(np.mean(np.abs(
            np.asarray(mnru_scores) - np.asarray(anchors)))), 3),
    }

    # ---- within-family monotonicity --------------------------------------
    fams = {}

    def family(name, degrade, severities):
        scores = []
        for sev in severities:
            s = [pesq862.pesq(speech_like(seed=i),
                              degrade(speech_like(seed=i), sev, i), FS, "wb")
                 for i in range(n_seeds)]
            scores.append(float(np.mean(s)))
        fams[name] = {
            "severity": list(severities),
            "pesq862": [round(v, 3) for v in scores],
            # severity is ordered mild -> harsh, so perfect tracking is -1
            "spearman_vs_severity": round(
                spearman(scores, list(range(len(severities)))), 4),
        }

    family("additive_noise_snr_db",
           lambda x, snr, i: add_noise(x, snr, i),
           [40, 30, 20, 10, 5, 0][::-1])       # harsh -> mild
    fams["additive_noise_snr_db"]["note"] = (
        "severity listed as SNR ascending, so spearman +1 is correct")
    family("lowpass_cutoff_hz",
           lambda x, c, i: lowpass(x, c),
           [5000, 3000, 2000, 1000, 500][::-1])  # ascending cutoff
    fams["lowpass_cutoff_hz"]["note"] = (
        "ascending cutoff = decreasing severity; spearman +1 is correct")
    family("clip_fraction",
           lambda x, f, i: clip(x, f),
           [0.5, 0.25, 0.12, 0.06])              # descending = harsher
    family("spectral_holes_n",
           lambda x, n, i: spectral_holes(x, int(n), i),
           [1, 2, 4, 8])                          # ascending = harsher
    out["families"] = fams

    # expectations: noise/lowpass severity lists were reversed to
    # ascending-quality, so +1 is ideal there; clip/holes lists are
    # ascending-severity, so -1 is ideal
    ideals = {"additive_noise_snr_db": 1.0, "lowpass_cutoff_hz": 1.0,
              "clip_fraction": -1.0, "spectral_holes_n": -1.0}
    ok = all(
        fams[k]["spearman_vs_severity"] * ideals[k] >= 0.9 for k in ideals)
    out["within_family_rank_ok"] = bool(ok)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
