#!/usr/bin/env python
"""Harmonic/noise decomposition statistics on the port's host I/O
(counterpart of ``tools/harm_noise_stats.py``: the same numpy, the same
JSON line bit for bit; reference
``notebooks/tismir/ablation.ipynb`` cells 1-4): given the per-utterance
harmonic and noise branch exports written by ``harm_and_noise.py``
(``<dir>/harm/<rel>`` / ``<dir>/noise/<rel>``, as
``harm_and_noise_torch.py`` writes them too), compute

* the mean power spectrum of each branch (mel-cepstrally smoothed with
  order 35, as the notebook does via pysptk sp2mc/mc2sp), and
* the spectral cosine DISTANCE 1 - cos(harm, noise) below 6 kHz — the
  ablation's leakage measure (high distance = clean separation).

Prints one JSON line; optionally saves the smoothed mean spectra.
"""
import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def stft_power(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    n = (len(x) - n_fft) // hop + 1
    if n < 1:
        x = np.pad(x, (0, n_fft - len(x)))
        n = 1
    w = np.hanning(n_fft)
    frames = np.stack([x[i * hop:i * hop + n_fft] * w for i in range(n)])
    return np.abs(np.fft.rfft(frames, n_fft)) ** 2  # (F, n_fft//2+1)


def mcep_smooth(power_mean: np.ndarray, n_fft: int, order: int = 35
                ) -> np.ndarray:
    """Cepstrally-smoothed log power spectrum — pysptk
    ``mc2sp(sp2mc(sp, 35, 0.0), 0.0, n_fft)`` with alpha=0 reduces to a
    plain order-35 cepstral lifter of log(sp)."""
    logsp = np.log(np.maximum(power_mean, 1e-20))
    c = np.fft.irfft(logsp, n_fft)               # real cepstrum
    lift = np.concatenate([c[:1], 2 * c[1:order + 1]])
    w = np.arange(n_fft // 2 + 1) * (2 * np.pi / n_fft)
    m = np.arange(order + 1)
    return lift @ np.cos(np.outer(m, w))         # smoothed log power


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", help="directory with *.harm.wav / *.noise.wav")
    ap.add_argument("--sr", type=int, default=24000)
    ap.add_argument("--n_fft", type=int, default=1024)
    ap.add_argument("--hop", type=int, default=256)
    ap.add_argument("--lowpass_hz", type=float, default=6000.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from golf_tpu_torch.utils.wav import read_wav

    d = pathlib.Path(args.dir)
    harm_specs, noise_specs = [], []
    n_utts = 0
    # harm_and_noise.py writes <dir>/harm/<rel> and <dir>/noise/<rel>
    for hp in sorted((d / "harm").glob("**/*.wav")):
        np_ = d / "noise" / hp.relative_to(d / "harm")
        if not np_.exists():
            continue
        h, _ = read_wav(str(hp))
        n, _ = read_wav(str(np_))
        harm_specs.append(stft_power(np.asarray(h, np.float64),
                                     args.n_fft, args.hop))
        noise_specs.append(stft_power(np.asarray(n, np.float64),
                                      args.n_fft, args.hop))
        n_utts += 1
    if not n_utts:
        raise SystemExit(f"no harm/noise wav pairs under {d}/harm,noise")

    hcat = np.concatenate(harm_specs, axis=0)
    ncat = np.concatenate(noise_specs, axis=0)
    # notebook: cosine over the (bins x frames) magnitude matrices,
    # restricted below the lowpass bin
    lp = int(args.n_fft * args.lowpass_hz / args.sr)

    def cos_dist(a, b):
        x = np.sqrt(a)[:, :lp].ravel()
        y = np.sqrt(b)[:, :lp].ravel()
        return float(1.0 - (x @ y) / np.sqrt((x @ x) * (y @ y)))

    h_mean = mcep_smooth(hcat.mean(axis=0), args.n_fft)
    n_mean = mcep_smooth(ncat.mean(axis=0), args.n_fft)
    report = {
        "n_utts": n_utts,
        "cosine_distance_lt6k": cos_dist(hcat, ncat),
        "harm_mean_db_peak": float(10 / np.log(10) * h_mean.max()),
        "noise_mean_db_peak": float(10 / np.log(10) * n_mean.max()),
        "n_fft": args.n_fft, "hop": args.hop,
    }
    print(json.dumps(report))
    if args.out:
        np.savez(args.out, harm_mean_logsp=h_mean, noise_mean_logsp=n_mean)
    return 0


if __name__ == "__main__":
    sys.exit(main())
