#!/usr/bin/env python
"""Classic-LPC low anchor for listening tests, on the port (counterpart of
``tools/lpc_anchor.py``; reference
``notebooks/interspeech/listening-samples.ipynb`` "SPTK LPC baseline":
pysptk ``lpc`` analysis + ``excite`` pulse/noise excitation +
``Synthesizer(AllPoleDF)`` resynthesis).

Per utterance: Blackman-windowed frame LPC via autocorrelation+Levinson
(gain = sqrt residual energy, stored as log like the notebook), a
pulse-train (voiced, amplitude sqrt(period)) / unit-variance gaussian
(unvoiced) excitation, and sample-wise all-pole synthesis with
frame-interpolated coefficients (the AllPoleDF behavior). The host stages
are the JAX tool's numpy, unchanged; the filter is
``golf_tpu_torch.ops.allpole.allpole`` on one row, (1, T) x (1, T, order):
on a CUDA device the time-varying all-pole kernel, on the CPU its plain
version. The f0 track, when not given, is ``utils.world_lite.dio``'s.

Usage (CUDA unless ``--device cpu``):
    python tools/lpc_anchor_torch.py in.wav out.wav [--f0 in.pv]
        [--order 26] [--frame_length 1024] [--hop 80] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def lpc_analysis(x: np.ndarray, frame_length: int, hop: int, order: int
                 ) -> np.ndarray:
    """(T,) -> (frames, order+1): [log gain, a_1..a_order] per frame."""
    pad = frame_length // 2
    xp = np.pad(x.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = (len(xp) - frame_length) // hop + 1
    idx = (np.arange(n_frames)[:, None] * hop
           + np.arange(frame_length)[None, :])
    frames = xp[idx] * np.blackman(frame_length)
    # autocorrelation method + Levinson-Durbin
    spec = np.abs(np.fft.rfft(frames, 2 * frame_length)) ** 2
    r = np.fft.irfft(spec)[:, :order + 1]
    r[:, 0] += 1e-9 * (1.0 + r[:, 0])
    out = np.zeros((n_frames, order + 1))
    for f in range(n_frames):
        a = np.zeros(order + 1)
        a[0] = 1.0
        e = r[f, 0]
        for i in range(1, order + 1):
            k = -(r[f, i] + a[1:i] @ r[f, i - 1:0:-1]) / e
            a[1:i + 1] = a[1:i + 1] + k * a[i - 1::-1][:i]
            e *= (1.0 - k * k)
            if e <= 0:
                e = 1e-12
        out[f, 0] = 0.5 * np.log(max(e, 1e-12))     # log gain
        out[f, 1:] = a[1:]
    return out


def excite(pitch: np.ndarray, hop: int, seed: int = 0) -> np.ndarray:
    """pysptk.excite semantics: per-frame pitch period in SAMPLES (0 =
    unvoiced). Voiced: impulses of amplitude sqrt(period) at running
    pitch marks; unvoiced: unit-variance gaussian."""
    rng = np.random.default_rng(seed)
    t_total = len(pitch) * hop
    ex = np.zeros(t_total)
    phase = 1.0  # next-pulse countdown in periods
    for f, p in enumerate(pitch):
        s0 = f * hop
        if p <= 0:
            ex[s0:s0 + hop] = rng.standard_normal(hop)
            phase = 1.0
            continue
        for i in range(hop):
            phase += 1.0 / p
            if phase >= 1.0:
                phase -= 1.0
                ex[s0 + i] = np.sqrt(p)
    return ex


def interpolate(lpc: np.ndarray, ex: np.ndarray, hop: int):
    """Linear per-sample coefficient interpolation between frames
    (AllPoleDF behavior): the gained excitation (T,) and the coefficients
    (T, order), float64."""
    n_frames, oc = lpc.shape
    t = min(len(ex), n_frames * hop)
    fpos = np.arange(t) / hop
    f0i = np.clip(np.floor(fpos).astype(int), 0, n_frames - 1)
    f1i = np.clip(f0i + 1, 0, n_frames - 1)
    w = (fpos - f0i)[:, None]
    coef = lpc[f0i] * (1 - w) + lpc[f1i] * w          # (T, order+1)
    gain = np.exp(coef[:, 0])
    return ex[:t] * gain, coef[:, 1:]


def synth(lpc: np.ndarray, ex: np.ndarray, hop: int, device) -> np.ndarray:
    """Sample-wise all-pole on ``device`` of the interpolated frames, in
    float32 as the JAX tool's."""
    import torch

    from golf_tpu_torch.ops.allpole import allpole

    src, a = interpolate(lpc, ex, hop)
    x = torch.as_tensor(src[None], dtype=torch.float32, device=device)
    a = torch.as_tensor(a[None], dtype=torch.float32, device=device)
    with torch.no_grad():
        y = allpole(x, a.contiguous())
    return y[0].cpu().numpy()


def excitation(x: np.ndarray, sr: int, f0: np.ndarray | None = None,
               order: int = 26, frame_length: int = 1024, hop: int = 80,
               seed: int = 0):
    """The analysis frames and the excitation of one utterance: (lpc
    (frames, order + 1), excitation (frames hop,)); f0 is a 5 ms-hop track
    in Hz (computed with world-lite DIO when absent)."""
    if f0 is None:
        from golf_tpu_torch.utils.world_lite import dio
        f0, _ = dio(x.astype(np.float64), sr)
    lpc = lpc_analysis(x, frame_length, hop, order)
    # 5 ms f0 track -> per-analysis-frame pitch periods (samples)
    pos = np.arange(lpc.shape[0]) * hop / (0.005 * sr)
    fi = np.clip(pos.astype(int), 0, len(f0) - 1)
    f0_frames = np.asarray(f0)[fi]
    pitch = np.where(f0_frames > 0, sr / np.maximum(f0_frames, 1.0), 0.0)
    return lpc, excite(pitch, hop, seed=seed)


def anchor(x: np.ndarray, sr: int, f0: np.ndarray | None = None,
           order: int = 26, frame_length: int = 1024, hop: int = 80,
           seed: int = 0, device=None) -> np.ndarray:
    """Full anchor chain on one utterance; f0 is a 5 ms-hop track in Hz
    (computed with world-lite DIO when absent). The filter runs on
    ``device`` (CUDA unless given)."""
    from golf_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    lpc, ex = excitation(x, sr, f0, order, frame_length, hop, seed)
    y = synth(lpc, ex, hop, device)[:len(x)]
    peak = np.abs(y).max()
    if peak > 1.0:
        y = y / peak
    return y.astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("in_wav")
    ap.add_argument("out_wav")
    ap.add_argument("--f0", default=None, help=".pv file (5 ms hop, Hz)")
    ap.add_argument("--order", type=int, default=26)
    ap.add_argument("--frame_length", type=int, default=1024)
    ap.add_argument("--hop", type=int, default=80)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from golf_tpu_torch.utils.wav import read_wav, write_wav
    x, sr = read_wav(args.in_wav)
    if x.ndim > 1:
        x = x.mean(-1)
    f0 = np.loadtxt(args.f0) if args.f0 else None
    y = anchor(x.reshape(-1), sr, f0, args.order, args.frame_length,
               args.hop, device=args.device)
    write_wav(args.out_wav, y, sr)
    print(f"wrote {args.out_wav}: {len(y)} samples @ {sr} Hz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
