#!/usr/bin/env python
"""PESQ over mirrored directory trees (the PyTorch/CUDA port's twin of
``eval_pesq.py``): each matched pair is read, resampled to 16 kHz on the
device (``ops.resample.resample_poly``, scipy's polyphase method), scored
wide-band, and the mean and standard deviation are printed.

Usage:
    python eval_pesq_torch.py <ref_dir> <deg_dir> [--suffix .wav]
        [--workers 8] [--device cpu]

The score is the ITU ``pesq`` package's when it is installed (label
``PESQ``), else the native P.862 of ``native/pesq862.cpp`` (label
``PESQ(p862-native)``), built at first use; a failed build raises, and
there is no proxy metric. Pairs are scored in ``--workers`` threads (the
native call releases the GIL). Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from multiprocessing.pool import ThreadPool
from typing import List, Optional

import numpy as np

from golf_tpu_torch.core.device import resolve_device
from golf_tpu_torch.ops.resample import resample_poly
from golf_tpu_torch.utils import pesq862 as _pesq862
from golf_tpu_torch.utils.wav import read_wav

try:
    from pesq import pesq as _pesq  # the ITU C library, when installed
    HAS_PESQ = True
except ImportError:
    HAS_PESQ = False

FS = 16000


def label() -> str:
    return "PESQ" if HAS_PESQ else "PESQ(p862-native)"


def score_pair(pair, device="cpu") -> float:
    ref_path, deg_path = pair
    ref, sr1 = read_wav(str(ref_path))
    deg, sr2 = read_wav(str(deg_path))
    ref = resample_poly(ref.reshape(-1), FS, sr1, device)
    deg = resample_poly(deg.reshape(-1), FS, sr2, device)
    n = min(len(ref), len(deg))
    if HAS_PESQ:
        return _pesq(FS, ref[:n], deg[:n], "wb")
    return _pesq862.pesq(ref[:n], deg[:n], FS, "wb")


def matched_pairs(ref_dir, deg_dir, suffix: str = ".wav") -> list:
    ref_dir, deg_dir = pathlib.Path(ref_dir), pathlib.Path(deg_dir)
    pairs = []
    for deg in sorted(deg_dir.glob("**/*" + suffix)):
        ref = ref_dir / deg.relative_to(deg_dir)
        if ref.exists():
            pairs.append((ref, deg))
    return pairs


def evaluate(ref_dir, deg_dir, suffix: str = ".wav", workers: int = 8,
             device="cpu") -> np.ndarray:
    pairs = matched_pairs(ref_dir, deg_dir, suffix)
    if not pairs:
        raise SystemExit("no matched file pairs")
    if not HAS_PESQ:
        _pesq862.library()          # built once, before the threads
    with ThreadPool(workers) as pool:
        return np.asarray(pool.map(lambda p: score_pair(p, device), pairs))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ref_dir")
    ap.add_argument("deg_dir")
    ap.add_argument("--suffix", default=".wav")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    scores = evaluate(args.ref_dir, args.deg_dir, args.suffix, args.workers,
                      device)
    print(f"{label()}: {scores.mean():.3f} +/- {scores.std():.3f} "
          f"(n={len(scores)})")
    if not HAS_PESQ:
        print("# p862-native is rank-calibrated (Spearman 1.0 on every "
              "battery family) but absolutely lenient on speech-"
              "modulated noise; compare only against same-pipeline "
              "baselines (docs/PESQ862.md)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
