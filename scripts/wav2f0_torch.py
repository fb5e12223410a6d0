#!/usr/bin/env python
"""Batch f0 extraction to ``.pv`` text files, one f0 a 5 ms hop (the port's
twin of ``scripts/wav2f0.py``)::

    python scripts/wav2f0_torch.py <wav_dir> [--method dio|native|swipe|penn]
        [--f0-floor 65] [--f0-ceil 1047] [--workers 4] [--device cpu]

Methods: ``dio`` (default; the numpy DIO of ``utils/world_lite.py``),
``native`` (the C++ YIN of ``native/worldlite.cpp``, built at first use),
``swipe`` (SWIPE', ``utils/swipe.py``) and ``penn`` (the shipped PitchNet
on the card, gated at periodicity 0.065, then to [floor, ceil]). The host
methods run in ``--workers`` processes; ``penn`` runs in this process, its
frames in batches of 512 on the device. Runs on CUDA unless
``--device cpu``.
"""
import argparse
import pathlib
import sys
import multiprocessing

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from golf_tpu_torch.core.device import resolve_device  # noqa: E402
from golf_tpu_torch.utils import native  # noqa: E402
from golf_tpu_torch.utils.wav import read_wav  # noqa: E402


def estimate(x: np.ndarray, sr: int, floor: float, ceil: float,
             method: str, device: str = "cpu") -> np.ndarray:
    """One mono waveform's f0 track (Hz, 0 where unvoiced)."""
    if method == "swipe":
        from golf_tpu_torch.utils.swipe import swipe
        return swipe(x.astype(np.float64), sr, hopsize=int(sr * 5 / 1000),
                     min=floor, max=ceil, otype="f0")
    if method == "penn":
        from golf_tpu_torch.utils.pitchnet import predict
        f0, _ = predict(x, sr, hop_ms=5.0, device=device)
        return np.where((f0 >= floor) & (f0 <= ceil), f0, 0.0)
    f0, _ = native.dio(x.astype(np.float64), sr, f0_floor=floor,
                       f0_ceil=ceil, frame_period=5.0,
                       method="yin" if method == "native" else "dio")
    return f0


def process(task) -> str:
    path, out_path, floor, ceil, method, device = task
    x, sr = read_wav(str(path))
    if x.ndim > 1:
        x = x.mean(-1)
    np.savetxt(out_path, estimate(x, sr, floor, ceil, method, device),
               fmt="%.3f")
    return str(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("wav_dir")
    ap.add_argument("--suffix", default=".wav")
    ap.add_argument("--f0-floor", type=float, default=65.0)
    ap.add_argument("--f0-ceil", type=float, default=1047.0)
    ap.add_argument("--method", default="dio",
                    choices=["dio", "native", "swipe", "penn"])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = str(resolve_device(args.device))
    wav_dir = pathlib.Path(args.wav_dir)
    tasks = [(f, f.with_suffix(".pv"), args.f0_floor, args.f0_ceil,
              args.method, device)
             for f in sorted(wav_dir.glob("**/*" + args.suffix))]
    if args.method == "penn":
        for task in tasks:
            print(process(task))
        return 0
    if args.method == "native":
        native.build_host_library("worldlite.cpp")   # once, before the pool
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        for name in pool.imap_unordered(process, tasks):
            print(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
