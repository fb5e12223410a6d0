#!/usr/bin/env python
"""Resample a directory tree of wavs to one rate, mirroring its layout (the
port's twin of ``scripts/resample_dir.py``)::

    python scripts/resample_dir_torch.py <src_dir> <dst_dir> [--sr 24000]
        [--suffix .wav] [--device cpu]

Each file is resampled by ``ops.resample.resample_poly``: scipy's
polyphase method (the same Kaiser-windowed FIR, padding and trim) run as a
float64 convolution on the device. Runs on CUDA unless ``--device cpu``.
"""
import argparse
import pathlib
import sys
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from golf_tpu_torch.core.device import resolve_device  # noqa: E402
from golf_tpu_torch.ops.resample import resample_poly  # noqa: E402
from golf_tpu_torch.utils.wav import read_wav, write_wav  # noqa: E402


def process(src, dst, target_sr: int, device) -> str:
    x, sr = read_wav(str(src))
    if x.ndim > 1:
        x = x.mean(-1)
    if sr != target_sr:
        x = resample_poly(x, target_sr, sr, device)
    write_wav(str(dst), x.astype(np.float32), target_sr)
    return str(dst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src_dir")
    ap.add_argument("dst_dir")
    ap.add_argument("--sr", type=int, default=24000)
    ap.add_argument("--suffix", default=".wav")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    src_dir = pathlib.Path(args.src_dir)
    dst_dir = pathlib.Path(args.dst_dir)
    for f in sorted(src_dir.glob("**/*" + args.suffix)):
        print(process(f, dst_dir / f.relative_to(src_dir), args.sr, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
