#!/usr/bin/env python
"""CLI entry of the PyTorch/CUDA port (golf_tpu_torch).

Usage:
    python autoencode_torch.py fit --config cfg/ae/vctk.yaml \
        --model cfg/ae/decoder/golf.yaml data.class_path=ltng.data.Synthetic
    python autoencode_torch.py validate ... --ckpt_path <run_dir>/ckpt/last
    python autoencode_torch.py test ... [--ckpt_path <run_dir>/ckpt/last]
    python autoencode_torch.py predict ... [--ckpt_path <run_dir>/ckpt/last]
    python autoencode_torch.py test|predict --config cfg/ae/pyworld.yaml \
        data.init_args.wav_dir=<VCTK tree>

The WORLD baseline (``cfg/ae/pyworld.yaml``) has no weights: ``test`` and
``predict`` only.

Add ``--device cpu`` to run on the CPU.
"""
import sys

from golf_tpu_torch.tasks.cli import run

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
