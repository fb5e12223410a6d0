#!/usr/bin/env python
"""CLI entry of the PyTorch/CUDA port (golf_tpu_torch).

Usage:
    python autoencode_torch.py predict --config cfg/ae/vctk.yaml \
        --model cfg/ae/decoder/golf.yaml data.class_path=ltng.data.Synthetic
"""
import sys

from golf_tpu_torch.tasks.cli import run

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
