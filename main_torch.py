#!/usr/bin/env python
"""CLI entry of the PyTorch/CUDA port (golf_tpu_torch) for the ISMIR23 mel
vocoder (``DDSPVocoder``; ``cfg/vocoder.yaml`` unless ``--config`` names
another) and the LPCNet baseline (``--config cfg/lpcnet.yaml``).

Usage:
    python main_torch.py fit --model cfg/ae/decoder/golf-v1.yaml \
        data.init_args.wav_dir=<MPop600 f1 tree>
    python main_torch.py fit --config cfg/lpcnet.yaml \
        data.init_args.wav_dir=<LJSpeech tree>
    python main_torch.py validate ... --ckpt_path <run_dir>/ckpt/last
    python main_torch.py test ... [--ckpt_path <run_dir>/ckpt/last]
    python main_torch.py predict ... [--ckpt_path <run_dir>/ckpt/last]

LPCNet's ``test`` adds the autoregressive resynthesis of the first batches
to the teacher-forced metrics; it has no ``predict`` (as in golf_tpu).

Add ``--device cpu`` to run on the CPU.
"""
import sys

from golf_tpu_torch.tasks.cli import run

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], default_config="cfg/vocoder.yaml"))
