#!/usr/bin/env python
"""A model's per-frame controls of one utterance, saved as npz (the
PyTorch/CUDA port's twin of ``biquads.py``): the end filter's ``gain`` and
``lpc`` with the LPC factored into biquad sections (``biquads``, when
every frame has as many), the wavetable's ``table_weight``, and the
encoder's ``voicing`` (sigmoid of its logits) and ``f0`` when it learns
them.

Usage:
    python biquads_torch.py --config runs/<run>/config.yaml \
        [--ckpt runs/<run>/ckpt/last] --wav in.wav --out out.npz \
        [--model <decoder.yaml>] [--device cpu] [key=value overrides]

The encoder reads the wav with f0 150 Hz. Without ``--ckpt`` the weights
are seeded and the running min/max come from the wav. Runs on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from golf_tpu_torch.core.sig import Sig
from golf_tpu_torch.utils.wav import read_wav
from test_rtf_torch import load_task


def lpc_biquads(lpc: np.ndarray) -> Optional[np.ndarray]:
    """(frames, p) LPC -> (frames, sections, 3) biquads [1, -2 Re r,
    |r|^2] of the complex roots in the upper half plane, or None when the
    frames have different numbers of sections."""
    biquads = []
    for frame in lpc:
        roots = np.roots(np.concatenate([[1.0], frame]))
        roots = roots[np.imag(roots) >= 0]
        sec = [np.array([1.0, -2 * r.real, abs(r) ** 2])
               if r.imag > 1e-9 else None for r in roots]
        biquads.append([s for s in sec if s is not None])
    if biquads and all(len(b) == len(biquads[0]) for b in biquads):
        return np.asarray(biquads)
    return None


def extract(task, wav: np.ndarray, init_stats: bool = True
            ) -> Dict[str, np.ndarray]:
    """The npz's arrays for one waveform (1-D)."""
    device = next(task.parameters()).device
    x = Sig(torch.from_numpy(wav.reshape(1, -1)).to(device), 1)
    f0 = Sig(torch.full((1, wav.size), 150.0, device=device), 1)
    if init_stats:
        task.init_running_stats(x, f0)
    with torch.inference_mode():
        raw = task.encoder(x, f0=f0, train=False)
        voicing = raw.pop("voicing_logits", None)
        f0_hat = raw.pop("f0", None)
        params = task.decoder.apply_ctrl(raw)
    arrays: Dict[str, np.ndarray] = {}
    ef = params.get("end_filter_params", ())
    if len(ef) == 2:
        gain, a = ef
        arrays["gain"] = gain.data.cpu().numpy()
        arrays["lpc"] = a.data.cpu().numpy()
        bq = lpc_biquads(arrays["lpc"][0])
        if bq is not None:
            arrays["biquads"] = bq
    ho = params.get("harm_oscillator_params", ())
    if len(ho) >= 1:
        arrays["table_weight"] = ho[0].data.cpu().numpy()
    if voicing is not None:
        arrays["voicing"] = torch.sigmoid(voicing.data).cpu().numpy()
    if f0_hat is not None:
        arrays["f0"] = f0_hat.data.cpu().numpy()
    return arrays


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", action="append", required=True)
    ap.add_argument("--model", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--wav", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)

    task, sr = load_task(args.config, args.model, args.overrides,
                         args.device, args.seed)
    if args.ckpt:
        from golf_tpu_torch.train.checkpoint import restore_params_into
        restore_params_into(args.ckpt, task)
    wav, fsr = read_wav(args.wav)
    if fsr != sr:
        raise ValueError(f"{args.wav} is at {fsr} Hz, the model at {sr}")
    arrays = extract(task, wav.astype(np.float32), init_stats=not args.ckpt)
    np.savez(args.out, **arrays)
    print(f"saved {sorted(arrays)} to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
