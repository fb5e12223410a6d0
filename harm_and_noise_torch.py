#!/usr/bin/env python
"""The harmonic and noise branches of a trained model, written apart per
utterance (the PyTorch/CUDA port's twin of ``harm_and_noise.py``): the
encoder, then the decoder's harmonic source and its noise generator and
noise filter, each branch through the end filter alone, over 6 s chunks
crossfaded linearly over 1 s.

Usage:
    python harm_and_noise_torch.py --config runs/<run>/config.yaml \
        [--ckpt runs/<run>/ckpt/last] --wav-dir <dir> --out-dir <dir> \
        [--model <decoder.yaml>] [--device cpu] [key=value overrides]

It reads the test split of a speaker tree (``InferenceDataset``), or every
wav of a directory without one, and writes ``<out-dir>/harm/<rel>`` and
``<out-dir>/noise/<rel>``. Without ``--ckpt`` the weights are seeded and
the encoder's running min/max come from the first chunk. A normal noise
source takes one field drawn from a CPU generator seeded 3 for every
chunk (the same numbers on every device); another source draws from a
generator on the device seeded 3. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from golf_tpu_torch.core.sig import Sig
from golf_tpu_torch.models.noise import StandardNormalNoise
from golf_tpu_torch.tasks.data import InferenceDataset
from golf_tpu_torch.utils.wav import write_wav
from test_rtf_torch import load_task

NOISE_SEED = 3


def crossfade_chunks(chunks, chunk_len: int, overlap: int) -> np.ndarray:
    """Overlap-add of chunks at hop chunk_len - overlap, each fading in
    linearly over ``overlap`` samples while the previous fades out."""
    hop = chunk_len - overlap
    out = np.zeros(hop * (len(chunks) - 1) + chunk_len)
    p = np.arange(overlap) / max(overlap, 1)
    for i, c in enumerate(chunks):
        c = np.asarray(c)[:chunk_len].copy()
        if i:
            out[i * hop: i * hop + overlap] *= 1 - p
            c[:overlap] *= p
        out[i * hop: i * hop + len(c)] += c
    return out


def branches(task, x: Sig, f0: Sig, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(harmonic branch, noise branch), each (B, T) after the end filter,
    on the phase of f0 (150 Hz where unvoiced)."""
    dec = task.decoder
    with torch.inference_mode():
        params = task.encoder(x, f0=f0, train=False)
        params.pop("f0", None)
        params.pop("voicing_logits", None)
        p = dec.apply_ctrl(params)
        harm = dec.harm_oscillator(task.phase_from_f0(f0),
                                   *p["harm_oscillator_params"])
        noise_sig = dec.noise_filter(
            dec.noise_generator(harm, *p["noise_generator_params"],
                                generator=generator, noise=noise),
            *p["noise_filter_params"])
        harm_out = dec.end_filter(harm, *p["end_filter_params"])
        noise_out = dec.end_filter(noise_sig, *p["end_filter_params"])
    return harm_out.data, noise_out.data


def noise_field(task, chunk: int, device) -> Optional[torch.Tensor]:
    """The field every chunk shares when the source is normal noise: a
    chunk's length drawn on the CPU from a generator seeded
    ``NOISE_SEED`` (the harmonic source is as long as its phase); None for
    other sources."""
    if not isinstance(task.decoder.noise_generator, StandardNormalNoise):
        return None
    gen = torch.Generator().manual_seed(NOISE_SEED)
    return torch.randn((1, chunk), generator=gen).to(device)


def utterance(task, x: np.ndarray, f0: np.ndarray, chunk: int, fade: int,
              noise: Optional[torch.Tensor], generator=None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(harm, noise) of one utterance, chunked and crossfaded."""
    device = next(task.parameters()).device
    t = len(x)
    hop = chunk - fade
    n_chunks = max(1, (max(t - chunk, 0) + hop - 1) // hop + 1)
    harms, noises = [], []
    for c in range(n_chunks):
        seg = np.zeros(chunk, np.float32)
        fseg = np.zeros(chunk, np.float32)
        s = c * hop
        e = min(s + chunk, t)
        seg[:e - s] = x[s:e]
        fseg[:e - s] = f0[s:e]
        h, n = branches(task, Sig(torch.from_numpy(seg[None]).to(device), 1),
                        Sig(torch.from_numpy(fseg[None]).to(device), 1),
                        noise, generator)
        harms.append(h[0].cpu().numpy())
        noises.append(n[0].cpu().numpy())
    return (crossfade_chunks(harms, chunk, fade)[:t],
            crossfade_chunks(noises, chunk, fade)[:t])


def run(task, sr: int, wav_dir: str, out_dir: str, chunk_secs: float = 6.0,
        fade_secs: float = 1.0, init_stats: bool = True) -> List[str]:
    """Write every utterance's two branches; returns their relative
    paths."""
    device = next(task.parameters()).device
    chunk = int(chunk_secs * sr)
    fade = int(fade_secs * sr)
    ds = InferenceDataset(wav_dir, "test")
    if len(ds) == 0:
        # a directory with no speaker split: take every wav
        ds = InferenceDataset(wav_dir, "train")
        ds.files = sorted(pathlib.Path(wav_dir).glob("**/*.wav"))
    x0, f00, _ = ds[0]
    xs = Sig(torch.from_numpy(x0[None, :chunk]).to(device), 1)
    f0s = Sig(torch.from_numpy(f00[None, :chunk]).to(device), 1)
    if init_stats:
        task.init_running_stats(xs, f0s)
    noise = noise_field(task, chunk, device)
    generator = None if noise is not None else \
        torch.Generator(device).manual_seed(NOISE_SEED)
    out = pathlib.Path(out_dir)
    rels = []
    for i in range(len(ds)):
        x, f0, rel = ds[i]
        harm, noi = utterance(task, x, f0, chunk, fade, noise, generator)
        write_wav(str(out / "harm" / rel), harm, sr)
        write_wav(str(out / "noise" / rel), noi, sr)
        rels.append(rel)
        print(f"[{i + 1}/{len(ds)}] {rel}")
    return rels


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", action="append", required=True)
    ap.add_argument("--model", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--wav-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--chunk-secs", type=float, default=6.0)
    ap.add_argument("--fade-secs", type=float, default=1.0)
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
    run(task, sr, args.wav_dir, args.out_dir, args.chunk_secs,
        args.fade_secs, init_stats=not args.ckpt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
