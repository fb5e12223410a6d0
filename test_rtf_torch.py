#!/usr/bin/env python
"""Real-time factor of the PyTorch/CUDA port (golf_tpu_torch), the twin of
``test_rtf.py``: analysis (the encoder) and synthesis (the decoder's ctrl
transforms and the synthesizer, on the phase f0 / sample_rate) of one clip,
each timed over ``--num`` runs with the slowest and fastest dropped
(``utils/timing.py``); RTF = time / duration.

Usage:
    python test_rtf_torch.py --config cfg/ae/vctk.yaml \
        --model cfg/ae/decoder/golf.yaml [--ckpt <run>/ckpt/last] \
        [--wav path.wav] [--duration 6] [--num 10] [--device cpu] \
        [key=value overrides]

``--config`` may also be a run's ``config.yaml``. Without ``--ckpt`` the
weights are the seeded initialisation (``--seed``) with the encoder's
running min/max set from the clip, as ``golf_tpu``'s init does. Without
``--wav`` the clip is seeded noise at 0.1 with f0 180 Hz. It prints the
card's name and power limit, the floor of an empty launch and its sync,
each stage's time, RTF and times real time, and each CUDA kernel's
launches in one synthesis. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from golf_tpu_torch import kernels
from golf_tpu_torch.config.registry import load_config
from golf_tpu_torch.core.device import resolve_device
from golf_tpu_torch.core.sig import Sig
from golf_tpu_torch.tasks.ae import build_voice_autoencoder
from golf_tpu_torch.utils.timing import (card_description, dispatch_floor,
                                         timed_sync)


def load_task(configs: Sequence[str], model: Optional[str] = None,
              overrides: Sequence[str] = (), device=None, seed: int = 0):
    """(task in eval mode, sample rate) from config files as the CLI reads
    them, weights seeded by ``seed``."""
    cfg = load_config(list(configs), model, list(overrides))
    init_args = cfg["model"].get("init_args", cfg["model"])
    torch.manual_seed(seed)
    task = build_voice_autoencoder(init_args, device=resolve_device(device))
    return task.eval(), init_args.get("sample_rate", 24000)


def clip(sr: int, duration: float, wav: Optional[str] = None):
    """(x (1, t), f0 (1, t)) float32: the wav's first ``duration`` seconds
    zero-padded, or seeded noise at 0.1; f0 180 Hz."""
    t = int(duration * sr)
    if wav:
        from golf_tpu_torch.utils.wav import read_wav
        x, file_sr = read_wav(wav)
        if file_sr != sr:
            raise ValueError(f"{wav} is at {file_sr} Hz, the model at {sr}")
        x = x.reshape(-1)[:t].astype(np.float32)
        x = np.pad(x, (0, t - len(x)))
    else:
        x = (np.random.default_rng(0).standard_normal(t) * 0.1).astype(
            np.float32)
    return x[None], np.full((1, t), 180.0, np.float32)


def analysis(task, x: Sig, f0: Sig) -> Dict:
    with torch.inference_mode():
        return task.encoder(x, f0=f0, train=False)


def synthesis(task, raw: Dict, phase: Sig, generator=None,
              noise: Optional[torch.Tensor] = None) -> Sig:
    """The decoder on the raw ``*_params`` groups and the phase."""
    with torch.inference_mode():
        p = task.decoder.apply_ctrl(raw)
        return task.decoder(phase=phase, **p, generator=generator,
                            noise=noise)


def measure(task, x_np: np.ndarray, f0_np: np.ndarray, sr: int,
            num: int = 10, init_stats: bool = True) -> Dict:
    """Times of analysis and synthesis of one clip on the task's device,
    the launch floor, and each kernel's launches in one synthesis."""
    device = next(task.parameters()).device
    x = Sig(torch.from_numpy(x_np).to(device), 1)
    f0 = Sig(torch.from_numpy(f0_np).to(device), 1)
    if init_stats:
        task.init_running_stats(x, f0)
    duration = x_np.shape[-1] / sr
    params = analysis(task, x, f0)
    raw = {k: v for k, v in params.items() if k.endswith("_params")}
    phase = task.cycles(f0)
    gen = torch.Generator(device).manual_seed(3)
    before = {k.name: k.launches for k in kernels.ALL}
    synthesis(task, raw, phase, gen)
    launches = {k.name: k.launches - before[k.name] for k in kernels.ALL
                if k.launches > before[k.name]}
    floor = dispatch_floor(device)
    t_an = timed_sync(analysis, task, x, f0, n=num, device=device)
    t_syn = timed_sync(synthesis, task, raw, phase, gen, n=num,
                       device=device)
    out = {"device": card_description(device), "duration_s": duration,
           "num": num, "floor_ms": floor * 1e3,
           "launches_per_synthesis": launches}
    for name, tt in (("analysis", t_an), ("synthesis", t_syn)):
        out[name] = {"ms": tt * 1e3, "rtf": tt / duration,
                     "x_realtime": duration / tt,
                     "floor_corrected_ms": max(tt - floor, 1e-9) * 1e3}
    return out


def report(out: Dict) -> None:
    print(f"device: {out['device']}  (launch+sync floor "
          f"{out['floor_ms']:.3f} ms)")
    for name in ("analysis", "synthesis"):
        r = out[name]
        print(f"{name:9s}: {r['ms']:8.2f} ms  RTF {r['rtf']:.5f}  "
              f"({r['x_realtime']:8.1f}x realtime)  [floor-corrected "
              f"{r['floor_corrected_ms']:.2f} ms]")
    print(f"launches per synthesis: "
          f"{json.dumps(out['launches_per_synthesis'])}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", action="append", required=True)
    ap.add_argument("--model", default=None,
                    help="YAML file merged into model.init_args")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--wav", default=None)
    ap.add_argument("--duration", type=float, default=6.0)
    ap.add_argument("--num", type=int, default=10)
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
    x_np, f0_np = clip(sr, args.duration, args.wav)
    report(measure(task, x_np, f0_np, sr, args.num,
                   init_stats=not args.ckpt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
