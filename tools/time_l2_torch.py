#!/usr/bin/env python
"""Phase-aligned time-domain L2 analysis on the port (counterpart of
``tools/time_l2.py``; reference ``notebooks/ismir/time_l2.ipynb``): freeze
a trained autoencoder, attach learnable per-frame phase offsets
(wrapped-difference smoothing, ``ops.dsp.smooth_phase_offset``, reference
``models/utils.py:547-554``), and optimize them with Adam to minimize the
time-domain MSE between resynthesis and target.

The encoder runs once, in eval mode and without a gradient; the task's
parameters take none either, so only the offsets do. The phase is the
item's f0 with its unvoiced frames at 150 Hz (``task.phase_from_f0``) plus
the upsampled smoothed offsets. Every iteration decodes on the same noise:
a normal noise source takes one field drawn once from a CPU generator
seeded ``NOISE_SEED`` (the same numbers on every device), another source
draws from a generator on the device re-seeded before each decode. The
update is optax's ``adam(lr)`` (``ClippedOptimizer.apply_update``: no
clip, no finite guard, no schedule), and the best offsets so far are kept
with the loss before their update, as the JAX tool keeps them.

``--ckpt`` is a checkpoint of the port (``train/checkpoint.py``); a
``golf_tpu`` orbax checkpoint goes through ``tools/orbax_to_torch.py``
first. Runs on CUDA unless ``--device cpu``::

  python tools/time_l2_torch.py --config cfg/ae/synthetic-mid.yaml \\
      --model cfg/ae/decoder/golf.yaml --ckpt runs/<run>/ckpt/last \\
      [--item 0] [--iters 500] [--lr 1e-3] [--offset_hop 1200] [--out x.wav]

Prints one JSON line: initial/final time-domain MSE/L2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from golf_tpu_torch.config.registry import (  # noqa: E402
    instantiate, load_config)
from golf_tpu_torch.core.device import resolve_device  # noqa: E402
from golf_tpu_torch.core.sig import Sig, linear_upsample  # noqa: E402
from golf_tpu_torch.models.noise import StandardNormalNoise  # noqa: E402
from golf_tpu_torch.ops.dsp import smooth_phase_offset  # noqa: E402
from golf_tpu_torch.tasks.ae import build_voice_autoencoder  # noqa: E402
from golf_tpu_torch.train.checkpoint import restore_params_into  # noqa: E402
from golf_tpu_torch.train.loop import ClippedOptimizer  # noqa: E402

NOISE_SEED = 1


def load(config: str, model: str, ckpt: str, device=None):
    """(frozen task in eval mode, data module, sample rate): the config
    with ``model`` merged into ``model.init_args``, the checkpoint's
    weights."""
    cfg = load_config([config], model)
    init = cfg["model"]["init_args"]
    task = build_voice_autoencoder(init, device=resolve_device(device))
    restore_params_into(ckpt, task)
    task.eval().requires_grad_(False)
    return task, instantiate(cfg["data"]), init.get("sample_rate", 24000)


def encode(task, x: Sig, f0: Sig) -> Dict:
    """The encoder's parameters once, frozen; the voicing logits become
    the voicing, the predicted f0 is dropped."""
    with torch.no_grad():
        enc = dict(task.encoder(x, f0=f0, train=False))
    enc.pop("f0", None)
    vlog = enc.pop("voicing_logits", None)
    if vlog is not None:
        enc["voicing"] = Sig(torch.sigmoid(vlog.data), vlog.hop)
    return enc


def noise_field(task, t: int, device) -> Optional[torch.Tensor]:
    """The field every decode shares when the source is normal noise (the
    harmonic source is as long as its phase); None for other sources."""
    if not isinstance(task.decoder.noise_generator, StandardNormalNoise):
        return None
    gen = torch.Generator().manual_seed(NOISE_SEED)
    return torch.randn((1, t), generator=gen).to(device)


class PhaseOffsetL2:
    """The frozen model's decode of one item with phase offsets, and the
    time-domain MSE against the item."""

    def __init__(self, task, x: torch.Tensor, f0: torch.Tensor,
                 offset_hop: int, noise: Optional[torch.Tensor] = None):
        self.task = task
        self.x = x
        self.offset_hop = offset_hop
        self.enc = encode(task, Sig(x, 1), Sig(f0, 1))
        self.phase0 = task.phase_from_f0(Sig(f0, 1)).data      # (1, T)
        self.noise = noise_field(task, self.phase0.shape[1], x.device) \
            if noise is None else noise.to(x.device)
        self.generator = torch.Generator(x.device)

    def decode(self, offsets: torch.Tensor) -> torch.Tensor:
        off = smooth_phase_offset(offsets)
        up = linear_upsample(off, self.offset_hop)
        t = min(up.shape[1], self.phase0.shape[1])
        params = dict(self.enc)
        params["phase"] = Sig(self.phase0[:, :t] + up[:, :t], 1)
        self.generator.manual_seed(NOISE_SEED)
        return self.task._decode(params, generator=self.generator,
                                 noise=self.noise).data[0]

    def loss(self, offsets: torch.Tensor) -> torch.Tensor:
        y = self.decode(offsets)
        t = min(y.shape[0], self.x.shape[1])
        return torch.mean((y[:t] - self.x[0, :t]) ** 2)

    def loss_and_grad(self, offsets: torch.Tensor):
        offsets = offsets.detach().requires_grad_(True)
        loss = self.loss(offsets)
        (grad,) = torch.autograd.grad(loss, offsets)
        return loss.detach(), grad

    def initial_offsets(self) -> torch.Tensor:
        n_off = self.x.shape[1] // self.offset_hop + 2
        return torch.zeros((1, n_off), dtype=torch.float32,
                           device=self.x.device)


def optimize(obj: PhaseOffsetL2, iters: int, lr: float):
    """Adam on the offsets from zero; returns (initial loss, best loss,
    the offsets kept with it)."""
    offsets = obj.initial_offsets()
    opt = ClippedOptimizer([offsets], lr=lr, grad_clip=0.0,
                           optimizer="adam")
    l0 = None
    best = None
    for i in range(iters):
        loss, grad = obj.loss_and_grad(offsets)
        value = float(loss)
        if l0 is None:
            l0 = value
            best = (l0, offsets.clone())
        opt.apply_update([grad])
        if value < best[0]:
            best = (value, offsets.clone())
        if i % 100 == 0:
            print(f"# iter {i}: mse {value:.6f}", file=sys.stderr)
    if l0 is None:
        with torch.no_grad():
            l0 = float(obj.loss(offsets))
        best = (l0, offsets)
    return l0, best[0], best[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="cfg/ae/synthetic-mid.yaml")
    ap.add_argument("--model", default="cfg/ae/decoder/golf.yaml")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--item", type=int, default=0)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--offset_hop", type=int, default=1200,
                    help="phase-offset frame hop (reference uses 1200)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    task, dm, sr = load(args.config, args.model, args.ckpt, args.device)
    dm.setup("test")
    x_np, f0_np = dm.test_dataset[args.item]
    device = next(task.parameters()).device
    x = torch.from_numpy(np.asarray(x_np, np.float32))[None].to(device)
    f0 = torch.from_numpy(np.asarray(f0_np, np.float32))[None].to(device)
    obj = PhaseOffsetL2(task, x, f0, args.offset_hop)
    l0, best, offsets = optimize(obj, args.iters, args.lr)
    with torch.no_grad():
        y = obj.decode(offsets).cpu().numpy()
    t = min(len(y), x.shape[1])
    report = {
        "initial_mse": l0, "final_mse": best,
        "initial_l2": l0 * t, "final_l2": best * t,
        "iters": args.iters, "offset_hop": args.offset_hop,
        "model": args.model, "ckpt": args.ckpt,
    }
    print(json.dumps(report))
    if args.out:
        from golf_tpu_torch.utils.wav import write_wav
        write_wav(args.out, y[:t], sr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
