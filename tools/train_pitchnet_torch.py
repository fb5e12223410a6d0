#!/usr/bin/env python
"""Train the neural pitch estimator (PitchNet) on synthetic data with the
port (counterpart of ``tools/train_pitchnet.py``).

Random harmonic sources (glottal-ish rolloff, random amplitudes and
phases, vibrato) mixed with noise at a random SNR, and pure-noise unvoiced
frames (``make_batch``, the same host numpy as ``tools/train_pitchnet.py``,
bit for bit). Voiced frames take Gaussian-blurred one-hot targets over the
cents bins, unvoiced frames the uniform distribution; the loss is the
soft-target cross-entropy. The optimizer is optax's ``adamw`` (weight decay
1e-4) under ``cosine_decay_schedule(lr, steps)``, as ``ClippedOptimizer``
with ``cosine_steps`` and no clip. After training it prints a held-out eval
line (cents MAE on voiced frames, voiced detection, unvoiced gate rate)
and writes the weights as a bf16 flax msgpack state file in
``golf_tpu``'s layout (``utils/flax_msgpack.py``), which
``utils/pitchnet.load_model`` and ``golf_tpu``'s PitchNet both read.

Runs on the card unless ``--device cpu``::

    python tools/train_pitchnet_torch.py --steps 3000
    python tools/train_pitchnet_torch.py --device cpu --steps 50 \\
        --out /tmp/pitchnet.msgpack
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from golf_tpu_torch.models.pitchnet import (  # noqa: E402
    ANALYSIS_SR, FMAX, FMIN, FRAME, N_BINS, PitchNet, decode, f0_to_bin)

DEFAULT_OUT = os.path.join(ROOT, "golf_tpu_torch", "assets",
                           "pitchnet.msgpack")


def make_batch(rng: np.random.Generator, b: int, voiced_frac: float = 0.8):
    """Synthetic frames and target distributions: (x (B, FRAME) float32,
    targets (B, N_BINS) float32, f0 (B,), voiced (B,))."""
    t = (np.arange(FRAME) - FRAME / 2) / ANALYSIS_SR
    f0 = np.exp(rng.uniform(np.log(FMIN * 1.02), np.log(FMAX * 0.98), b))
    voiced = rng.uniform(0, 1, b) < voiced_frac
    # vibrato and a slow drift, so frames are not perfectly stationary
    vib = (1.0 + rng.uniform(0, 0.01, (b, 1)) *
           np.sin(2 * np.pi * rng.uniform(3, 7, (b, 1)) * t[None, :] +
                  rng.uniform(0, 2 * np.pi, (b, 1))))
    inst_f0 = f0[:, None] * vib
    phase = np.cumsum(inst_f0 / ANALYSIS_SR, -1)
    phase += rng.uniform(0, 1, (b, 1))
    n_harm = 24
    k = np.arange(1, n_harm + 1)
    # random spectral rolloff (glottal sources fall 6-18 dB/oct)
    rolloff = rng.uniform(0.5, 2.0, (b, 1))
    amps = k[None, :] ** (-rolloff) * rng.uniform(0.3, 1.0, (b, n_harm))
    amps = np.where(k[None, :] * f0[:, None] < ANALYSIS_SR / 2 * 0.95,
                    amps, 0.0)
    ph = rng.uniform(0, 2 * np.pi, (b, n_harm))
    x = np.einsum("bk,bkt->bt", amps,
                  np.sin(2 * np.pi * k[None, :, None] * phase[:, None, :]
                         + ph[..., None])).astype(np.float32)
    x /= np.abs(x).max(-1, keepdims=True) + 1e-6
    snr_db = rng.uniform(3, 40, (b, 1))
    noise = rng.standard_normal((b, FRAME)).astype(np.float32)
    noise *= (x.std(-1, keepdims=True) / (noise.std(-1, keepdims=True)
              + 1e-9)) * 10 ** (-snr_db / 20)
    x = np.where(voiced[:, None], x + noise,
                 rng.standard_normal((b, FRAME)).astype(np.float32))
    # targets: blurred one-hot for voiced, uniform for unvoiced
    centers = f0_to_bin(f0)
    bins = np.arange(N_BINS)
    sigma = 2.5  # bins (25 cents)
    tgt = np.exp(-0.5 * ((bins[None, :] - centers[:, None]) / sigma) ** 2)
    tgt /= tgt.sum(-1, keepdims=True)
    tgt = np.where(voiced[:, None], tgt, np.full_like(tgt, 1.0 / N_BINS))
    return x, tgt.astype(np.float32), f0, voiced


def soft_cross_entropy(logits, targets):
    import torch
    return -(targets * torch.log_softmax(logits, -1)).sum(-1).mean()


def make_optimizer(model, lr: float, steps: int):
    """optax's ``adamw(cosine_decay_schedule(lr, steps))``: no clip."""
    from golf_tpu_torch.train.loop import ClippedOptimizer
    return ClippedOptimizer(model.parameters(), lr=lr, grad_clip=0.0,
                            optimizer="adamw", cosine_steps=steps)


def train_step(model, opt, x, tgt) -> float:
    opt.zero_grad()
    loss = soft_cross_entropy(model(x), tgt)
    loss.backward()
    opt.step()
    return loss.detach()


def evaluate(model, seed: int, device) -> dict:
    """The held-out eval of ``tools/train_pitchnet.py``: 256 frames from
    ``seed + 12345``."""
    import torch
    erng = np.random.default_rng(seed + 12345)
    x, _, f0, voiced = make_batch(erng, 256)
    with torch.no_grad():
        f0_hat, _ = decode(model(torch.from_numpy(x).to(device)))
    f0_hat = f0_hat.cpu().numpy()
    v = voiced & (f0_hat > 0)
    cents = 1200 * np.abs(np.log2(np.maximum(f0_hat[v], 1e-6) / f0[v]))
    return {"cents_mae": float(cents.mean()) if v.any() else float("nan"),
            "cents_median": float(np.median(cents)) if v.any()
            else float("nan"),
            "voiced_detect": float((f0_hat[voiced] > 0).mean()),
            "unvoiced_gated": float((f0_hat[~voiced] == 0).mean())
            if (~voiced).any() else 1.0}


def write_weights(model, path: str) -> None:
    """The weights as a bf16 flax msgpack in ``golf_tpu``'s layout."""
    from golf_tpu_torch.bridge import pitchnet_variables
    from golf_tpu_torch.utils import flax_msgpack
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flax_msgpack.dump(path, pitchnet_variables(model.state_dict()),
                      bfloat16=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch
    from golf_tpu_torch.core.device import resolve_device
    device = resolve_device(args.device)
    torch.manual_seed(args.seed)
    model = PitchNet().to(device)
    opt = make_optimizer(model, args.lr, args.steps)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.steps):
        x, tgt, _, _ = make_batch(rng, args.batch)
        loss = train_step(model, opt, torch.from_numpy(x).to(device),
                          torch.from_numpy(tgt).to(device))
        if i % 200 == 0 or i == args.steps - 1:
            print(f"step {i} loss {float(loss):.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) / max(args.steps, 1) * 1e3
    model.eval()
    ev = evaluate(model, args.seed, device)
    print(f"eval: cents MAE {ev['cents_mae']:.1f} (median "
          f"{ev['cents_median']:.1f}) voiced-detect {ev['voiced_detect']:.3f}"
          f" unvoiced-gated {ev['unvoiced_gated']:.3f}")
    write_weights(model, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) // 1024} KiB); "
          f"{ms_per_step:.2f} ms a step (host data included) on {device}")
    return {**ev, "ms_per_step": ms_per_step, "out": args.out}


if __name__ == "__main__":
    main()
