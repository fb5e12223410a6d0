#!/usr/bin/env python
"""Rd statistics of a trained GOLF model over a corpus, on the port
(counterpart of ``tools/rd_stats.py``; the TISMIR ablation notebook's
``calculate_Rd_stats`` + transformed-LF flow cells, reference
``notebooks/tismir/ablation.ipynb``).

Runs the encoder (eval mode, no gradient) over the run's validation split,
maps the wavetable select weight w in [0, 1] from ``decoder.apply_ctrl``
onto the log-spaced Rd grid (``ops/lf.py::build_glottal_table``: Rd =
exp(lerp(log min, log max, w))), masks by voicing (f0 > 50 Hz), and
reports voiced-frame Rd mean/std/min/max plus a decile histogram. With
--flows-out, also dumps the mean and +/-1 std transformed-LF derivative
waveforms for plotting. No kernel runs on this path.

The task and data module come from ``tasks.cli.build_from_config``;
``--ckpt`` is a checkpoint of the port (a ``golf_tpu`` orbax checkpoint
goes through ``tools/orbax_to_torch.py`` first). Without it the weights
are the seeded initialisation and the encoder's running min/max come from
the first batch. Runs on CUDA unless ``--device cpu``::

    python tools/rd_stats_torch.py --config runs/<run>/config.yaml \\
        --ckpt runs/<run>/ckpt/last [--items 16] [--flows-out rd_flows.npz]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from golf_tpu_torch.config.registry import load_config  # noqa: E402
from golf_tpu_torch.core.sig import Sig  # noqa: E402
from golf_tpu_torch.ops.lf import transformed_lf_v2  # noqa: E402
from golf_tpu_torch.tasks.cli import build_from_config  # noqa: E402
from golf_tpu_torch.train.checkpoint import restore_params_into  # noqa: E402


@torch.no_grad()
def select_weights(task, x: Sig, f0: Sig):
    """The harmonic oscillator's select weight w (B, frames) and its hop."""
    raw = task.encoder(x, f0=f0, train=False)
    raw.pop("voicing_logits", None)
    raw.pop("f0", None)
    params = task.decoder.apply_ctrl(raw)
    (w,) = params["harm_oscillator_params"]
    return w.data, w.hop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--items", type=int, default=16)
    ap.add_argument("--flows-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = load_config([args.config])
    task, datamodule, _ = build_from_config(cfg, args.device)
    device = next(task.parameters()).device
    if args.ckpt:
        restore_params_into(args.ckpt, task)
    task.eval()

    osc_cfg = cfg["model"]["init_args"]["decoder"]["init_args"][
        "harm_oscillator"]["init_args"]
    min_rd = float(osc_cfg.get("min_R_d", 0.3))
    max_rd = float(osc_cfg.get("max_R_d", 2.7))

    datamodule.setup("validate")
    weights, masks = [], []
    seen = 0
    for batch in datamodule.val_dataloader():
        x, f0 = batch[0], batch[1]
        xs = Sig(torch.from_numpy(x).to(device), 1)
        fs = Sig(torch.from_numpy(f0).to(device), 1)
        if not args.ckpt and not seen:
            task.init_running_stats(xs, fs)
        w, hop = select_weights(task, xs, fs)
        w = w.cpu().numpy()                      # (B, frames)
        f0_np = np.asarray(f0)
        frames = w.shape[1]
        # frame-rate voicing mask from the conditioning f0
        idx = np.minimum(np.arange(frames) * hop, f0_np.shape[1] - 1)
        voiced = f0_np[:, idx] > 50.0
        weights.append(w)
        masks.append(voiced)
        seen += w.shape[0]
        if seen >= args.items:
            break

    w = np.concatenate([a.reshape(-1) for a in weights])
    m = np.concatenate([a.reshape(-1) for a in masks])
    wv = w[m]
    log_rd = np.log(min_rd) + wv * (math.log(max_rd) - math.log(min_rd))
    rd = np.exp(log_rd)
    qs = np.quantile(rd, np.linspace(0, 1, 11)) if rd.size else []
    stats = {
        "n_voiced_frames": int(rd.size),
        "n_frames": int(w.size),
        "rd_mean": float(rd.mean()) if rd.size else None,
        "rd_std": float(rd.std()) if rd.size else None,
        "rd_min": float(rd.min()) if rd.size else None,
        "rd_max": float(rd.max()) if rd.size else None,
        "rd_deciles": [float(q) for q in qs],
        "min_R_d": min_rd, "max_R_d": max_rd,
    }
    if args.flows_out and rd.size:
        mean_rd = float(rd.mean())
        lo = max(min_rd, float(np.exp(log_rd.mean() - log_rd.std())))
        hi = min(max_rd, float(np.exp(log_rd.mean() + log_rd.std())))
        flows = transformed_lf_v2(np.array([lo, mean_rd, hi]), points=1024)
        np.savez(args.flows_out, rds=np.array([lo, mean_rd, hi]),
                 flows=flows)
        stats["flows_out"] = args.flows_out
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
