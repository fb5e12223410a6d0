"""CLI runner for the port: the ``predict`` subcommand (counterpart of
``golf_tpu.tasks.cli``)::

    python autoencode_torch.py predict --config cfg/ae/vctk.yaml \\
        --model cfg/ae/decoder/golf.yaml data.class_path=ltng.data.Synthetic

``--model FILE`` merges the decoder subtree into ``model.init_args``;
dotted overrides apply last; the resolved config is written to the run
directory and one wav per item to ``<run_dir>/predictions``. Weights are
the seeded initialisation (checkpoints come with the training slice), with
the encoder's running min/max set from the first training batch as
``golf_tpu``'s trainer init does. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List

import numpy as np
import torch

from ..config.registry import instantiate, load_config
from ..core.device import resolve_device
from ..core.sig import Sig
from ..utils.wav import write_wav
from .ae import build_voice_autoencoder


def _parse_args(argv: List[str]):
    p = argparse.ArgumentParser(description="golf_tpu_torch CLI")
    p.add_argument("subcommand", choices=["predict"])
    p.add_argument("--config", action="append", default=[],
                   help="YAML config file(s), merged in order")
    p.add_argument("--model", default=None,
                   help="YAML file merged into model.init_args")
    p.add_argument("--run_dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    # overrides may stand between options: older 3.12 argparse refuses that
    # in parse_args
    return p.parse_intermixed_args(argv)


def run(argv: List[str]) -> int:
    import yaml

    args = _parse_args(argv)
    cfg = load_config(args.config, args.model, args.overrides)
    device = resolve_device(args.device)
    run_dir = args.run_dir or cfg.get("run_dir") or os.path.join(
        "runs", time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)

    model_node = cfg["model"]
    if not model_node.get("class_path", "").endswith("VoiceAutoEncoder"):
        raise ValueError(f"task {model_node.get('class_path')!r} is not "
                         f"ported")
    init_args = model_node.get("init_args", model_node)
    torch.manual_seed(cfg.get("seed_everything") or 2434)
    task = build_voice_autoencoder(init_args, device=device)
    datamodule = instantiate(cfg["data"])

    datamodule.setup("fit")
    x0, f00 = next(iter(datamodule.train_dataloader()))[:2]
    task.init_running_stats(Sig(torch.from_numpy(x0).to(device), 1),
                            Sig(torch.from_numpy(f00).to(device), 1))
    task.eval()

    sr = init_args.get("sample_rate", 24000)
    out_dir = os.path.join(run_dir, "predictions")
    generator = torch.Generator(device=device).manual_seed(0)
    datamodule.setup("predict")
    with torch.inference_mode():
        for x, f0, rel in datamodule.predict_dataloader():
            y, _ = task.predict_step(Sig(torch.from_numpy(x).to(device), 1),
                                     Sig(torch.from_numpy(f0).to(device), 1),
                                     generator=generator)
            write_wav(os.path.join(out_dir, rel[0]),
                      np.asarray(y.data[0].cpu()), sr)
    print(f"predictions written to {out_dir}")
    return 0
