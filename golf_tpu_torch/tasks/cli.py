"""CLI runner for the port: the ``fit``, ``validate`` and ``predict``
subcommands of the voice autoencoder (counterpart of
``golf_tpu.tasks.cli``)::

    python autoencode_torch.py fit --config cfg/ae/vctk.yaml \\
        --model cfg/ae/decoder/golf.yaml data.class_path=ltng.data.Synthetic
    python autoencode_torch.py validate ... --ckpt_path <run>/ckpt/last
    python autoencode_torch.py predict ... [--ckpt_path <run>/ckpt/last]

``--model FILE`` merges the decoder subtree into ``model.init_args``;
dotted overrides apply last; the resolved config is written to the run
directory. ``fit`` writes ``metrics.jsonl`` and ``ckpt/{last,step=...}``
there, ``validate`` prints the validation metrics as JSON, ``predict``
writes one wav per item to ``<run_dir>/predictions``. Without a
checkpoint the weights are the seeded initialisation, with the encoder's
running min/max set from the first training batch as ``golf_tpu``'s
trainer init does. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..config.registry import instantiate, load_config
from ..core.device import resolve_device
from ..core.sig import Sig
from ..train.loop import Trainer
from ..utils.wav import write_wav
from .ae import build_voice_autoencoder


def _parse_args(argv: List[str]):
    p = argparse.ArgumentParser(description="golf_tpu_torch CLI")
    p.add_argument("subcommand", choices=["fit", "validate", "predict"])
    p.add_argument("--config", action="append", default=[],
                   help="YAML config file(s), merged in order")
    p.add_argument("--model", default=None,
                   help="YAML file merged into model.init_args")
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--run_dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    # overrides may stand between options: older 3.12 argparse refuses that
    # in parse_args
    return p.parse_intermixed_args(argv)


def trainer_kwargs(cfg: Dict) -> Dict:
    """The Trainer's arguments from a resolved config (``golf_tpu``'s
    ``build_from_config``): Adam only, no learning-rate decay."""
    trainer_cfg = cfg.get("trainer", {}) or {}
    opt_cfg = cfg.get("optimizer", {}) or {}
    opt_name = opt_cfg.get("class_path", "torch.optim.Adam")
    opt_init = opt_cfg.get("init_args", {}) or {}
    if opt_name.rsplit(".", 1)[-1].lower() != "adam" or \
            opt_init.get("amsgrad") or cfg.get("lr_scheduler"):
        raise NotImplementedError(
            f"optimizer {opt_name} {opt_init} with lr_scheduler "
            f"{cfg.get('lr_scheduler')} is not ported; Adam is")
    patience, check_finite = None, True
    for cb in trainer_cfg.get("callbacks", []) or []:
        if str(cb.get("class_path", "")).endswith("EarlyStopping"):
            ia = cb.get("init_args", {}) or {}
            patience = ia.get("patience")
            check_finite = ia.get("check_finite", True)
    return dict(
        max_steps=trainer_cfg.get("max_steps", 1_000_000),
        val_every_steps=trainer_cfg.get("check_val_every_n_steps", 5000),
        restore_params_only=bool(cfg.get("ckpt_params_only", False)),
        lr=opt_init.get("lr", 1e-4),
        grad_clip=trainer_cfg.get("gradient_clip_val", 0.5),
        seed=cfg.get("seed_everything", 2434) or 2434,
        early_stop_patience=patience, check_finite=check_finite)


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
    ckpt_path = args.ckpt_path or cfg.get("ckpt_path")

    trainer = Trainer(task, run_dir=run_dir, **trainer_kwargs(cfg))
    if args.subcommand == "fit":
        trainer.fit(datamodule, ckpt_path=ckpt_path)
        return 0

    datamodule.setup("fit")
    trainer.init_state(next(iter(datamodule.train_dataloader())))
    if ckpt_path:
        # evaluation never uses the optimizer's state
        trainer.restore(ckpt_path, params_only=True)
    if args.subcommand == "validate":
        print(json.dumps(trainer.validate(datamodule.val_dataloader())))
        return 0

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
