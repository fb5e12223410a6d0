"""CLI runner for the port: the ``fit``, ``validate``, ``test`` and
``predict`` subcommands of the voice autoencoder, the mel vocoder, LPCNet
and the WORLD baseline (counterpart of ``golf_tpu.tasks.cli``)::

    python autoencode_torch.py fit --config cfg/ae/vctk.yaml \\
        --model cfg/ae/decoder/golf.yaml data.class_path=ltng.data.Synthetic
    python main_torch.py fit --model cfg/ae/decoder/golf-v1.yaml \\
        data.init_args.wav_dir=<MPop600 tree>
    python main_torch.py fit --config cfg/lpcnet.yaml \\
        data.init_args.wav_dir=<LJSpeech tree>
    python autoencode_torch.py test --config cfg/ae/pyworld.yaml \\
        data.init_args.wav_dir=<VCTK tree>
    python autoencode_torch.py validate ... --ckpt_path <run>/ckpt/last
    python autoencode_torch.py test ... [--ckpt_path <run>/ckpt/last]
    python autoencode_torch.py predict ... [--ckpt_path <run>/ckpt/last]

``--model FILE`` merges the decoder subtree into ``model.init_args``;
dotted overrides apply last; the resolved config is written to the run
directory. ``fit`` writes ``metrics.jsonl`` and ``ckpt/{last,step=...}``
there, ``validate`` prints the validation metrics as JSON, ``test`` the
test split's ``avg_mss_loss`` and ``avg_mcd`` (MCD; the vocoder's
``avg_mss_loss`` and ``avg_f0_loss``, the f0 error in cents; LPCNet's
teacher-forced metrics and ``avg_ar_mss`` and ``avg_ar_f0_cents`` of its
autoregressive output), ``predict`` writes one wav per item to
``<run_dir>/predictions`` (the vocoder's in 6 s chunks crossfaded over
0.3 s). Without a checkpoint the weights are the seeded initialisation,
with the running min/max set from the first training batch as
``golf_tpu``'s trainer init does. The WORLD baseline has no weights: it
runs ``test`` and ``predict`` only. LPCNet has no ``predict``, as in
``golf_tpu``. Runs on CUDA unless ``--device cpu``.

Under ``torchrun --nproc_per_node=N`` the ranks train data-parallel (NCCL,
one card a rank; gloo with ``--device cpu``); rank 0 alone writes the
config snapshot, the metrics, the checkpoints and the predictions.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.registry import instantiate, load_config
from ..core.device import resolve_device
from ..core.sig import Sig
from ..parallel import multihost
from ..train.loop import Trainer
from ..utils.wav import write_wav
from .ae import build_voice_autoencoder
from .lpcnet import LPCNetVocoder, build_lpcnet_vocoder, run_lpcnet_test
from .vocoder import (DDSPVocoder, build_ddsp_vocoder, chunked_ola_predict,
                      run_vocoder_test)
from .world_ae import WORLDAutoEncoder, build_world_autoencoder


def _parse_args(argv: List[str]):
    p = argparse.ArgumentParser(description="golf_tpu_torch CLI")
    p.add_argument("subcommand",
                   choices=["fit", "validate", "test", "predict"])
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
    ``build_from_config``): the optimizer's class name, lowercased, picks
    adam, adamw or sgd (any other name adam), ``amsgrad: true`` among its
    init_args amsgrad; ``lr_scheduler.decay`` is the learning-rate
    decay."""
    trainer_cfg = cfg.get("trainer", {}) or {}
    opt_cfg = cfg.get("optimizer", {}) or {}
    opt_init = opt_cfg.get("init_args", {}) or {}
    opt_name = opt_cfg.get("class_path", "torch.optim.Adam")
    opt_name = opt_name.rsplit(".", 1)[-1].lower()
    if opt_name not in ("adam", "adamw", "sgd"):
        opt_name = "adam"
    if opt_init.get("amsgrad"):
        opt_name = "amsgrad"
    scheduler = cfg.get("lr_scheduler")
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
        optimizer=opt_name,
        lr_decay=scheduler.get("decay") if isinstance(scheduler, dict)
        else None,
        seed=cfg.get("seed_everything", 2434) or 2434,
        early_stop_patience=patience, check_finite=check_finite)


BUILD_FNS = {"VoiceAutoEncoder": build_voice_autoencoder,
             "DDSPVocoder": build_ddsp_vocoder,
             "LPCNetVocoder": build_lpcnet_vocoder,
             "WORLDAutoEncoder": build_world_autoencoder}


def build_from_config(cfg: Dict, device=None):
    """(task, datamodule, Trainer arguments) from a resolved config tree
    (``golf_tpu``'s ``build_from_config``): the task named by
    ``model.class_path`` on ``device`` (CUDA unless given), its weights
    seeded by ``seed_everything``, and the data module of ``data``."""
    model_node = cfg["model"]
    class_path = model_node.get("class_path", "")
    build = BUILD_FNS.get(class_path.rpartition(".")[2])
    if build is None:
        raise ValueError(f"task {class_path!r} is not ported")
    torch.manual_seed(cfg.get("seed_everything") or 2434)
    task = build(model_node.get("init_args", model_node),
                 device=resolve_device(device))
    return task, instantiate(cfg["data"]), trainer_kwargs(cfg)


def run(argv: List[str], default_config: Optional[str] = None) -> int:
    """Run one subcommand; ``default_config`` is read when no ``--config``
    is given."""
    import yaml

    args = _parse_args(argv)
    configs = args.config or ([default_config] if default_config else [])
    cfg = load_config(configs, args.model, args.overrides)
    device = resolve_device(args.device)
    # under torchrun: one process a card (NCCL), or gloo on the CPU
    multihost.initialize(backend="gloo" if device.type == "cpu" else None)
    main = multihost.is_main_process()
    run_dir = args.run_dir or cfg.get("run_dir") or os.path.join(
        "runs", time.strftime("%Y%m%d-%H%M%S"))
    run_dir = multihost.broadcast_one_to_all(run_dir)
    if main:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)

    task, datamodule, kwargs = build_from_config(cfg, device)
    if isinstance(task, WORLDAutoEncoder):
        return _run_world(args.subcommand, task, datamodule, run_dir)
    if isinstance(task, LPCNetVocoder) and args.subcommand == "predict":
        raise NotImplementedError(
            "LPCNetVocoder has no predict: golf_tpu's has no predict_step "
            "either (main.py predict fails there); test writes the "
            "autoregressive resynthesis of its first batch with "
            "ar_dump_dir=<dir>")
    ckpt_path = args.ckpt_path or cfg.get("ckpt_path")

    trainer = Trainer(task, run_dir=run_dir, **kwargs)
    if args.subcommand == "fit":
        trainer.fit(datamodule, ckpt_path=ckpt_path)
        return 0

    datamodule.setup("fit")
    trainer.init_state(next(iter(datamodule.train_dataloader())))
    if ckpt_path:
        # evaluation never uses the optimizer's state
        trainer.restore(ckpt_path, params_only=True)
    if args.subcommand == "validate":
        val = trainer.validate(datamodule.val_dataloader())
        if main:
            print(json.dumps(val))
        return 0
    vocoder = isinstance(task, DDSPVocoder)
    if args.subcommand == "test":
        if vocoder:
            print(json.dumps(run_vocoder_test(task, datamodule)))
        elif isinstance(task, LPCNetVocoder):
            print(json.dumps(run_lpcnet_test(
                task, datamodule, ar_dump_dir=cfg.get("ar_dump_dir"))))
        else:
            trainer.test(datamodule)
        return 0

    if not main:
        return 0        # rank 0 writes the predictions
    task.eval()
    init_args = cfg["model"].get("init_args", cfg["model"])
    sr = init_args.get("sample_rate", 24000)
    out_dir = os.path.join(run_dir, "predictions")
    generator = torch.Generator(device=device).manual_seed(0)

    def resynth(frames: np.ndarray) -> np.ndarray:
        y, _ = task.predict_step(Sig(torch.from_numpy(frames).to(device), 1),
                                 generator=generator)
        return y.data.cpu().numpy()

    datamodule.setup("predict")
    with torch.inference_mode():
        for x, f0, rel in datamodule.predict_dataloader():
            if vocoder:
                audio = chunked_ola_predict(resynth, x, sr)
            else:
                y, _ = task.predict_step(
                    Sig(torch.from_numpy(x).to(device), 1),
                    Sig(torch.from_numpy(f0).to(device), 1),
                    generator=generator)
                audio = np.asarray(y.data[0].cpu())
            write_wav(os.path.join(out_dir, rel[0]), audio, sr)
    print(f"predictions written to {out_dir}")
    return 0


def _run_world(subcommand: str, task: WORLDAutoEncoder, datamodule,
               run_dir: str) -> int:
    """The WORLD baseline's ``test`` (the metrics as JSON) and ``predict``
    (one wav per utterance of the predict split); it has no parameters, so
    ``fit`` and ``validate`` raise."""
    if subcommand in ("fit", "validate"):
        raise ValueError(
            f"WORLDAutoEncoder is not trainable: {subcommand} has nothing to "
            f"do; run test or predict")
    if subcommand == "test":
        print(json.dumps(task.run_test(datamodule)))
        return 0
    out_dir = os.path.join(run_dir, "predictions")
    datamodule.setup("predict")
    for x, f0, rel in datamodule.predict_dataloader():
        y, _ = task.predict_step(np.asarray(x), np.asarray(f0))
        write_wav(os.path.join(out_dir, rel[0]), y[0], task.sample_rate)
    print(f"predictions written to {out_dir}")
    return 0
