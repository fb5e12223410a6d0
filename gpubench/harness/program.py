"""The system under test, ``golf_tpu_torch``, driven through its normal
entries: ``tasks.ae.build_voice_autoencoder`` builds the configuration's
model, ``train.loop.Trainer`` trains it and ``VoiceAutoEncoder.predict_step``
resynthesises with it.

The training step is the body of ``Trainer.train_step``, its two calls
``loss_and_grads`` and ``optimizer.step``, with the benchmark's noise field
and unvoiced f0 passed to ``loss_and_grads`` (``train_step`` would draw
them from the trainer's generator), so that the reference can be handed the
same.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Dict, List

import torch

from golf_tpu_torch import kernels
from golf_tpu_torch.core.sig import Sig
from golf_tpu_torch.tasks.ae import build_voice_autoencoder
from golf_tpu_torch.train.loop import Trainer


def build_kernels(device) -> None:
    """Build (first run in a checkout) or bind the CUDA kernels: set-up."""
    if torch.device(device).type == "cuda":
        kernels.build(kernels.ALL)


def build_task(config: Dict, weights: Dict[str, torch.Tensor], device):
    """The configuration's model with the benchmark's weights; raises if a
    trained parameter of the program is not among them or differs in
    shape."""
    task = build_voice_autoencoder(config["model"], device=device)
    own = {n: p for n, p in task.named_parameters() if p.requires_grad}
    missing = sorted(set(own) - set(weights))
    extra = sorted(set(weights) - set(own))
    if missing or extra:
        raise RuntimeError(f"weights do not match the program's parameters: "
                           f"missing {missing}, not in the program {extra}")
    with torch.no_grad():
        for n, p in own.items():
            if tuple(p.shape) != tuple(weights[n].shape):
                raise RuntimeError(f"{n}: program {tuple(p.shape)}, weights "
                                   f"{tuple(weights[n].shape)}")
            p.copy_(weights[n])
    return task


def trained_names(task) -> List[str]:
    """The trained parameters' names, in the optimizer's order."""
    return [n for n, p in task.named_parameters() if p.requires_grad]


def sigs(batch: Dict[str, torch.Tensor]):
    return Sig(batch["x"], 1), Sig(batch["f0"], 1)


class Training:
    """The trainer of the configuration's model and its step."""

    def __init__(self, config: Dict, weights, first: Dict, device):
        self.task = build_task(config, weights, device)
        opt = config["optimizer"]
        self.run_dir = tempfile.mkdtemp(prefix="gpubench-trainer-")
        self.trainer = Trainer(self.task, run_dir=self.run_dir,
                               lr=opt["lr"], grad_clip=opt["grad_clip"],
                               optimizer=opt["optimizer"])
        # init_state: the encoder's running min/max from the first batch
        # (a loader's host batch, as ``fit`` gives it)
        self.trainer.init_state((first["x"].cpu().numpy(),
                                 first["f0"].cpu().numpy()))

    def step(self, batch: Dict[str, torch.Tensor], spans=None
             ) -> torch.Tensor:
        """One optimizer step; returns the loss (a device scalar).
        ``spans`` (a traced run's) marks the backward's end and times the
        optimizer."""
        x, f0 = sigs(batch)
        metrics = self.trainer.loss_and_grads(
            x, f0, noise=batch["noise"], random_f0=batch["random_f0"])
        if spans is None:
            self.trainer.optimizer.step()
        else:
            spans.step_end()
            with spans.optimizer():
                self.trainer.optimizer.step()
        return metrics["loss"]

    def first_gradient(self) -> Dict[str, torch.Tensor]:
        """After one step: the gradient as the optimizer took it, from its
        first moment (``mu = (1 - b1) g`` after one update)."""
        opt = self.trainer.optimizer
        return {n: mu / (1 - opt.B1) for n, mu in
                zip(trained_names(self.task), opt.moments["mu"])}

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.task.named_parameters()
                if p.requires_grad}

    def close(self) -> None:
        shutil.rmtree(self.run_dir, ignore_errors=True)


class Resynthesis:
    """The configuration's model in eval mode after the trainer's
    ``init_state`` on the first batch (the running min/max). ``head`` is
    the encoder's output (its head's rows) of the last call, which a
    forward hook keeps (a reference, no copy)."""

    def __init__(self, config: Dict, weights, first: Dict, device):
        self.task = build_task(config, weights, device)
        self.task.init_running_stats(*sigs(first))
        self.task.eval()
        self.head = None
        self._hook = self.task.encoder.backbone.register_forward_hook(
            self._keep)

    def _keep(self, _module, _args, out) -> None:
        self.head = out.data

    def predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            y, _ = self.task.predict_step(*sigs(batch),
                                          noise=batch["noise"])
        return y.data

    def close(self) -> None:
        self._hook.remove()
