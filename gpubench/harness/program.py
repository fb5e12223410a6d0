"""The system under test, ``golf_tpu_torch``, driven through its normal
entries: the port's task table (``tasks.cli.BUILD_FNS``) builds the
configuration's task, ``train.loop.Trainer`` trains it and its
``predict_step`` resynthesises with it.

The training step is the body of ``Trainer.train_step``, its two calls
``loss_and_grads`` and ``optimizer.step``, with the benchmark's fields
(the noise field, the unvoiced f0) passed to ``loss_and_grads``
(``train_step`` would draw them from the trainer's generator), so that the
reference can be handed the same.
"""

from __future__ import annotations

import functools
import shutil
import tempfile
from typing import Dict, List

import torch

from golf_tpu_torch import kernels
from golf_tpu_torch.core.sig import Sig
from golf_tpu_torch.train.loop import Trainer

from . import spec


def build_kernels(device) -> None:
    """Build (first run in a checkout) or bind the CUDA kernels: set-up."""
    if torch.device(device).type == "cuda":
        kernels.build(kernels.ALL)


def build_task(config: Dict, weights: Dict[str, torch.Tensor], device):
    """The configuration's task with the benchmark's weights; raises if a
    trained parameter of the program is not among them or differs in
    shape."""
    # the task table is imported here, in set-up, and not with the
    # harness: imported before the card was set up, its modules took 8-10 s
    # of set-up on an H100 host against 4 s here (PERF.md, section 6)
    from golf_tpu_torch.tasks.cli import BUILD_FNS

    parts = spec.parts(config)
    task = BUILD_FNS[parts.task](parts.model, device=device)
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


def fields(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch's inputs beyond x and f0, by the entries' keywords."""
    return {k: v for k, v in batch.items() if k not in ("x", "f0")}


def _data(out) -> torch.Tensor:
    return out.data if isinstance(out, Sig) else out


class Training:
    """The trainer of the configuration's task and its step."""

    def __init__(self, config: Dict, weights, first: Dict, device):
        self.task = build_task(config, weights, device)
        self.run_dir = tempfile.mkdtemp(prefix="gpubench-trainer-")
        self.trainer = Trainer(self.task, run_dir=self.run_dir,
                               **config["optimizer"])
        # init_state: the task's running statistics (the encoder's min/max)
        # from the first batch (a loader's host batch, as ``fit`` gives it)
        self.trainer.init_state((first["x"].cpu().numpy(),
                                 first["f0"].cpu().numpy()))

    def step(self, batch: Dict[str, torch.Tensor], spans=None
             ) -> torch.Tensor:
        """One optimizer step; returns the loss (a device scalar).
        ``spans`` (a traced run's) marks the backward's end and times the
        optimizer."""
        metrics = self.trainer.loss_and_grads(*sigs(batch), **fields(batch))
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
    """The configuration's task in eval mode after the trainer's
    ``init_state`` on the first batch (the running min/max). ``kept`` is
    what the reference checks beside the audio of the last call: the
    forward output of each submodule its ``KEEP`` names (GOLF: the
    encoder's, its head's rows), kept by forward hooks (references, no
    copies)."""

    def __init__(self, config: Dict, weights, first: Dict, device):
        self.task = build_task(config, weights, device)
        self.task.init_running_stats(*sigs(first))
        self.task.eval()
        keep = spec.reference(config).KEEP
        self.kept: List = [None] * len(keep)
        self._hooks = [self.task.get_submodule(name).register_forward_hook(
            functools.partial(self._keep, k)) for k, name in enumerate(keep)]

    def _keep(self, k: int, _module, _args, out) -> None:
        self.kept[k] = _data(out)

    def predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            out = self.task.predict_step(*sigs(batch), **fields(batch))
        return _data(out[0] if isinstance(out, tuple) else out)

    def close(self) -> None:
        for h in self._hooks:
            h.remove()
