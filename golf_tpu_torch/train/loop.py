"""Training loop on one device (counterpart of ``golf_tpu.train.loop``).

``ClippedOptimizer`` is ``golf_tpu``'s ``make_optimizer``: adam, adamw, sgd
or amsgrad, with an optional learning-rate decay, under
``apply_if_finite(chain(clip_by_global_norm(0.5), ...), 100)``.
``Trainer`` runs ``VoiceAutoEncoder.training_step`` for ``max_steps``,
validates every ``val_every_steps`` and at the end, keeps the top-k
checkpoints by val_loss and ``last``, logs JSONL metrics, aborts on a
non-finite loss and stops early when the logged train loss plateaus. There
is no mesh: the port trains on one card (or the CPU when asked).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from ..core.sig import Sig
from . import checkpoint as ckpt_lib


def trainable_parameters(module: nn.Module) -> List[nn.Parameter]:
    """The parameters that train: ``requires_grad`` is off for those that
    ``golf_tpu`` does not have (the LSTM's ``bias_ih``)."""
    return [p for p in module.parameters() if p.requires_grad]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


OPTIMIZERS = ("adam", "adamw", "sgd", "amsgrad")


class ClippedOptimizer:
    """``golf_tpu``'s ``make_optimizer``: ``apply_if_finite(chain(
    clip_by_global_norm(grad_clip), <optax optimizer>(schedule)), 100)``,
    written out so that the update is optax's, not ``torch.optim``'s.

    * ``adam``: moments with b1 0.9 and b2 0.999, the direction
      ``mu_hat / (sqrt(nu_hat) + 1e-8)``, bias-corrected at the count of
      updates applied.
    * ``adamw``: adam's direction plus 1e-4 times the parameter (optax's
      default decay, which ``golf_tpu`` keeps; ``torch.optim.AdamW``'s is
      1e-2), scaled by the learning rate with it.
    * ``amsgrad``: divides by the running max of the bias-corrected second
      moment (``torch.optim.Adam(amsgrad=True)`` keeps the max of the raw
      moment and corrects that).
    * ``sgd``: the gradient itself; optax's sgd has no momentum.
    * The learning rate is ``lr``, or with ``lr_decay`` the schedule
      ``lr / (1 + lr_decay * count)``, ``count`` the updates applied before
      this one (0 at the first).
    * Clip: when the global norm g of the gradients is at least
      ``grad_clip``, each gradient becomes ``t / g * grad_clip``
      (``optax.clip_by_global_norm``; ``clip_grad_norm_`` would add 1e-6).
    * Non-finite gradients: the step is skipped and the state kept, the
      schedule's count included, as ``optax.apply_if_finite`` does; after
      more than ``MAX_CONSECUTIVE_ERRORS`` (100) skips in a row the step is
      applied.

    A parameter without a gradient takes a zero one, as in optax.
    """

    MAX_CONSECUTIVE_ERRORS = 100
    B1, B2, EPS = 0.9, 0.999, 1e-8
    WEIGHT_DECAY = 1e-4
    _MOMENTS = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"),
                "amsgrad": ("mu", "nu", "nu_max"), "sgd": ()}

    def __init__(self, params: Iterable[nn.Parameter], lr: float = 1e-4,
                 grad_clip: float = 0.5, optimizer: str = "adam",
                 lr_decay: Optional[float] = None):
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer {optimizer!r} is not one of "
                             f"{OPTIMIZERS}")
        self.params = list(params)
        self.lr = lr
        self.grad_clip = grad_clip
        self.optimizer = optimizer
        self.lr_decay = lr_decay
        self.count = 0
        self.notfinite_count = 0
        self.moments = {name: [torch.zeros_like(p) for p in self.params]
                        for name in self._MOMENTS[optimizer]}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def learning_rate(self) -> float:
        if self.lr_decay:
            return self.lr / (1.0 + self.lr_decay * self.count)
        return self.lr

    def _direction(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The update before the learning rate scales it."""
        if self.optimizer == "sgd":
            return grads
        mu, nu = self.moments["mu"], self.moments["nu"]
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        n = self.count + 1
        mu_hat = torch._foreach_div(mu, 1 - b1 ** n)
        nu_hat = torch._foreach_div(nu, 1 - b2 ** n)
        if self.optimizer == "amsgrad":
            torch._foreach_maximum_(self.moments["nu_max"], nu_hat)
            nu_hat = self.moments["nu_max"]
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.EPS)
        direction = torch._foreach_div(mu_hat, denom)
        if self.optimizer == "adamw":
            torch._foreach_add_(direction, [p.detach() for p in self.params],
                                alpha=self.WEIGHT_DECAY)
        return direction

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """Clip and apply the gradients in ``.grad``; returns the raw
        gradients' global norm and whether the step was applied."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        g_norm = global_norm(grads)
        finite = bool(torch.stack([torch.isfinite(g).all()
                                   for g in grads]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        applied = finite or \
            self.notfinite_count > self.MAX_CONSECUTIVE_ERRORS
        if applied:
            if self.grad_clip and self.grad_clip > 0:
                keep = g_norm < self.grad_clip
                grads = [torch.where(keep, g, g / g_norm * self.grad_clip)
                         for g in grads]
            torch._foreach_add_([p.detach() for p in self.params],
                                self._direction(grads),
                                alpha=-self.learning_rate())
            self.count += 1
        return {"grad_norm": g_norm,
                "update_applied": torch.tensor(float(applied))}

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer, "count": self.count,
                "notfinite_count": self.notfinite_count,
                "moments": self.moments}

    def load_state_dict(self, state: Dict) -> None:
        if state["optimizer"] != self.optimizer:
            raise ValueError(
                f"the checkpoint's optimizer state is {state['optimizer']}'s,"
                f" not {self.optimizer}'s: restore it params-only")
        for name, tensors in state["moments"].items():
            for own, saved in zip(self.moments[name], tensors):
                own.copy_(saved)
        self.count = int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])


class MetricsLogger:
    """JSONL metrics log, ``<run_dir>/metrics.jsonl``."""

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        rec = {"step": step, "time": time.time()}
        rec.update({(prefix + k): float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _to_sigs(batch, device):
    x, f0 = batch[:2]
    return (Sig(torch.from_numpy(np.ascontiguousarray(x)).to(device), 1),
            Sig(torch.from_numpy(np.ascontiguousarray(f0)).to(device), 1))


class Trainer:
    def __init__(self, task, run_dir: str = "runs/default",
                 max_steps: int = 1_000_000, lr: float = 1e-4,
                 grad_clip: float = 0.5, val_every_steps: int = 5000,
                 log_every_steps: int = 50, seed: int = 2434,
                 save_top_k: int = 3, check_finite: bool = True,
                 early_stop_patience: Optional[int] = None,
                 restore_params_only: bool = False,
                 optimizer: str = "adam", lr_decay: Optional[float] = None):
        self.task = task
        self.device = next(task.parameters()).device
        self.run_dir = run_dir
        self.max_steps = max_steps
        self.val_every_steps = val_every_steps
        self.log_every_steps = log_every_steps
        self.seed = seed
        self.check_finite = check_finite
        self.restore_params_only = restore_params_only
        # EarlyStopping(monitor=train_loss, patience, check_finite);
        # patience counts logged steps, as in golf_tpu
        self.early_stop_patience = early_stop_patience
        self._best_train_loss = float("inf")
        self._steps_since_best = 0
        self.optimizer = ClippedOptimizer(trainable_parameters(task), lr,
                                          grad_clip, optimizer, lr_decay)
        self.step = 0
        # the random f0 of unvoiced frames and the noise of training steps
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.logger = MetricsLogger(run_dir)
        self.ckpt = ckpt_lib.CheckpointManager(
            os.path.join(run_dir, "ckpt"), top_k=save_top_k)

    # -- state ------------------------------------------------------------
    def state_dict(self) -> Dict:
        return {"model": self.task.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def init_state(self, sample_batch) -> None:
        """What ``golf_tpu``'s ``init_state`` leaves behind: the encoder's
        running min/max from the first batch."""
        self.task.init_running_stats(*_to_sigs(sample_batch, self.device))

    def restore(self, path: str, params_only: bool = False) -> None:
        if params_only:
            ckpt_lib.restore_params_into(path, self.task)
        else:
            self.step = ckpt_lib.restore_into(path, self.task,
                                              self.optimizer)

    # -- steps ------------------------------------------------------------
    def train_step(self, x: Sig, f0: Sig) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the step's metrics (device
        tensors)."""
        self.task.train()
        self.optimizer.zero_grad()
        loss, metrics = self.task.training_step(x, f0, train=True,
                                                generator=self.generator)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(self.optimizer.step())
        return metrics

    @torch.no_grad()
    def validate(self, loader) -> Dict[str, float]:
        """Mean of each validation metric over the loader, weighted by batch
        size; the noise is drawn afresh from ``seed + 999`` on every call,
        so a checkpoint validates to the same numbers."""
        self.task.eval()
        gen = torch.Generator(self.device).manual_seed(self.seed + 999)
        totals: Dict[str, float] = {}
        weight = 0
        for batch in loader:
            x, f0 = _to_sigs(batch, self.device)
            out = self.task.validation_step(x, f0, generator=gen)
            w = x.shape[0]
            for k, v in out.items():
                totals[k] = totals.get(k, 0.0) + float(v) * w
            weight += w
        self.task.train()
        return {("val_" + k): v / max(weight, 1) for k, v in totals.items()}

    @torch.no_grad()
    def test(self, datamodule) -> Dict[str, float]:
        """``test_step`` over the test split: the N-weighted mean of each
        metric as ``avg_<name>``, the MSS loss as ``avg_mss_loss``; printed
        as JSON and logged at step -1."""
        datamodule.setup("test")
        self.task.eval()
        gen = torch.Generator(self.device).manual_seed(self.seed + 12345)
        totals: Dict[str, float] = {}
        weight = 0.0
        for batch in datamodule.test_dataloader():
            x, f0 = _to_sigs(batch, self.device)
            out = self.task.test_step(x, f0, generator=gen)
            n = float(out.pop("N", x.shape[0]))
            for k, v in out.items():
                totals[k] = totals.get(k, 0.0) + float(v) * n
            weight += n
        result = {("avg_" + k): v / max(weight, 1)
                  for k, v in totals.items()}
        result["avg_mss_loss"] = result.pop("avg_loss", float("nan"))
        self.task.train()
        print(json.dumps(result))
        self.logger.log(-1, result)
        return result

    def fit(self, datamodule, ckpt_path: Optional[str] = None) -> int:
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()
        self.init_state(next(iter(train_loader)))
        if ckpt_path:
            self.restore(ckpt_path, params_only=self.restore_params_only)

        def batches():
            while True:
                for b in train_loader:
                    yield b

        staged = batches()
        t0 = time.time()
        samples = 0
        while self.step < self.max_steps:
            x, f0 = _to_sigs(next(staged), self.device)
            metrics = self.train_step(x, f0)
            self.step += 1
            samples += x.shape[0] * x.shape[1]

            if self.step % self.log_every_steps == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                m["samples_per_sec"] = samples / dt
                t0, samples = time.time(), 0
                self.logger.log(self.step, m, "train_")
                print(f"step {self.step}: " + ", ".join(
                    f"{k}={v:.4g}" for k, v in m.items()), flush=True)
                if self.check_finite and not math.isfinite(m["loss"]):
                    raise FloatingPointError(
                        f"non-finite loss at step {self.step}")
                if self.early_stop_patience:
                    if m["loss"] < self._best_train_loss:
                        self._best_train_loss = m["loss"]
                        self._steps_since_best = 0
                    else:
                        self._steps_since_best += 1
                        if self._steps_since_best >= \
                                self.early_stop_patience:
                            print(f"early stop: train_loss plateaued for "
                                  f"{self.early_stop_patience} logged "
                                  f"steps", flush=True)
                            break

            if self.step % self.val_every_steps == 0 or \
                    self.step >= self.max_steps:
                val_metrics = self.validate(val_loader)
                self.logger.log(self.step, val_metrics)
                print(f"[val @ {self.step}] " + ", ".join(
                    f"{k}={v:.4g}" for k, v in val_metrics.items()),
                    flush=True)
                self.ckpt.save(self.state_dict(),
                               val_metrics.get("val_loss"))

        self.ckpt.save_last(self.state_dict())
        return self.step
