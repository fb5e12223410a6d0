"""Training loop (counterpart of ``golf_tpu.train.loop``).

``ClippedOptimizer`` is ``golf_tpu``'s ``make_optimizer``: adam, adamw, sgd
or amsgrad, with an optional learning-rate decay or a cosine schedule,
under ``apply_if_finite(chain(clip_by_global_norm(0.5), ...), 100)``.
``Trainer`` runs ``VoiceAutoEncoder.training_step`` for ``max_steps``,
validates every ``val_every_steps`` and at the end, keeps the top-k
checkpoints by val_loss and ``last``, logs JSONL metrics, aborts on a
non-finite loss and stops early when the logged train loss plateaus.

Data parallelism: with a process group of several ranks (``torchrun``,
``parallel.multihost.initialize``) the trainer lays out a data mesh of the
largest rank count that divides the batch, as ``golf_tpu`` resolves its
mesh. Every rank loads the global batch and keeps its rows; the step runs
under ``parallel.mesh.data_parallel`` (batch norms, the running min/max and
the masked f0 loss over the global batch, the noise and the unvoiced
frames' f0 drawn over the global batch), the gradients are averaged over
the data group before the clip, and the step equals the single-device step
on the global batch. Only rank 0 writes ``metrics.jsonl`` and checkpoints.
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
from ..parallel import collectives
from ..parallel.mesh import (data_parallel, data_shard, make_mesh, rows_of,
                             shard_batch)
from ..utils import profiling
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
      ``lr / (1 + lr_decay * count)``, or with ``cosine_steps`` optax's
      ``cosine_decay_schedule(lr, cosine_steps)``, ``lr (0.5 (1 +
      cos(pi min(count, steps) / steps)))``; ``count`` the updates applied
      before this one (0 at the first).
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
                 lr_decay: Optional[float] = None,
                 cosine_steps: Optional[int] = None):
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer {optimizer!r} is not one of "
                             f"{OPTIMIZERS}")
        self.params = list(params)
        self.lr = lr
        self.grad_clip = grad_clip
        self.optimizer = optimizer
        self.lr_decay = lr_decay
        self.cosine_steps = cosine_steps
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
        if self.cosine_steps:
            done = min(self.count, self.cosine_steps) / self.cosine_steps
            return self.lr * 0.5 * (1.0 + math.cos(math.pi * done))
        return self.lr

    def _direction(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The update before the learning rate scales it, in optax's order
        of float32 operations: each moment ``(1 - b) g^k + b m``, divided
        by its bias correction ``1 - b^n`` rounded in float32 (at n = 1,
        1 - 0.999 is 1.3e-5 off in float32, which optax keeps)."""
        if self.optimizer == "sgd":
            return grads
        mu, nu = self.moments["mu"], self.moments["nu"]
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_add_(nu, sq)
        n = np.float32(self.count + 1)
        mu_hat = torch._foreach_div(mu, float(1 - np.float32(b1) ** n))
        nu_hat = torch._foreach_div(nu, float(1 - np.float32(b2) ** n))
        if self.optimizer == "amsgrad":
            torch._foreach_maximum_(self.moments["nu_max"], nu_hat)
            nu_hat = self.moments["nu_max"]
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.EPS)
        direction = torch._foreach_div(mu_hat, denom)
        if self.optimizer == "adamw":
            torch._foreach_add_(direction, torch._foreach_mul(
                [p.detach() for p in self.params], self.WEIGHT_DECAY))
        return direction

    @torch.no_grad()
    def apply_update(self, grads: List[torch.Tensor]) -> None:
        """The optimizer's update of ``grads`` at the learning rate, with
        no clip and no finite guard (the bare optax optimizer, as
        ``optax.adam(lr)``); counts the update."""
        updates = torch._foreach_mul(self._direction(grads),
                                     -self.learning_rate())
        torch._foreach_add_([p.detach() for p in self.params], updates)
        self.count += 1

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """Clip and apply the gradients in ``.grad``; returns the raw
        gradients' global norm and whether the step was applied. Recorded
        as the span ``trainer.optimizer``; its finite check, a host sync, as
        ``optimizer.finite_check``."""
        with profiling.span("trainer.optimizer"):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in self.params]
            g_norm = global_norm(grads)
            with profiling.span("optimizer.finite_check"):
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
                self.apply_update(grads)
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
    """JSONL metrics log, ``<run_dir>/metrics.jsonl``; writes nothing where
    ``enabled`` is false (a rank other than 0)."""

    def __init__(self, run_dir: str, enabled: bool = True):
        self.enabled = enabled
        if enabled:
            os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        if not self.enabled:
            return
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
                 optimizer: str = "adam", lr_decay: Optional[float] = None,
                 mesh=None):
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
        # resolved from the first batch's size unless given
        self.mesh = mesh
        self.main = not torch.distributed.is_initialized() or \
            torch.distributed.get_rank() == 0
        self.logger = MetricsLogger(run_dir, enabled=self.main)
        self.ckpt = ckpt_lib.CheckpointManager(
            os.path.join(run_dir, "ckpt"), top_k=save_top_k)

    def _resolve_mesh(self, batch_size: int):
        """The data mesh of the largest rank count that divides the batch
        (one rank without a process group)."""
        if self.mesh is None:
            n = collectives.group_size()
            data = next(d for d in range(min(n, batch_size), 0, -1)
                        if batch_size % d == 0)
            self.mesh = make_mesh(data, 1)
        return self.mesh

    def _shard(self):
        return None if self.mesh is None else data_shard(self.mesh)

    def _save(self, metric: Optional[float] = None, last: bool = False):
        """Checkpoints are rank 0's."""
        if not self.main:
            return
        if last:
            self.ckpt.save_last(self.state_dict())
        else:
            self.ckpt.save(self.state_dict(), metric)

    # -- state ------------------------------------------------------------
    def state_dict(self) -> Dict:
        return {"model": self.task.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def init_state(self, sample_batch) -> None:
        """What ``golf_tpu``'s ``init_state`` leaves behind: the encoder's
        running min/max from the first (global) batch; resolves the mesh."""
        self._resolve_mesh(sample_batch[0].shape[0])
        self.task.init_running_stats(*_to_sigs(sample_batch, self.device))

    def restore(self, path: str, params_only: bool = False) -> None:
        if params_only:
            ckpt_lib.restore_params_into(path, self.task)
        else:
            self.step = ckpt_lib.restore_into(path, self.task,
                                              self.optimizer)

    # -- steps ------------------------------------------------------------
    def train_step(self, x: Sig, f0: Sig) -> Dict[str, torch.Tensor]:
        """One optimizer step on a (global) batch; returns the step's
        metrics (device tensors)."""
        metrics = self.loss_and_grads(x, f0)
        metrics.update(self.optimizer.step())
        return metrics

    def loss_and_grads(self, x: Sig, f0: Sig,
                       noise: Optional[torch.Tensor] = None,
                       random_f0: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
        """The gradients of a (global) batch's loss in ``.grad``; returns
        the metrics. Data-parallel, each rank takes its rows (and those of
        ``noise`` and ``random_f0``, global fields that replace the
        generator's draws) and the gradients are averaged over the data
        group. Recorded as a step: spans ``trainer.forward`` and
        ``trainer.backward`` (the all-reduce included)."""
        profiling.begin_step()
        self.task.train()
        self.optimizer.zero_grad()
        shard = self._shard()
        if shard is not None:
            x, f0 = (Sig(t, 1) for t in shard_batch(self.mesh, x.data,
                                                     f0.data))
            noise, random_f0 = (None if t is None else
                                rows_of(t, shard.index, shard.size)
                                for t in (noise, random_f0))
        fields = {"noise": noise} if random_f0 is None else \
            {"noise": noise, "random_f0": random_f0}
        with data_parallel(shard), profiling.span("trainer.forward"):
            loss, metrics = self.task.training_step(
                x, f0, train=True, generator=self.generator, **fields)
        with profiling.span("trainer.backward"):
            loss.backward()
            profiling.backward_done()
            metrics = {k: v.detach() for k, v in metrics.items()}
            if shard is not None:
                with_grad = [p for p in self.optimizer.params
                             if p.grad is not None]
                for p, g in zip(with_grad, collectives.psum_all(
                        (p.grad for p in with_grad), shard.group)):
                    p.grad = g / shard.size
                metrics = {k: collectives.pmean(torch.as_tensor(v),
                                                shard.group)
                           for k, v in metrics.items()}
        return metrics

    def _split_for_mesh(self, x: Sig, f0: Sig):
        """``golf_tpu``'s split of an evaluation batch: a chunk of a
        multiple of the data ranks, this rank's rows of it evaluated
        data-parallel, and the remainder evaluated whole on every rank;
        each chunk is weighted by its size. Yields (x, f0, shard,
        weight)."""
        shard = self._shard()
        if shard is None:
            yield x, f0, None, x.shape[0]
            return
        keep = (x.shape[0] // shard.size) * shard.size
        if keep:
            yield (Sig(rows_of(x.data[:keep], shard.index, shard.size), 1),
                   Sig(rows_of(f0.data[:keep], shard.index, shard.size), 1),
                   shard, keep)
        if keep < x.shape[0]:
            yield (Sig(x.data[keep:], 1), Sig(f0.data[keep:], 1), None,
                   x.shape[0] - keep)

    def _gathered(self, out: Dict, shard) -> Dict[str, float]:
        """Each metric of an evaluation chunk, averaged over the data group
        when it ran data-parallel."""
        if shard is None:
            return {k: float(v) for k, v in out.items()}
        return {k: float(collectives.pmean(torch.as_tensor(
            v, dtype=torch.float32, device=self.device), shard.group))
            for k, v in out.items()}

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
            for x, f0, shard, w in self._split_for_mesh(
                    *_to_sigs(batch, self.device)):
                with data_parallel(shard):
                    out = self.task.validation_step(x, f0, generator=gen)
                for k, v in self._gathered(out, shard).items():
                    totals[k] = totals.get(k, 0.0) + v * w
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
            for x, f0, shard, n in self._split_for_mesh(
                    *_to_sigs(batch, self.device)):
                with data_parallel(shard):
                    out = self.task.test_step(x, f0, generator=gen)
                count = out.pop("N", n)
                if shard is None:
                    n = float(count)
                for k, v in self._gathered(out, shard).items():
                    totals[k] = totals.get(k, 0.0) + v * n
                weight += n
        result = {("avg_" + k): v / max(weight, 1)
                  for k, v in totals.items()}
        result["avg_mss_loss"] = result.pop("avg_loss", float("nan"))
        self.task.train()
        if self.main:
            print(json.dumps(result))
        self.logger.log(-1, result)
        return result

    def fit(self, datamodule, ckpt_path: Optional[str] = None) -> int:
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()
        self.init_state(next(iter(train_loader)))
        if not self.mesh.member:
            print(f"rank {self.mesh.rank}: outside the data mesh of "
                  f"{self.mesh.size} ranks (the batch's largest divisor); "
                  f"idle", flush=True)
            return self.step
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
                if self.main:
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
                            if self.main:
                                print(f"early stop: train_loss plateaued "
                                      f"for {self.early_stop_patience} "
                                      f"logged steps", flush=True)
                            break

            if self.step % self.val_every_steps == 0 or \
                    self.step >= self.max_steps:
                val_metrics = self.validate(val_loader)
                self.logger.log(self.step, val_metrics)
                if self.main:
                    print(f"[val @ {self.step}] " + ", ".join(
                        f"{k}={v:.4g}" for k, v in val_metrics.items()),
                        flush=True)
                self._save(val_metrics.get("val_loss"))

        self._save(last=True)
        return self.step
