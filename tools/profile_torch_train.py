#!/usr/bin/env python3
"""Where the training time of the PyTorch/CUDA port goes, on one GPU.

    python tools/profile_torch_train.py [--config vctk|vocoder|baselines]
        [--out chiprun_out/profile_train]

``--config vctk`` (the default): the GOLF-ff (``golf.yaml``) and GOLF-ss
(``golf-precise.yaml``) decoders on the full-width vctk encoder;
``--config vocoder``: the ISMIR23 vocoder of ``cfg/vocoder.yaml`` with
``golf-v1.yaml`` and ``ddsp.yaml``; ``--config baselines``: the
Interspeech24 baselines (``nhv``, ``mlsa``, ``mlsa-taylor``, ``world``) on
the vctk encoder (a stage the decoder lacks is skipped). With the seeded
weights of
``chip_smoke.py``, one Adam step of the port's ``Trainer`` on B = 64
synthetic items of 2 s:

* forward stage times: CUDA events recorded by forward hooks around the
  encoder (and the vocoder's log-mel features), the harmonic source, the
  noise generator and filter, the harmonic filter (vocoder), the end
  filter, the room filter (vctk), and around the loss (median of 5 steps;
  idle gaps inside a stage count);
* backward stage times: CUDA events recorded when the gradient reaches each
  stage's output (tensor hooks), so a stage's backward is the interval
  from its output's gradient to the next stage's; the loss's backward runs
  from the start of ``backward()`` to the decoder output's gradient, the
  encoder's to the end of ``backward()``;
* the optimizer step (clip + Adam), by events around it;
* a ``torch.profiler`` window over 3 steps: the device's busy time (the
  union of its kernel intervals) over the window's wall time, and the
  kernels that take the most device time (written in full to ``--out``);
* the step's time with ``wrapped_cumsum``'s cotangent accumulated in
  float32 (the port's form before) and in float64 (as shipped), in turns
  float32, float64, float64, float32 (median of ``--steps`` each).

TF32 is off, as in ``chip_smoke.py``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from golf_tpu_torch import kernels  # noqa: E402
from golf_tpu_torch.core.sig import Sig  # noqa: E402
from golf_tpu_torch.ops import dsp  # noqa: E402
from golf_tpu_torch.train.loop import Trainer  # noqa: E402
from profile_torch_serve import busy_share  # noqa: E402

# per config: the decoders, the seeded model, the forward stages, and the
# stage outputs in the order the backward reaches them
CONFIGS = {
    "vctk": (("golf", "golf-precise"), chip_smoke.seeded_model,
             ("encoder", "decoder.harm_oscillator", "decoder.noise_generator",
              "decoder.noise_filter", "decoder.end_filter",
              "decoder.room_filter"),
             ("decoder.room_filter", "decoder.end_filter",
              "decoder.harm_oscillator", "encoder")),
    "vocoder": (("golf-v1", "ddsp"), chip_smoke.vocoder_model,
                ("feature_trsfm", "encoder", "decoder.harm_oscillator",
                 "decoder.noise_generator", "decoder.harm_filter",
                 "decoder.noise_filter", "decoder.end_filter"),
                ("decoder.end_filter", "decoder.harm_filter",
                 "decoder.harm_oscillator", "encoder")),
    "baselines": (chip_smoke.BASELINES, chip_smoke.seeded_model,
                  ("encoder", "decoder.harm_oscillator",
                   "decoder.noise_generator", "decoder.harm_filter",
                   "decoder.noise_filter", "decoder.end_filter",
                   "decoder.room_filter"),
                  ("decoder.room_filter", "decoder.end_filter",
                   "decoder.harm_filter", "decoder.harm_oscillator",
                   "encoder")),
}


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _first_tensor(out):
    if isinstance(out, Sig):
        return out.data
    if isinstance(out, dict):
        for v in out.values():
            for s in (v if isinstance(v, tuple) else (v,)):
                if isinstance(s, Sig) and s.data.requires_grad:
                    return s.data
    return None


class StepTimer:
    """Hooks that record CUDA events around the stages of one step."""

    def __init__(self, task, fwd_stages, bwd_marks):
        self.marks = {}
        self.bwd = []
        self.marked = []
        self.handles = []
        self.bwd_marks = bwd_marks
        for name in fwd_stages:
            try:
                mod = task.get_submodule(name)
            except AttributeError:      # a stage this decoder lacks
                continue
            self.handles += [
                mod.register_forward_pre_hook(
                    lambda _m, _a, name=name: self._start(name)),
                mod.register_forward_hook(
                    lambda _m, _a, out, name=name: self._stop(name, out))]
        criterion = task.criterion

        def timed_loss(pred, target):
            self._start("loss")
            loss = criterion(pred, target)
            self._stop("loss", None)
            return loss

        task.criterion = timed_loss
        self._task, self._criterion = task, criterion

    def _start(self, name):
        self.marks.setdefault(name, []).append([_event(), None])

    def _stop(self, name, out):
        self.marks[name][-1][1] = _event()
        t = _first_tensor(out) if name in self.bwd_marks else None
        # a pass-through stage returns its input: the mark stays with the
        # stage that made the tensor
        if t is not None and t.requires_grad and id(t) not in self.marked:
            self.marked.append(id(t))
            t.register_hook(lambda g, name=name: self.bwd.append(
                (name, _event())))

    def remove(self):
        for h in self.handles:
            h.remove()
        self._task.criterion = self._criterion

    def step(self, trainer, xs, f0s) -> dict:
        self.marks.clear()
        self.bwd.clear()
        self.marked = []
        task, opt = trainer.task, trainer.optimizer
        task.train()
        opt.zero_grad()
        start = _event()
        loss, _ = task.training_step(xs, f0s, generator=trainer.generator)
        bwd_start = _event()
        loss.backward()
        bwd_end = _event()
        opt.step()
        stop = _event()
        torch.cuda.synchronize()
        out = {f"fwd {n}": sum(a.elapsed_time(b) for a, b in v)
               for n, v in self.marks.items()}
        out["forward"] = start.elapsed_time(bwd_start)
        seq = [("loss", bwd_start)] + self.bwd + [("end", bwd_end)]
        for (name, a), (_, b) in zip(seq[:-1], seq[1:]):
            out[f"bwd {name}"] = out.get(f"bwd {name}", 0.0) + \
                a.elapsed_time(b)
        out["backward"] = bwd_start.elapsed_time(bwd_end)
        out["optimizer"] = bwd_end.elapsed_time(stop)
        out["step"] = start.elapsed_time(stop)
        return out


def cotangent_forms(timer: "StepTimer", trainer, xs, f0s, steps: int,
                    decoder: str) -> None:
    """The step's median time under each form of ``wrapped_cumsum``'s
    cotangent, in turns."""
    shipped = dsp.reversed_cumsum
    forms = {"float32": lambda g: torch.flip(torch.cumsum(
        torch.flip(g, (1,)), dim=1), (1,)), "float64": shipped}
    out = []
    try:
        for label in ("float32", "float64", "float64", "float32"):
            dsp.reversed_cumsum = forms[label]
            reps = [timer.step(trainer, xs, f0s)["step"]
                    for _ in range(steps)]
            out.append(f"{label} {statistics.median(reps):.2f}")
    finally:
        dsp.reversed_cumsum = shipped
    print(f"profile_train {decoder}: step ms (median of {steps}) with the "
          f"cotangent of "
          f"wrapped_cumsum accumulated in " + ", ".join(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="vctk")
    ap.add_argument("--out", default="chiprun_out/profile_train")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    card = chip_smoke.phase_environment()
    kernels.build(kernels.ALL)
    dev = torch.device("cuda")
    x, f0 = chip_smoke.requests(chip_smoke.TRAIN_BATCH,
                                chip_smoke.TRAIN_SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    decoders, build, fwd_stages, bwd_marks = CONFIGS[args.config]
    for decoder in decoders:
        torch.manual_seed(chip_smoke.SEED)
        task = build(decoder, dev)
        task.init_running_stats(xs, f0s)
        trainer = Trainer(task, run_dir=os.path.join(args.out, decoder),
                          seed=chip_smoke.SEED)
        for _ in range(2):
            trainer.train_step(xs, f0s)
        torch.cuda.synchronize()
        timer = StepTimer(task, fwd_stages, bwd_marks)
        reps = [timer.step(trainer, xs, f0s) for _ in range(args.steps)]
        cotangent_forms(timer, trainer, xs, f0s, args.steps, decoder)
        timer.remove()
        stages = {k: statistics.median(r.get(k, 0.0) for r in reps)
                  for k in reps[0]}
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                trainer.train_step(xs, f0s)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, n_kernels = busy_share(prof)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"profile_train {decoder}: stage ms (median of {args.steps} "
              f"steps, B={chip_smoke.TRAIN_BATCH} x "
              f"{chip_smoke.TRAIN_SECONDS:.0f} s): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in stages.items()))
        if n_kernels:
            print(f"profile_train {decoder}: 3 steps, wall {wall_ms:.2f} ms, "
                  f"device busy {busy_ms:.2f} ms, idle share "
                  f"{1 - busy_ms / wall_ms:.3f}, {n_kernels} kernels, peak "
                  f"memory {peak:.2f} GiB")
        else:
            print(f"profile_train {decoder}: the profiler saw no device "
                  f"kernels")
        table = prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40,
                                          max_name_column_width=60)
        path = os.path.join(args.out, f"profile_train_{decoder}.txt")
        with open(path, "w") as f:
            f.write(f"card: {card}\n{table}\n")
        print(f"profile_train {decoder}: top kernels by device time "
              f"({path}):")
        print("\n".join(table.splitlines()[:22]))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
