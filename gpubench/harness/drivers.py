"""The two kinds of traffic a mix can name (its ``kind``), each a closed
loop over the pool of seeded batches:

* ``train``: one optimizer step a batch. Set-up drives the trainer through
  its ``first`` steps (each after ``torch.manual_seed`` of the run's
  dropout stream, which fixes cuDNN's dropout masks), records what the
  reference will check, then ``warmup`` more steps; the window then steps
  back to back for ``--seconds``.
* ``resynth``: one batched ``predict_step`` a batch, timed from the call to
  ``synchronize``; ``warmup`` calls in set-up. The audio and what the
  reference checks beside it (GOLF: the encoder's output) of the ``check``
  batches drawn from the seed, and of the window's last, are kept for the
  reference.

A traced run (``--trace 1``) runs ``trace`` more steps under the profiler
with the kernel ranges after the window. Its layer spans come from where
the configuration says (``spec.Parts.spans``): the benchmark's hooks on
``trace`` steps before the window, or the program's own recorder on
``trace`` steps after the window and before the profiled ones. So neither
the hooks nor the recorder touch the window, and the profiler, whose cost
outlasts it on the host, runs last. Each driver returns the run's record:
what the metric readers read, the program's readings for the check, and
the inputs the reference needs.
``least`` (the tests') holds the window open for that many steps at
least.
"""

from __future__ import annotations

import math
import random
import time
from typing import Dict, List

import torch

from golf_tpu_torch.utils import profiling

from . import inputs, spec, trace
from .program import Resynthesis, Training


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def first_steps(prog: Training, batches: List[Dict], seed: int, n: int,
                weights: Dict[str, torch.Tensor]) -> Dict:
    """The program's first ``n`` steps from the seeded weights, each after
    ``torch.manual_seed`` of the dropout stream: every step's loss, the
    per-leaf norm of the first gradient as the optimizer took it, and of
    each leaf's change over the ``n`` steps."""
    losses, grad = [], None
    for k in range(n):
        torch.manual_seed(inputs.stream_seed(seed, "dropout", k))
        losses.append(prog.step(batches[k % len(batches)]).detach())
        if k == 0:
            grad = {name: torch.linalg.vector_norm(g.double())
                    for name, g in prog.first_gradient().items()}
    change = {name: torch.linalg.vector_norm((p - weights[name]).double())
              for name, p in prog.params().items()}
    return {"loss": [float(v) for v in losses],
            "grad": {k: float(v) for k, v in grad.items()},
            "change": {k: float(v) for k, v in change.items()}}


def span_part(task, step, n: int, backward: bool) -> Dict:
    """``n`` steps with the layer spans (CUDA events, no profiler);
    ``step(spans)`` runs one."""
    spans = trace.Spans(task, backward)
    try:
        for _ in range(n):
            step(spans)
    finally:
        spans.remove()
    return {"spans": spans.totals(), "trace_steps": n}


def profile_part(step, n: int, device) -> Dict:
    """``n`` steps under the profiler with the kernel ranges, after the
    window (the profiler leaves the host slower behind it)."""
    ranges = trace.KernelRanges()
    try:
        with trace.profiler() as prof:
            t1 = time.perf_counter()
            for _ in range(n):
                step(None)
            _sync(device)
            window = time.perf_counter() - t1
    finally:
        ranges.remove()
    return dict(trace.read_profile(prof, window), launches=ranges.shapes)


def program_part(step, n: int, device) -> Dict:
    """``n`` steps inside the program's recorder: the program's spans
    (``trace.program_spans``). Run before the profiler, whose cost on the
    host outlasts it."""
    with profiling.recording() as rec:
        for _ in range(n):
            step(None)
        _sync(device)
    return {"spans": trace.program_spans(rec), "trace_steps": n}


def train(cell, seed: int, seconds: float, traced: bool, device,
          t_start: float, weights, batches, least: int = 0) -> Dict:
    tr = cell.traffic
    hooks = spec.parts(cell.config).spans == "hooks"
    prog = Training(cell.config, weights, batches[0], device)
    readings = first_steps(prog, batches, seed, tr["first"], weights)
    i = tr["first"]
    for _ in range(tr["warmup"]):
        prog.step(batches[i % len(batches)])
        i += 1
    _sync(device)
    setup_s = time.perf_counter() - t_start

    def step(spans):
        nonlocal i
        prog.step(batches[i % len(batches)], spans)
        i += 1

    traced_rec = span_part(prog.task, step, tr["trace"], True) \
        if traced and hooks else {}
    losses = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or len(losses) < least:
        losses.append(prog.step(batches[i % len(batches)]))
        i += 1
    _sync(device)
    window = time.perf_counter() - t0
    if traced:
        if not hooks:
            traced_rec.update(program_part(step, tr["trace"], device))
        traced_rec.update(profile_part(step, tr["trace"], device))
    steps = len(losses)
    failed = sum(1 for v in torch.stack(losses).tolist()
                 if not math.isfinite(v))
    peak = _peak(device)
    prog.close()
    audio = tr["batch"] * tr["seconds"]
    return dict(traced_rec, setup_s=setup_s, window_s=window,
                attempted=steps, failed=failed, audio_s=steps * audio,
                memory_peak_bytes=peak, readings=readings)


def resynth(cell, seed: int, seconds: float, traced: bool, device,
            t_start: float, weights, batches, least: int = 0) -> Dict:
    tr = cell.traffic
    hooks = spec.parts(cell.config).spans == "hooks"
    prog = Resynthesis(cell.config, weights, batches[0], device)
    warm = []
    i = 0
    for _ in range(tr["warmup"]):
        t = time.perf_counter()
        prog.predict(batches[i % len(batches)])
        _sync(device)
        warm.append(time.perf_counter() - t)
        i += 1
    setup_s = time.perf_counter() - t_start
    # the window's batches to check: drawn from the seed over the count
    # the warm-up's pace gives, and the last one
    expect = max(1, int(seconds / max(min(warm), 1e-3)))
    rng = random.Random(seed)
    picks = sorted({rng.randrange(expect) for _ in range(tr["check"])})

    kept: Dict = {}
    lat, flags, shapes = [], [], []
    traced_rec = {}

    def one(n: int):
        nonlocal i
        batch_i = i % len(batches)
        t = time.perf_counter()
        y = prog.predict(batches[batch_i])
        flags.append(torch.isfinite(y).all())
        _sync(device)
        lat.append((time.perf_counter() - t) * 1e3)
        shapes.append(tuple(y.shape))
        if n in picks:
            kept[n] = (batch_i, y, *prog.kept)
        kept["last"] = (batch_i, y, *prog.kept)
        i += 1

    def step(spans):
        nonlocal i
        prog.predict(batches[i % len(batches)])
        _sync(device)
        i += 1

    if traced and hooks:
        traced_rec = span_part(prog.task, step, tr["trace"], False)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds or n < least:
        one(n)
        n += 1
    window = time.perf_counter() - t0
    if traced:
        if not hooks:
            traced_rec.update(program_part(step, tr["trace"], device))
        traced_rec.update(profile_part(step, tr["trace"], device))
    peak = _peak(device)
    finite = torch.stack(flags).tolist()
    prog.close()
    audio = tr["batch"] * tr["seconds"]
    return dict(traced_rec, setup_s=setup_s, window_s=window, attempted=n,
                audio_s=n * audio, latencies_ms=lat,
                memory_peak_bytes=peak, finite=finite, shapes=shapes,
                outputs=kept)


DRIVERS = {"train": train, "resynth": resynth}
