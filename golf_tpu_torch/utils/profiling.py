"""Profiling, tracing and debugging (counterpart of
``golf_tpu.utils.profiling``).

* ``trace(logdir)``: a ``torch.profiler`` trace of a block (CPU and, where
  there is one, CUDA activity), written to ``logdir`` as a Chrome/Perfetto
  trace, one file a call;
* ``enable_nan_debugging``: ``torch.autograd.set_detect_anomaly`` (the
  backward names the forward op whose gradient went non-finite), as
  ``jax_debug_nans`` is for ``golf_tpu``;
* ``cost_analysis(fn, *args)``: the FLOPs of one call by
  ``torch.utils.flop_counter.FlopCounterMode`` (the ops it knows: matmuls,
  convolutions, attention), total and by operator;
* ``timed(fn, *args)``: the trimmed mean of synchronized calls
  (``utils.timing.timed_sync``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch

from .timing import timed_sync


@contextlib.contextmanager
def trace(logdir: str = "runs/trace"):
    """Profile a block and write its trace under ``logdir``::

        with profiling.trace("runs/trace"):
            step(...)
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def enable_nan_debugging(enable: bool = True) -> None:
    """Trap non-finite gradients at the op that produced them."""
    torch.autograd.set_detect_anomaly(enable)


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """``{"flops": total, "by_op": {op: flops}}`` of one call of
    ``fn(*args, **kwargs)``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    by_op = {str(op): n for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": counter.get_total_flops(), "by_op": by_op}


def timed(fn: Callable, *args, n: int = 10, device="cuda") -> float:
    """Trimmed-mean seconds of ``fn(*args)``: one warm-up call, n timed
    calls each ended by a sync, the fastest and slowest dropped."""
    return timed_sync(fn, *args, n=n, device=device)
