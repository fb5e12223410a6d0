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
* the recorder: spans and counters the program records at its layer
  boundaries while ``recording()`` is on.

The recorder
------------
``with recording() as rec:`` turns it on; it is off outside (nesting
raises). The program marks its layers with

* ``span(name)``: a forward or host-side region;
* ``x = enter(name, x)`` ... ``y = leave(name, y)``: a layer that runs
  forward and backward. ``enter`` opens ``<name>.fwd`` and ``leave`` closes
  it; the backward opens ``<name>.bwd`` where the gradient reaches ``y``
  (every tensor of it) and closes it where it reaches ``x``. Where ``x``
  needs no gradient, ``backward_done()``, called when the backward pass
  returns, closes it. Both take a tensor, a ``Sig`` or dicts, lists and
  tuples of them; identity autograd Functions carry the marks;
* ``count(name, n)``: a counter, kept by the innermost open span;
* ``begin_step()``: the step (or batch) the spans that follow belong to.
  A backward span carries its forward's step.

A span records its name, its parent (the innermost span open on its
thread, or on a thread with none open, such as the autograd engine's, on
the thread that turned the recorder on), its step, its host start and end
(``time.perf_counter_ns``) and, where CUDA is available, a pair of CUDA
events on the current stream, read as device ms when the recording ends.
While on, every span is also a ``torch.profiler.record_function`` range
named ``golf.<name>``, so that a profiler running at the same time puts
the spans on the clock of its device operations.

Where CUDA is available the recorder counts ``host_syncs``: every call
``torch.cuda.set_sync_debug_mode("warn")`` reports as synchronizing, by
the innermost span open on the thread that called; syncs in the
backward's worker threads reach the caller when the backward returns.
Syncs inside cuDNN or inside the C entries of ``kernels`` are not seen.

Off, the marks cost one module-level check: ``enter`` and ``leave``
return their argument itself, ``span`` a shared no-op context, and no
event, range or counter is made.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.sig import Sig


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


# -- the recorder ---------------------------------------------------------

RANGE = "golf."
SYNC_MESSAGE = "synchronizing CUDA operation"


@dataclasses.dataclass
class Span:
    """One span: ``parent`` indexes ``Recorder.spans``; the device times
    are ms from the recording's start (None without CUDA)."""

    name: str
    parent: Optional[int]
    step: Optional[int]
    host_start_ns: int
    host_end_ns: Optional[int] = None
    device_start_ms: Optional[float] = None
    device_end_ms: Optional[float] = None

    @property
    def host_s(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e9

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_start_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms


def _covered(start: float, end: float, parts: List[Tuple[float, float]]
             ) -> float:
    """The length of [start, end] that the union of ``parts`` covers."""
    total, reach = 0.0, start
    for s, e in sorted(parts):
        s, e = max(s, reach), min(e, end)
        if e > s:
            total += e - s
            reach = e
    return total


class Recorder:
    """The spans and counters of one ``recording()``."""

    def __init__(self, cuda: bool):
        self.spans: List[Span] = []
        # counter name -> innermost open span's name (None: none) -> count
        self.counts: Dict[str, Dict[Optional[str], int]] = {}
        self.step: Optional[int] = None
        self.steps = 0
        self._cuda = cuda
        self._owner = threading.get_ident()
        self._stacks: Dict[int, List[int]] = {}
        self._events: Dict[int, List[torch.cuda.Event]] = {}
        self._ranges: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._base = self._event() if cuda else None

    @staticmethod
    def _event() -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _innermost(self) -> Optional[int]:
        stack = self._stacks.get(threading.get_ident()) or \
            self._stacks.get(self._owner)
        return stack[-1] if stack else None

    def open(self, name: str, step: Optional[int]) -> int:
        rng = torch.autograd.profiler.record_function(RANGE + name)
        rng.__enter__()
        with self._lock:
            i = len(self.spans)
            self.spans.append(Span(name, self._innermost(), step,
                                   time.perf_counter_ns()))
            self._stacks.setdefault(threading.get_ident(), []).append(i)
            self._ranges[i] = rng
        if self._cuda:
            self._events[i] = [self._event()]
        return i

    def close(self, i: int) -> None:
        if self._cuda:
            self._events[i].append(self._event())
        with self._lock:
            self.spans[i].host_end_ns = time.perf_counter_ns()
            for stack in self._stacks.values():
                if i in stack:
                    stack.remove(i)
            rng = self._ranges.pop(i)
        rng.__exit__(None, None, None)

    def close_named(self, name: str) -> bool:
        """Close the innermost open span called ``name``, on this thread
        first; False if none is open."""
        own = self._stacks.get(threading.get_ident(), [])
        for stack in [own] + [s for s in self._stacks.values()
                              if s is not own]:
            for i in reversed(stack):
                if self.spans[i].name == name:
                    self.close(i)
                    return True
        return False

    def close_open(self, which: Callable[[str], bool] = lambda _: True
                   ) -> None:
        """Close every open span whose name ``which`` accepts, innermost
        first."""
        for i in sorted((i for s in self._stacks.values() for i in s),
                        reverse=True):
            if which(self.spans[i].name):
                self.close(i)

    def count(self, name: str, n: int) -> None:
        inner = self._innermost()
        where = None if inner is None else self.spans[inner].name
        with self._lock:
            by_span = self.counts.setdefault(name, {})
            by_span[where] = by_span.get(where, 0) + n

    def _resolve(self) -> None:
        """Device times of every span, once the device has run them."""
        if not self._cuda:
            return
        torch.cuda.synchronize()
        for i, (start, end) in self._events.items():
            span = self.spans[i]
            span.device_start_ms = self._base.elapsed_time(start)
            span.device_end_ms = self._base.elapsed_time(end)
        self._events.clear()

    def totals(self) -> Dict[str, Dict[str, Any]]:
        """By span name: ``n`` spans, their ``host_s`` and (None without
        CUDA) ``device_ms``, summed."""
        out: Dict[str, Dict[str, Any]] = {}
        for span in self.spans:
            t = out.setdefault(span.name, {"n": 0, "host_s": 0.0,
                                           "device_ms": None})
            t["n"] += 1
            t["host_s"] += span.host_s
            if span.device_ms is not None:
                t["device_ms"] = (t["device_ms"] or 0.0) + span.device_ms
        return out

    def self_times(self) -> Dict[str, Dict[str, Any]]:
        """By span name, summed: each span's duration less the part its
        child spans cover, on the host (``host_s``) and the device
        (``device_ms``, None without CUDA)."""
        children: Dict[int, List[Span]] = {}
        for span in self.spans:
            if span.parent is not None:
                children.setdefault(span.parent, []).append(span)
        out: Dict[str, Dict[str, Any]] = {}
        for i, span in enumerate(self.spans):
            kids = children.get(i, [])
            t = out.setdefault(span.name, {"host_s": 0.0, "device_ms": None})
            t["host_s"] += (span.host_end_ns - span.host_start_ns - _covered(
                span.host_start_ns, span.host_end_ns,
                [(k.host_start_ns, k.host_end_ns) for k in kids])) / 1e9
            if span.device_ms is not None:
                t["device_ms"] = (t["device_ms"] or 0.0) + \
                    span.device_ms - _covered(
                        span.device_start_ms, span.device_end_ms,
                        [(k.device_start_ms, k.device_end_ms)
                         for k in kids])
        return out

    @contextlib.contextmanager
    def _syncs_counted(self):
        """On CUDA: count the calls the sync debug mode reports."""
        if not self._cuda:
            yield
            return
        before = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.filterwarnings("always", message=f".*{SYNC_MESSAGE}")
            shown = warnings.showwarning

            def show(message, category, filename, lineno, file=None,
                     line=None):
                if SYNC_MESSAGE in str(message):
                    self.count("host_syncs", 1)
                else:
                    shown(message, category, filename, lineno, file, line)

            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(before)


_ON = False
_REC: Optional[Recorder] = None
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def recording():
    """Turn the recorder on for a block; yields the ``Recorder``, whose
    spans' device times are read when the block ends."""
    global _ON, _REC
    if _ON:
        raise RuntimeError("the recorder is already on")
    rec = Recorder(torch.cuda.is_available())
    _REC, _ON = rec, True
    try:
        with rec._syncs_counted():
            yield rec
    finally:
        _ON, _REC = False, None
        rec.close_open()
        rec._resolve()


class _Span:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.i = self.rec.open(self.name, self.rec.step)

    def __exit__(self, *exc):
        self.rec.close(self.i)


def span(name: str):
    """A context recording the span ``name`` while the recorder is on."""
    if not _ON:
        return _OFF
    return _Span(_REC, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if not _ON:
        return
    _REC.count(name, n)


def begin_step() -> None:
    """The spans that follow belong to the next step (0, 1, ...)."""
    if not _ON:
        return
    _REC.step = _REC.steps
    _REC.steps += 1


def backward_done() -> None:
    """Close the backward spans still open when the backward pass
    returns: those of layers whose input needs no gradient."""
    if not _ON:
        return
    _REC.close_open(lambda name: name.endswith(".bwd"))


def _tensors(tree, out: List[torch.Tensor]) -> None:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, Sig):
        out.append(tree.data)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, Sig):
        return Sig(next(it), tree.hop)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


def _through(fn, tree, *args):
    """``tree`` with its tensors that need a gradient passed through the
    identity Function ``fn`` (one node for all of them)."""
    if not torch.is_grad_enabled():
        return tree
    flat: List[torch.Tensor] = []
    _tensors(tree, flat)
    need = [i for i, t in enumerate(flat) if t.requires_grad]
    if not need:
        return tree
    for i, t in zip(need, fn.apply(*args, *(flat[i] for i in need))):
        flat[i] = t
    return _rebuild(tree, iter(flat))


class _Enter(torch.autograd.Function):
    """Identity; its backward closes ``<name>.bwd``."""

    @staticmethod
    def forward(ctx, rec, name, *xs):
        ctx.rec, ctx.name = rec, name
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        if ctx.rec is _REC:
            ctx.rec.close_named(ctx.name + ".bwd")
        return (None, None) + grads


class _Leave(torch.autograd.Function):
    """Identity; its backward opens ``<name>.bwd`` at the forward's
    step."""

    @staticmethod
    def forward(ctx, rec, name, step, *ys):
        ctx.rec, ctx.name, ctx.step = rec, name, step
        ctx.set_materialize_grads(False)
        return ys

    @staticmethod
    def backward(ctx, *grads):
        if ctx.rec is _REC:
            ctx.rec.open(ctx.name + ".bwd", ctx.step)
        return (None, None, None) + grads


def enter(name: str, x):
    """Open the layer ``name`` on its input ``x``; returns ``x`` (itself
    while the recorder is off)."""
    if not _ON:
        return x
    _REC.open(name + ".fwd", _REC.step)
    return _through(_Enter, x, _REC, name)


def leave(name: str, y):
    """Close the layer ``name`` on its output ``y``; returns ``y`` (itself
    while the recorder is off, or where ``enter`` did not open the
    layer)."""
    if not _ON or not _REC.close_named(name + ".fwd"):
        return y
    return _through(_Leave, y, _REC, name, _REC.step)
