"""Spans and the device trace of a traced run.

* Layer spans from outside the program (``"spans": "hooks"``, the
  default): CUDA events recorded by hooks around the calls into each
  layer of ``golf_tpu_torch``'s voice autoencoder: forward pre/post hooks
  on the encoder and the decoder (whose ``apply_ctrl``, called outside its
  ``forward``, is wrapped too), a wrapper around the task's criterion, and
  around the optimizer's step. A layer's backward runs from the moment the
  gradient reaches the output of the layer after it (a tensor hook) to the
  moment it reaches the layer's own output, the encoder's to the end of
  the backward pass. Idle gaps inside a span count in it.
* The program's own spans (``"spans": "program"``): the spans that
  ``golf_tpu_torch.utils.profiling``'s recorder records at the program's
  layer boundaries, read from the CUDA events it takes at each span's open
  and close.
* Kernel ranges: a ``record_function`` range named after the kernel
  around every ``CudaKernel.launch``, with the operand shapes of each
  launch; the kernel's device time is that of the device operations inside
  the device-side span the profiler records for each range.
* The ``torch.profiler`` window: the device's busy time (the union of its
  operations' intervals), the count of device kernels, the operations that
  took most device time, and the longest idle gaps by what the host was
  doing.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from golf_tpu_torch import kernels
from golf_tpu_torch.core.sig import Sig

RANGE = "gpubench.kernel."


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _tensor_of(out) -> Optional[torch.Tensor]:
    if isinstance(out, Sig):
        return out.data
    if isinstance(out, torch.Tensor):
        return out
    return None


class Spans:
    """CUDA-event spans of the encoder, the decoder, the loss and the
    optimizer, summed over the steps traced (ms)."""

    def __init__(self, task, backward: bool):
        self.task = task
        self.backward = backward
        self.pairs: Dict[str, List] = {}
        self.marks: List = []
        self.handles = []
        self._open: Dict[str, torch.cuda.Event] = {}
        for name, mod in (("encoder", task.encoder),
                          ("decoder", task.decoder)):
            self.handles += [
                mod.register_forward_pre_hook(
                    lambda _m, _a, name=name: self._start(name)),
                mod.register_forward_hook(
                    lambda _m, _a, out, name=name: self._stop(name, out))]
        # the encoder's output, as the backward reaches it
        self.handles.append(task.encoder.backbone.register_forward_hook(
            lambda _m, _a, out: self._mark("encoder", out)))
        apply_ctrl = task.decoder.apply_ctrl

        def timed_ctrl(raw):
            self._start("decoder")
            out = apply_ctrl(raw)
            self._stop("decoder", None)
            return out

        task.decoder.apply_ctrl = timed_ctrl
        criterion = task.criterion

        def timed_loss(pred, target):
            self._start("loss")
            loss = criterion(pred, target)
            self._stop("loss", None)
            self._mark("loss", loss)
            return loss

        task.criterion = timed_loss
        self._criterion = criterion

    def _start(self, name):
        self._open[name] = _event()

    def _stop(self, name, out):
        self.pairs.setdefault(name, []).append((self._open.pop(name),
                                                _event()))
        if name == "decoder" and out is not None:
            self._mark("decoder", out)

    def _mark(self, name, out):
        t = _tensor_of(out)
        if self.backward and t is not None and t.requires_grad:
            t.register_hook(lambda g, name=name: self.marks.append(
                (name, _event())))

    def step_end(self):
        """After a step's backward: the backward's end."""
        if self.backward:
            self.marks.append(("end", _event()))

    @contextlib.contextmanager
    def optimizer(self):
        """A context around the optimizer's step."""
        start = _event()
        yield
        self.pairs.setdefault("optimizer", []).append((start, _event()))

    def totals(self) -> Dict[str, float]:
        """ms of each span over the steps traced: ``<layer>.fwd``,
        ``<layer>.bwd``, ``optimizer``."""
        torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for name, pairs in self.pairs.items():
            key = name if name == "optimizer" else f"{name}.fwd"
            out[key] = sum(a.elapsed_time(b) for a, b in pairs)
        # backward: loss -> decoder -> encoder -> end, step by step
        layer_after = {"loss": "loss.bwd", "decoder": "decoder.bwd",
                       "encoder": "encoder.bwd"}
        for (name, a), (_, b) in zip(self.marks[:-1], self.marks[1:]):
            if name in layer_after:
                key = layer_after[name]
                out[key] = out.get(key, 0.0) + a.elapsed_time(b)
        return out

    def remove(self):
        for h in self.handles:
            h.remove()
        self.task.criterion = self._criterion
        del self.task.decoder.apply_ctrl


class KernelRanges:
    """``record_function`` ranges around every ``CudaKernel.launch`` and
    the operand shapes of each launch, by kernel name."""

    def __init__(self):
        self.shapes: Dict[str, List] = {}
        self._orig = kernels.CudaKernel.launch
        orig, shapes = self._orig, self.shapes

        def launch(kernel, *args, **kw):
            shapes.setdefault(kernel.name, []).append(kw.get("shapes", ()))
            with record_function(RANGE + kernel.name):
                return orig(kernel, *args, **kw)

        kernels.CudaKernel.launch = launch

    def remove(self):
        kernels.CudaKernel.launch = self._orig


def _is_device(ev) -> bool:
    return ev.device_type == DeviceType.CUDA


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def read_profile(prof, window_s: float) -> Dict:
    """The trace's numbers: busy seconds, device kernels, each kernel
    range's device seconds (the device operations inside the range's
    device-side span, which the profiler records for every
    ``record_function`` range that launched work) and count, the top
    device operations and the longest idle gaps by the host operation
    running in them."""
    events = list(prof.events())
    dev = [e for e in events if _is_device(e)]
    ops = sorted((e for e in dev if not e.name.startswith(RANGE)),
                 key=lambda e: e.time_range.start)
    spans = [(e.time_range.start, e.time_range.end) for e in ops]
    busy, end = 0.0, float("-inf")
    merged: List[List[float]] = []
    for s, e in spans:
        if s > end:
            busy += e - s
            merged.append([s, e])
            end = e
        elif e > end:
            busy += e - end
            merged[-1][1] = e
            end = e
    starts = [s for s, _ in spans]
    ranges: Dict[str, Dict] = {}
    for e in dev:
        if not e.name.startswith(RANGE):
            continue
        lo, hi = e.time_range.start, e.time_range.end
        r = ranges.setdefault(e.name[len(RANGE):],
                              {"device_s": 0.0, "ranges": 0})
        r["ranges"] += 1
        for j in range(bisect.bisect_left(starts, lo), len(spans)):
            s, t = spans[j]
            if s > hi:
                break
            if t <= hi:
                r["device_s"] += (t - s) / 1e6
    by_name: Dict[str, float] = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e6, "trace_window_s": window_s,
            "kernels": sum(1 for e in ops if _is_kernel(e.name)),
            "ranges": ranges, "device_ops": [[n, s] for n, s in top],
            "idle_gaps": idle_gaps(events, merged)}


def idle_gaps(events, merged: List[List[float]], top: int = 10,
              longest: int = 400) -> List:
    """The ``longest`` gaps between the device's busy intervals, each named
    by the innermost host operation running at its middle, summed by name:
    the ``top`` names by seconds."""
    gaps = [(b[0] - a[1], (a[1] + b[0]) / 2)
            for a, b in zip(merged[:-1], merged[1:]) if b[0] > a[1]]
    gaps = sorted(gaps, reverse=True)[:longest]
    host = [e for e in events if not _is_device(e)
            and not e.name.startswith(RANGE)]
    if not gaps or not host:
        return []
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    names = [e.name for e in host]
    out: Dict[str, float] = {}
    for length, mid in gaps:
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if inside.size:
            k = inside[np.argmin(ends[inside] - starts[inside])]
            name = names[k]
        else:
            name = "(no host operation)"
        out[name] = out.get(name, 0.0) + length / 1e6
    return [[n, s] for n, s in sorted(out.items(), key=lambda kv: -kv[1])
            [:top]]


def program_spans(rec) -> Dict[str, float]:
    """ms of each of the program's spans over the steps recorded, summed by
    name: the device time between the CUDA events its recorder takes on
    the stream at the span's open and close (idle gaps inside count, as in
    the hooks' spans); without CUDA (the CPU tests), the host time."""
    return {name: t["host_s"] * 1e3 if t["device_ms"] is None
            else t["device_ms"] for name, t in rec.totals().items()}


def profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
