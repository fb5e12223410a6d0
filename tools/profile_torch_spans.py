#!/usr/bin/env python3
"""The program's own spans and counters (``golf_tpu_torch.utils.profiling``)
in the benchmark's cells, on one GPU.

    python3 tools/profile_torch_spans.py [--workloads <cell> ...]
        [--seed 7] [--steps 6] [--out chiprun_out/spans]

Each cell of ``BENCHMARK.json`` (all of them by default) is set up as
``gpubench/run.py`` sets it up (its configuration, precision, weights and
batches from the seed, through ``gpubench/harness``), with the recorder on
from before the kernels are bound to the end of set-up. Then, ``--steps``
steps (or batches) each:

1. the cost of recording: the recorder off, on, on, off, by the host clock
   to a ``synchronize`` (ms a step);
2. the recorder on with the benchmark's outside layer spans
   (``gpubench/harness/trace.py::Spans``) on the same steps: the program's
   ``encoder`` span against the benchmark's ``encoder_ms``;
3. one step with the sync debug mode's reports kept: the source line of
   each synchronizing call;
4. ``torch.profiler`` with the recorder off, then on: the device kernels a
   step in each (equal where no ``golf.`` range leaks into the
   operations, and none is in the first), and with the recorder on every
   device idle gap charged to the innermost ``golf.`` span the host was in
   at the gap's middle, and each device kernel's time charged to the
   innermost ``golf.`` span whose host operations launched it (the top
   kernels of each span).

It prints a line a cell: the spans' device ms a step, their self time,
``host_syncs`` by span, the set-up spans' host seconds, the encoder's
stage coverage and the idle by span, and writes them in full to
``<out>/<cell>.json``. TF32 as the configuration states. ``--device cpu
--batch 2 --audio-seconds 0.25`` rehearses it on the CPU (no device
times, no profile).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from golf_tpu_torch.utils import profiling  # noqa: E402
from gpubench.harness import env, inputs, program, spec, trace  # noqa: E402
from gpubench.reference import golf as ref  # noqa: E402

STAGES = ("encoder.features", "encoder.pyramid", "encoder.lstm",
          "encoder.head")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _layer_ms(totals, name):
    """Device ms of ``<name>.fwd`` and ``<name>.bwd``, summed."""
    return sum(totals.get(f"{name}.{d}", {}).get("device_ms") or 0.0
               for d in ("fwd", "bwd"))


class Cell:
    """One cell's program, set up with the recorder on, and its step."""

    def __init__(self, name: str, seed: int, device, batch=None,
                 audio_seconds=None):
        self.cell = spec.load_cell(name)
        self.traffic = tr = dict(self.cell.traffic)
        if batch:
            tr["batch"] = batch
        if audio_seconds:
            tr["seconds"] = audio_seconds
        self.device = device
        self.kind = tr["kind"]
        t0 = time.perf_counter()
        with profiling.recording() as rec:
            env.set_precision(self.cell.config)
            program.build_kernels(device)
            weights = inputs.draw_weights(
                ref.GOLF(self.cell.config, "cpu").param_spec(), seed, device)
            self.batches = inputs.pool(tr, seed, device)
            cls = program.Training if self.kind == "train" else \
                program.Resynthesis
            self.prog = cls(self.cell.config, weights, self.batches[0],
                            device)
            self.i = 0
            t1 = time.perf_counter()
            self.step()
            _sync(device)
            first_s = time.perf_counter() - t1
            warm = tr["first"] + tr["warmup"] - 1 if self.kind == "train" \
                else tr["warmup"] - 1
            for _ in range(warm):
                self.step()
            _sync(device)
        self.setup_s = time.perf_counter() - t0
        totals = rec.totals()
        first = [s for s in rec.spans if s.step == 0 and s.parent is None]
        self.setup = {
            "build": {k: totals[k]["host_s"] for k in
                      ("build.kernels", "build.model", "init_running_stats")
                      if k in totals},
            "first_step_spans_s": sum(s.host_s for s in first),
            "first_step_synced_s": first_s,
            "setup_s": self.setup_s,
            "host_syncs": rec.counts.get("host_syncs", {})}

    def step(self, spans=None) -> None:
        b = self.batches[self.i % len(self.batches)]
        self.i += 1
        if self.kind == "train":
            self.prog.step(b, spans)
        else:
            self.prog.predict(b)

    def timed(self, n: int) -> float:
        """ms a step over ``n`` steps ended by a sync."""
        _sync(self.device)
        t0 = time.perf_counter()
        for _ in range(n):
            self.step()
        _sync(self.device)
        return (time.perf_counter() - t0) * 1e3 / n


def idle_by_span(prof, steps: int):
    """Device kernels a step (``golf.`` and ``gpubench.kernel.`` ranges
    left out), ``golf.`` device events, and each idle gap between the
    device's busy intervals charged to the innermost ``golf.`` host range
    open at its middle (ms a step, by span)."""
    events = list(prof.events())
    ranges = (profiling.RANGE, trace.RANGE)
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = sorted((e for e in dev if not e.name.startswith(ranges)),
                 key=lambda e: e.time_range.start)
    golf_dev = sum(1 for e in dev if e.name.startswith(profiling.RANGE))
    merged = []
    for e in ops:
        s, t = e.time_range.start, e.time_range.end
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    host = [e for e in events if e.device_type != DeviceType.CUDA
            and e.name.startswith(profiling.RANGE)]
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    out, idle = {}, 0.0
    for a, b in zip(merged[:-1], merged[1:]):
        if b[0] <= a[1]:
            continue
        gap, mid = b[0] - a[1], (a[1] + b[0]) / 2
        idle += gap
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = "(no span)"
        if inside.size:
            k = inside[np.argmin(ends[inside] - starts[inside])]
            name = host[k].name[len(profiling.RANGE):]
        out[name] = out.get(name, 0.0) + gap / 1e3 / steps
    kernels = sum(1 for e in ops if not e.name.lower().startswith(
        ("memcpy", "memset")))
    busy = sum(t - s for s, t in merged)
    return {"kernels_per_step": kernels / steps, "golf_device_events":
            golf_dev, "busy_ms_per_step": busy / 1e3 / steps,
            "idle_ms_per_step": idle / 1e3 / steps,
            "idle_by_span_ms": dict(sorted(out.items(),
                                           key=lambda kv: -kv[1]))}


def kernels_by_span(prof, steps: int, top: int = 8):
    """The device kernels each innermost ``golf.`` host range launched
    (through its operations' own kernels), ms a step by kernel name, the
    ``top`` longest a span."""
    by_span = {}

    def walk(ev, span):
        if ev.name.startswith(profiling.RANGE):
            span = ev.name[len(profiling.RANGE):]
        for k in ev.kernels:
            d = by_span.setdefault(span, {})
            d[k.name] = d.get(k.name, 0.0) + k.duration / 1e3 / steps
        for child in ev.cpu_children:
            walk(child, span)

    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA and ev.cpu_parent is None:
            walk(ev, "(no span)")
    return {span: dict(sorted(d.items(), key=lambda kv: -kv[1])[:top])
            for span, d in by_span.items()}


def sync_sites(cell: Cell):
    """The source lines of the synchronizing calls of one step, as the
    sync debug mode reports them, with their counts."""
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.filterwarnings("always",
                                message=f".*{profiling.SYNC_MESSAGE}")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cell.step()
            _sync(cell.device)
        finally:
            torch.cuda.set_sync_debug_mode(before)
    sites = {}
    for w in caught:
        if profiling.SYNC_MESSAGE in str(w.message):
            where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            sites[where] = sites.get(where, 0) + 1
    return sites


def profiled(cell: Cell, n: int, record: bool):
    with profiling.recording() if record else contextlib.nullcontext():
        with trace.profiler() as prof:
            for _ in range(n):
                cell.step()
            _sync(cell.device)
    out = idle_by_span(prof, n)
    if record:
        out["kernels_by_span_ms"] = kernels_by_span(prof, n)
    return out


def measure(name: str, seed: int, steps: int, device, batch=None,
            audio_seconds=None):
    cell = Cell(name, seed, device, batch, audio_seconds)
    n = steps
    # 1. the cost of recording, in turns
    off = [cell.timed(n)]
    on = []
    for _ in range(2):
        with profiling.recording():
            on.append(cell.timed(n))
    off.append(cell.timed(n))
    # 2. the program's spans with the benchmark's outside spans
    outside = trace.Spans(cell.prog.task, cell.kind == "train") \
        if device.type == "cuda" else None
    try:
        with profiling.recording() as rec:
            for _ in range(n):
                cell.step(outside)
    finally:
        if outside is not None:
            outside.remove()
    harness = {} if outside is None else outside.totals()
    totals, selfs = rec.totals(), rec.self_times()
    per = {k: {"n": v["n"] / n, "host_ms": v["host_s"] * 1e3 / n,
               "device_ms": None if v["device_ms"] is None
               else v["device_ms"] / n} for k, v in totals.items()}
    self_ms = {k: {"host_ms": v["host_s"] * 1e3 / n,
                   "device_ms": None if v["device_ms"] is None
                   else v["device_ms"] / n} for k, v in selfs.items()}
    syncs = rec.counts.get("host_syncs", {})
    enc = _layer_ms(totals, "encoder") / n
    stages = sum(_layer_ms(totals, s) for s in STAGES) / n
    out = {
        "cell": name, "device": str(device), "steps": n,
        "card": torch.cuda.get_device_name(0) if device.type == "cuda"
        else "cpu",
        "step_ms_off": off, "step_ms_on": on,
        "spans_per_step": per, "self_per_step": self_ms,
        "host_syncs_per_step": {str(k): v / n for k, v in syncs.items()},
        "host_syncs_total_per_step": sum(syncs.values()) / n,
        "encoder_ms": enc, "stages_ms": stages,
        "stage_coverage": stages / enc if enc else None,
        "layer_ms": {s: _layer_ms(totals, s) / n
                     for s in ("encoder",) + STAGES + ("decoder", "loss")},
        "harness_encoder_ms": sum(v for k, v in harness.items()
                                  if k.startswith("encoder.")) / n
        if harness else None,
        "setup": cell.setup,
    }
    if device.type == "cuda":
        out["sync_sites"] = sync_sites(cell)
        out["profile_off"] = profiled(cell, n, False)
        out["profile_on"] = profiled(cell, n, True)
        lstm = sum(v for k, v in out["profile_on"]["idle_by_span_ms"].items()
                   if k.startswith("encoder.lstm."))
        out["encoder_lstm_idle_ms"] = lstm
    cell.prog.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", nargs="*", default=None)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--audio-seconds", type=float, default=None)
    ap.add_argument("--out", default="chiprun_out/spans")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    names = args.workloads or [w["name"] for w in spec.load_json(
        ROOT / "BENCHMARK.json")["workloads"]]
    os.makedirs(args.out, exist_ok=True)
    for k, name in enumerate(names):
        out = measure(name, args.seed + k, args.steps, device, args.batch,
                      args.audio_seconds)
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(out, f, indent=1)
        brief = {k: out[k] for k in (
            "cell", "card", "step_ms_off", "step_ms_on", "encoder_ms",
            "stage_coverage", "harness_encoder_ms", "layer_ms",
            "host_syncs_per_step", "sync_sites", "setup",
            "encoder_lstm_idle_ms")
            if k in out}
        for k in ("profile_off", "profile_on"):
            if k in out:
                brief[k] = {kk: v for kk, v in out[k].items()
                            if kk not in ("idle_by_span_ms",
                                          "kernels_by_span_ms")}
        if "profile_on" in out:
            brief["idle_by_span_ms"] = dict(list(
                out["profile_on"]["idle_by_span_ms"].items())[:12])
            brief["pyramid_fwd_kernels_ms"] = out["profile_on"][
                "kernels_by_span_ms"].get("encoder.pyramid.fwd")
        print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
