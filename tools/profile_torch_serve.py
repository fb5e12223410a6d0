#!/usr/bin/env python3
"""Where the serving time of the PyTorch/CUDA port goes, on one GPU.

    python tools/profile_torch_serve.py [--out chiprun_out/profile]

For the GOLF-ff (``golf.yaml``) and GOLF-ss (``golf-precise.yaml``)
decoders on the full-width vctk encoder, with the seeded weights and the
4 x 6 s synthetic batch of ``chip_smoke.py``:

* each module's time inside one batched predict, from CUDA events recorded
  by forward hooks around the module (median of 5 predicts; includes any
  idle gaps inside the module);
* a ``torch.profiler`` window over 3 predicts: the device's busy time (the
  union of its kernel intervals) over the window's wall time, and the
  kernels that take the most device time (written in full to ``--out``).

TF32 is off, as in ``chip_smoke.py``'s parity phases. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from golf_tpu_torch import kernels  # noqa: E402
from golf_tpu_torch.core.sig import Sig  # noqa: E402

STAGES = ("encoder", "encoder.backbone.pyramid", "encoder.backbone.lstm",
          "decoder.harm_oscillator", "decoder.noise_generator",
          "decoder.noise_filter", "decoder.end_filter", "decoder.room_filter")


def stage_times(task, predict, reps: int = 5) -> dict:
    """Median ms of each STAGES module inside one predict, by CUDA events."""
    marks = {name: [] for name in STAGES}
    handles = []
    for name in STAGES:
        mod = task.get_submodule(name)

        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name].append([ev, None])

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name][-1][1] = ev

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    totals = []
    per_rep = {name: [] for name in STAGES}
    for _ in range(reps):
        for name in STAGES:
            marks[name].clear()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        predict()
        stop.record()
        torch.cuda.synchronize()
        totals.append(start.elapsed_time(stop))
        for name in STAGES:
            per_rep[name].append(sum(a.elapsed_time(b) for a, b in marks[name]))
    for h in handles:
        h.remove()
    out = {name: statistics.median(v) for name, v in per_rep.items()}
    out["predict"] = statistics.median(totals)
    return out


def busy_share(prof) -> tuple:
    """(device busy ms, kernel count): the union of the trace's kernel
    intervals."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3, len(spans)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    card = chip_smoke.phase_environment()
    kernels.build(kernels.ALL)
    dev = torch.device("cuda")
    x, f0 = chip_smoke.requests(chip_smoke.BATCH, chip_smoke.SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    for decoder in ("golf", "golf-precise"):
        task = chip_smoke.seeded_model(decoder, dev)
        task.init_running_stats(xs, f0s)
        task.eval()
        gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)

        def predict():
            return task.predict_step(xs, f0s, generator=gen)

        with torch.inference_mode():
            for _ in range(2):
                predict()
            torch.cuda.synchronize()
            stages = stage_times(task, predict)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    predict()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, n_kernels = busy_share(prof)
        print(f"profile {decoder}: stage ms (median of 5, B={chip_smoke.BATCH}"
              f" x {chip_smoke.SECONDS:.0f} s): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in stages.items()))
        if n_kernels:
            print(f"profile {decoder}: 3 predicts, wall {wall_ms:.2f} ms, "
                  f"device busy {busy_ms:.2f} ms, idle share "
                  f"{1 - busy_ms / wall_ms:.3f}, {n_kernels} kernels")
        else:
            print(f"profile {decoder}: the profiler saw no device kernels")
        table = prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40, max_name_column_width=60)
        path = os.path.join(args.out, f"profile_{decoder}.txt")
        with open(path, "w") as f:
            f.write(f"card: {card}\n{table}\n")
        print(f"profile {decoder}: top kernels by device time ({path}):")
        print("\n".join(table.splitlines()[:18]))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
