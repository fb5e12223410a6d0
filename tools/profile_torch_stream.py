#!/usr/bin/env python3
"""Where the streaming time of the PyTorch/CUDA port goes, on one GPU.

    python tools/profile_torch_stream.py [--out chiprun_out/profile]

The full-width vctk encoder and the GOLF-ss decoder (``golf-precise.yaml``)
with ``chip_smoke.py``'s seeded weights stream its B = 4 x 6 s synthetic
batch in pushes of 2400 samples (``StreamingEncoder`` with a look-ahead of
24 frames, ``GOLFStream`` on the offline ctrl). After 20 warm pushes, a
``torch.profiler`` window over 10 encoder pushes and one over the next 10
decoder pushes give, for each, the wall time a push (host clock around
``synchronize``), the device's busy time a push (the union of its kernel
intervals), the idle share, the CUDA kernels launched a push and the
kernels that take the most device time (in full under ``--out``).

TF32 is off, as in ``chip_smoke.py``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from golf_tpu_torch import kernels  # noqa: E402
from golf_tpu_torch.core.sig import Sig  # noqa: E402
from golf_tpu_torch.serve import GOLFStream, StreamingEncoder, chunk_ctrl  # noqa: E402
from tools.profile_torch_serve import busy_share  # noqa: E402

WARM, MEASURED = 20, 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_stream: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    card = chip_smoke.phase_environment()
    kernels.build(kernels.ALL)
    dev = torch.device("cuda")
    chunk = chip_smoke.STREAM_CHUNK
    x, f0 = chip_smoke.requests(chip_smoke.BATCH, chip_smoke.SECONDS)
    xs, f0s = x.to(dev), f0.to(dev)
    task = chip_smoke.seeded_model("golf-precise", dev)
    task.init_running_stats(Sig(xs, 1), Sig(f0s, 1))
    task.eval()
    se = StreamingEncoder(task.encoder, lookahead=chip_smoke.STREAM_LOOKAHEAD,
                          batch=chip_smoke.BATCH)
    stream = GOLFStream(task.decoder, chunk=chunk)
    with torch.inference_mode():
        raw = task.encoder(Sig(xs, 1), Sig(f0s, 1))
        ctrl = task.decoder.apply_ctrl({k: v for k, v in raw.items()
                                        if k.endswith("_params")})
        phase = task.phase_from_f0(Sig(f0s, 1)).data
        pushes = {
            "encoder": lambda c: se.push(xs[:, c * chunk:(c + 1) * chunk],
                                         f0s[:, c * chunk:(c + 1) * chunk]),
            "decoder": lambda c: stream.push(
                chunk_ctrl(ctrl, c, chunk),
                phase[:, c * chunk:(c + 1) * chunk])}
        for c in range(WARM):
            for push in pushes.values():
                push(c)
        c0 = WARM
        for name, push in pushes.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for c in range(c0, c0 + MEASURED):
                    push(c)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            if name == "encoder":
                # the decoder pushes of the same chunks, unprofiled
                for c in range(c0, c0 + MEASURED):
                    pushes["decoder"](c)
                c0 += MEASURED
            busy_ms, n_kernels = busy_share(prof)
            if not n_kernels:
                print(f"profile stream {name}: the profiler saw no device "
                      f"kernels")
                continue
            print(f"profile stream {name}: {MEASURED} pushes of {chunk} "
                  f"samples, B={chip_smoke.BATCH}: wall {wall_ms / MEASURED:.3f}"
                  f" ms a push, device busy {busy_ms / MEASURED:.3f} ms a "
                  f"push, idle share {1 - busy_ms / wall_ms:.3f}, "
                  f"{n_kernels / MEASURED:.1f} kernels a push")
            table = prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40,
                max_name_column_width=60)
            path = os.path.join(args.out, f"profile_stream_{name}.txt")
            with open(path, "w") as f:
                f.write(f"card: {card}\n{table}\n")
            print(f"profile stream {name}: top kernels by device time "
                  f"({path}):")
            print("\n".join(table.splitlines()[:14]))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
