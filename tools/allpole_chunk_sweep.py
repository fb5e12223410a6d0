#!/usr/bin/env python3
"""B4 (``allpole_tv.cu``) by chunk length, on one GPU.

    python tools/allpole_chunk_sweep.py [--chunks 256 384 512]

At the training shape (B = 64, T = 47 760) and the serving shape (B = 4,
T = 143 761), p = 22, with the coefficients of ``chip_smoke.py``: for each
chunk length, the forward and the adjoint entry's time (CUDA events, as
``chip_smoke.py`` times them), each of their three kernels' device time
(``torch.profiler``), and the largest error against
``allpole_chunked_plain`` at the same chunk length, relative to max|y|.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from golf_tpu_torch import kernels  # noqa: E402
from golf_tpu_torch.ops import allpole as tap  # noqa: E402

SHAPES = (("train", 64, 47760), ("serve", 4, 143761))


def kernel_times(x, a) -> dict:
    """Device microseconds a launch of each kernel (the template arguments
    name the entry: ``<22, false>`` forward, ``<22, true>`` adjoint; the
    carry serves both)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            tap.allpole_cuda(x, a)
            tap.allpole_adjoint_cuda(x, a)
        torch.cuda.synchronize()
    return {ev.key.split("::")[-1].split("(")[0]:
            ev.device_time_total / ev.count
            for ev in prof.key_averages()
            if "_kernel" in ev.key and ev.device_time_total}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, nargs="+", default=[256, 384, 512])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("allpole_chunk_sweep: no CUDA device", file=sys.stderr)
        return 2
    chip_smoke.phase_environment()
    kernels.build(kernels.ALL)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    default = tap.CHUNK
    for label, b, t in SHAPES:
        x, a = chip_smoke.allpole_tv_inputs(
            gen, {"allpole_tv": ((b, t), (b, t, 22))})
        for chunk in args.chunks:
            tap.CHUNK = chunk
            errs = [chip_smoke.rel_err(
                fn(x, a), tap.allpole_chunked_plain(x, a, chunk, adjoint=adj))
                for fn, adj in ((tap.allpole_cuda, False),
                                (tap.allpole_adjoint_cuda, True))]
            fwd = chip_smoke.cuda_ms(lambda: tap.allpole_cuda(x, a), 20)
            adj = chip_smoke.cuda_ms(lambda: tap.allpole_adjoint_cuda(x, a),
                                     20)
            print(f"{label} ({b}, {t}) chunk {chunk}: forward "
                  f"{fwd * 1e3:.1f} us, adjoint {adj * 1e3:.1f} us; error "
                  f"against the mirror {errs[0]:.2e}, {errs[1]:.2e}")
            for name, us in kernel_times(x, a).items():
                print(f"    {name}: {us:.1f} us")
    tap.CHUNK = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
