#!/usr/bin/env python3
"""How far the float32 forms of the time-varying all-pole filter stray on
resonant filters, on the CPU.

    python tools/allpole_resonance.py [--seeds 6] [--t 4800]

For B = 4 sequences of T samples at order 22, with coefficients from
``golf_tpu_torch.ops.allpole.resonant_inputs`` (rc2lpc(0.95 tanh(.)) and
uncapped rc2lpc(tanh(.)), logits a slow random walk over 240-sample
frames), prints each form's largest error against the float64 sequential
scan, relative to max|y|:

* ``scan32``: the float32 sequential scan (the Pallas kernel's form);
* ``chunked``: ``allpole_chunked_plain`` (the CUDA kernel's algorithm:
  float64 maps, carry and re-run);
* ``blocked32``: ``allpole_plain``, the port's CPU route, which is
  ``golf_tpu``'s float32 blocked two-pass form.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from golf_tpu_torch.ops import allpole as tap  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--t", type=int, default=4800)
    args = ap.parse_args()
    torch.set_num_threads(4)
    print("cap   seed  max|a|  scan32    chunked   blocked32")
    for cap in (0.95, None):
        for seed in range(args.seeds):
            x, a = tap.resonant_inputs(seed, t=args.t, cap=cap)
            ref = tap.allpole_scan(x.double(), a.double())
            if not torch.isfinite(ref).all():
                print(f"{cap!s:5} {seed:4}  float64 output not finite")
                continue
            scale = ref.abs().max()

            def err(y):
                return ((y.double() - ref).abs().max() / scale).item()

            print(f"{cap!s:5} {seed:4}  {a.abs().max().item():6.1f}  "
                  f"{err(tap.allpole_scan(x, a)):.2e}  "
                  f"{err(tap.allpole_chunked_plain(x, a)):.2e}  "
                  f"{err(tap.allpole_plain(x, a)):.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
