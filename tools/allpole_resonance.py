#!/usr/bin/env python3
"""How far the float32 forms of the all-pole filters stray on resonant
filters, on the CPU.

    python tools/allpole_resonance.py [--seeds 6] [--t 4800]
    python tools/allpole_resonance.py --const [--seeds 4]

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

With ``--const``, the constant-coefficient filter (GOLF-ff's end filter)
on N = 256 rows of T = 960 at order 22, coefficients from
``resonant_const_inputs`` (rc2lpc(0.95 tanh(z)) and uncapped, z ~ N(0, 1)
per row and tap), against the float64 scan:

* ``scan32``: the float32 sequential scan (the Pallas kernel's form);
* ``scan64``: ``allpole_const_scan64`` (the CUDA kernel's arithmetic:
  float64 state and sums);
* ``blocked32``: ``allpole_const_plain``, the port's CPU route, which is
  ``golf_tpu``'s float32 blocked form, over its finite rows, with the
  count of rows that are not finite.
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
    ap.add_argument("--const", action="store_true",
                    help="the constant-coefficient filter")
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.const:
        return const_main(args.seeds)
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


def const_main(seeds: int) -> int:
    print("cap   seed  max|a|  scan32    scan64    blocked32 (non-finite "
          "rows of 256)")
    for cap in (0.95, None):
        for seed in range(seeds):
            x, a = tap.resonant_const_inputs(seed, cap=cap)
            n, t = x.shape
            a_tv = a[:, None, :].expand(n, t, a.shape[1])
            ref = tap.allpole_scan(x.double(), a_tv.double())
            if not torch.isfinite(ref).all():
                print(f"{cap!s:5} {seed:4}  float64 output not finite")
                continue
            scale = ref.abs().max()

            def err(y):
                return ((y.double() - ref).abs().max() / scale).item()

            blocked = tap.allpole_const_plain(x, a)
            finite = torch.isfinite(blocked).all(dim=1)
            err_b = ((blocked[finite].double() - ref[finite]).abs().max()
                     / scale).item()
            print(f"{cap!s:5} {seed:4}  {a.abs().max().item():6.1f}  "
                  f"{err(tap.allpole_scan(x, a_tv)):.2e}  "
                  f"{err(tap.allpole_const_scan64(x, a)):.2e}  "
                  f"{err_b:.2e} ({int((~finite).sum())})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
