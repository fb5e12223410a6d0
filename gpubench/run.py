#!/usr/bin/env python3
"""The benchmark of ``golf_tpu_torch`` on NVIDIA GPUs: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic mix, limits and metrics are
files under ``gpubench/`` found by name (``gpubench/README.md``). The run
makes the weights and the inputs from ``--seed`` on the card, warms up the
cell's shapes (set-up, ``setup_s``), drives the traffic for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics from a profiled part of the window), ``device``
and, last, the numbers compared beside their limits, which also end
standard error.

Exits 2 on bad arguments, 3 without the CUDA cards the cell needs, 4 if a
JAX module (``jax``, ``jaxlib``, ``flax``) or the JAX package
(``golf_tpu``) was loaded, printing no result in those cases. Caches of
compiled code go to fixed directories inside the checkout: the program's
kernels to ``golf_tpu_torch/kernels/build/``, anything else to
``.gpubench-cache/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".gpubench-cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "golf_tpu_torch").is_dir():
        print("gpubench: golf_tpu_torch is not in this checkout",
              file=sys.stderr)
        return 2
    import torch

    from gpubench.harness import env, session, spec

    cell = spec.load_cell(args.workload)
    try:
        env.require_cuda(cell.chips)
    except env.NoDevice as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 3
    card = env.card()
    rec, numbers = session.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace),
                                    torch.device("cuda", 0), T_START)
    found = env.forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    out = session.result(cell, rec, numbers, bool(args.trace), card)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
