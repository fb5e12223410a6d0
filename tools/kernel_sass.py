#!/usr/bin/env python3
"""Build the port's CUDA kernels and show what the compiler made of them.

    python tools/kernel_sass.py [--dump SOURCE.cu]

For each source in ``golf_tpu_torch/kernels/csrc``: ptxas's registers,
shared memory and spills per kernel, and a count of the SASS opcodes that
update memory atomically (``ATOMS``: shared, ``ATOMG``/``RED``: global;
a compare-and-swap loop shows as ``ATOMS.CAS``/``ATOMS.CAST``).
``--dump`` also prints the whole SASS of one source. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit), so it runs on the machine with the card.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from golf_tpu_torch import kernels  # noqa: E402


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "cuobjdump")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dump", default=None, help="source whose SASS to print")
    args = ap.parse_args()
    log: dict = {}
    seconds = kernels.build(kernels.ALL, log)
    print(f"build: {seconds:.1f} s")
    done = set()
    for k in kernels.ALL:
        if k.source in done:
            continue
        done.add(k.source)
        for ln in log.get(k.source, "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(f"  ptxas[{k.source}]: {ln.strip()}")
        sass = subprocess.run([_cuobjdump(), "-sass", str(k.library_path)],
                              capture_output=True, text=True, check=True
                              ).stdout
        ops = collections.Counter(
            m.group(1) for m in re.finditer(
                r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)(?:\.[A-Z0-9_]+)*)", sass))
        print(f"{k.source}: atomic opcodes {dict(ops) or 'none'}")
        if args.dump == k.source:
            print(sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
