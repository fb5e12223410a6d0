#!/usr/bin/env python3
"""Convert a golf_tpu orbax checkpoint into a checkpoint of the PyTorch port.

    python tools/orbax_to_torch.py <run_dir>/ckpt/last <out_file>

The checkpoint is restored without a template, so its optimizer's layout
(Adam, SGD or another) does not matter and is not carried over. Its
``params``, ``stats`` and ``batch_stats`` go through
``golf_tpu_torch.bridge`` into the port's ``state_dict``, with the batch
norms' step counters, which flax does not keep, at 0. The output is the
port's ``torch.save`` layout without an optimizer state,
``{"model": state_dict, "step": n}``: it restores params-only
(``Trainer.restore(path, params_only=True)``, and the CLI's
``--ckpt_path`` for ``validate``, ``test`` and ``predict``, or for ``fit``
with ``ckpt_params_only=true``).

Needs JAX and orbax, and runs on the host's CPU. Nothing in
``golf_tpu_torch`` imports this file.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from golf_tpu_torch.bridge import flax_to_state_dict  # noqa: E402

COLLECTIONS = ("params", "stats", "batch_stats")


def convert(src: str, dst: str) -> int:
    """Write ``src``'s model variables to ``dst``; returns the step."""
    import jax
    import orbax.checkpoint as ocp

    jax.config.update("jax_platforms", "cpu")
    restored = ocp.StandardCheckpointer().restore(os.path.abspath(src))
    variables = {k: jax.tree_util.tree_map(np.asarray, restored[k])
                 for k in COLLECTIONS if k in restored}
    state = flax_to_state_dict(variables)
    for key in [k for k in state if k.endswith(".running_mean")]:
        state[key[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0)
    step = int(restored.get("step", 0))
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    torch.save({"model": state, "step": step}, dst)
    return step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="golf_tpu orbax checkpoint directory")
    ap.add_argument("dst", help="output file")
    args = ap.parse_args()
    step = convert(args.src, args.dst)
    print(f"{args.src} (step {step}) -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
