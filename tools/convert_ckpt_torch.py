#!/usr/bin/env python
"""Checkpoint migration on the port: re-order the encoder head's
parameter blocks (counterpart of ``tools/convert_ckpt.py``).

Reference subsystem (``convert2v2.py`` + ``models/utils.py:12-38`` +
``test_rtf.py:35-132``): when the decoder's parameter-group order changes
between framework versions, the encoder's single ``out_linear`` head must
have its output-channel blocks permuted to match. This tool applies such a
permutation to a checkpoint of the port (``train/checkpoint.py``: one
``torch.save`` file, the model's state_dict under ``"model"``). A torch
``Linear`` weight is (out, in), so the permuted axis is 0 (flax's Dense
kernel is (in, out), its last). The optimizer state, where there is one,
is left untouched, as the JAX tool leaves its ``opt_state``: restore the
result params-only, or expect Adam's moments in the old order.

Usage:
    python tools/convert_ckpt_torch.py --in ckpt/last --out ckpt/converted \\
        --old-sizes 22 1 22 1 64 --new-order 4 1 0 3 2
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Sequence

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from golf_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402


def permute_out_linear(state: Dict[str, torch.Tensor],
                       old_sizes: Sequence[int], new_order: Sequence[int]
                       ) -> Dict[str, torch.Tensor]:
    """Permute the trailing sum(old_sizes) output channels (axis 0) of
    every out_linear weight and bias of a state_dict (reference
    ``ismir2interspeech_ckpt``); other entries are returned as they are."""
    total = sum(old_sizes)
    offsets = np.cumsum([0] + list(old_sizes))
    out = {}
    for name, arr in state.items():
        if "out_linear" not in name:
            out[name] = arr
            continue
        assert arr.shape[0] >= total, (name, tuple(arr.shape))
        head = arr.shape[0] - total
        index = list(range(head))
        for idx in new_order:
            index.extend(range(head + offsets[idx], head + offsets[idx + 1]))
        out[name] = arr[torch.tensor(index, dtype=torch.long)].clone()
    return out


def convert(src: str, dst: str, old_sizes: Sequence[int],
            new_order: Sequence[int]) -> None:
    state = ckpt_lib.load(src, map_location="cpu")
    state["model"] = permute_out_linear(state["model"], old_sizes, new_order)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    torch.save(state, dst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--old-sizes", type=int, nargs="+", required=True)
    ap.add_argument("--new-order", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    convert(args.inp, args.out, args.old_sizes, args.new_order)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
