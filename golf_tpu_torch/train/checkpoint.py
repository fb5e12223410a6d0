"""Checkpoints (counterpart of ``golf_tpu.train.checkpoint``): the top k by
val_loss and ``last``, each one ``torch.save`` file holding the model's
state_dict (parameters, the batch norms' statistics, the running min/max),
the optimizer's state and the step. Names follow ``golf_tpu``:
``ckpt/last`` and ``ckpt/step=<n>-val_loss=<v>``. An orbax checkpoint of
``golf_tpu`` converts to this layout without the optimizer's state
(``tools/orbax_to_torch.py``), which restores params-only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import torch


def load(path: str, map_location=None) -> Dict:
    """A checkpoint this module wrote (tensors, numbers and dicts only)."""
    return torch.load(path, map_location=map_location, weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, top_k: int = 3):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.top_k = top_k
        self._index_path = os.path.join(self.dir, "index.json")
        self._index: List[Tuple[float, str]] = []
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = [tuple(x) for x in json.load(f)]

    def _write(self, name: str, state: Dict) -> str:
        path = os.path.join(self.dir, name)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        return path

    def save(self, state: Dict, val_loss: Optional[float] = None) -> None:
        """Save ``last`` and, with a val_loss, a top-k entry."""
        self.save_last(state)
        if val_loss is None:
            return
        name = f"step={state['step']}-val_loss={val_loss:.3f}"
        self._write(name, state)
        self._index = [e for e in self._index if e[1] != name]
        self._index.append((float(val_loss), name))
        self._index.sort(key=lambda e: e[0])
        while len(self._index) > self.top_k:
            _, worst = self._index.pop()
            worst_path = os.path.join(self.dir, worst)
            if os.path.exists(worst_path):
                os.remove(worst_path)
        with open(self._index_path, "w") as f:
            json.dump(self._index, f)

    def save_last(self, state: Dict) -> None:
        self._write("last", state)

    def best_path(self) -> Optional[str]:
        if not self._index:
            return None
        return os.path.join(self.dir, self._index[0][1])


def restore_into(path: str, task: torch.nn.Module, optimizer) -> int:
    """Model, optimizer state and step; returns the step."""
    state = load(path, map_location=next(task.parameters()).device)
    if "optimizer" not in state:
        raise ValueError(f"{path} holds no optimizer state: restore it "
                         f"params-only (ckpt_params_only=true)")
    task.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def restore_params_into(path: str, task: torch.nn.Module) -> None:
    """The model's state only (fresh optimizer and step): for evaluation,
    and for finetuning under another optimizer or with the sample-wise
    filters (GOLF-ff and GOLF-ss share one layout). Strict: a key that
    differs raises."""
    state = load(path, map_location=next(task.parameters()).device)
    task.load_state_dict(state["model"])
