"""One-way weight bridge: ``golf_tpu`` variables -> this port's state_dict.

Input: the JAX task's variables as nested dicts of numpy arrays, with the
collections ``params``, ``stats`` and ``batch_stats`` (as
``jax.tree_util.tree_map(np.asarray, variables)`` gives them). Output: a
``state_dict`` for ``golf_tpu_torch.tasks.ae.VoiceAutoEncoder``.

Conversions:
* Conv: flax ``(kh, kw, in, out)`` -> torch ``(out, in, kh, kw)``.
* BatchNorm: scale/bias/mean/var -> weight/bias/running_mean/running_var
  (eps is 1e-5 in both).
* LayerNorm: scale/bias -> weight/bias (the port sets flax's eps, 1e-6).
* Dense: ``(in, out)`` -> ``Linear.weight (out, in)``.
* LSTM: flax keeps per-gate input kernels ``i{i,f,g,o}`` without bias and
  recurrent kernels ``h{i,f,g,o}`` with bias; torch takes
  ``weight_ih = cat(i*).T``, ``weight_hh = cat(h*).T`` in gate order
  i, f, g, o, ``bias_hh = cat(h*.bias)`` and ``bias_ih = 0``.
  ``OptimizedLSTMCell_{2l}`` is layer l, ``_{2l+1}`` its reverse.
* State: the acoustic filter's kernel, the running min/max
  (``stats/log_spec_{min,max}``) and the glottal table
  (``batch_stats/glottal_table``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_GATES = ("i", "f", "g", "o")
_SCOPES = {"ConvPyramid_0": "pyramid", "LayerNorm_0": "norm",
           "BiLSTM_0": "lstm.lstm"}
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _lstm_cell(cell: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    w_ih = np.concatenate([cell[f"i{g}/kernel"] for g in _GATES], axis=1).T
    w_hh = np.concatenate([cell[f"h{g}/kernel"] for g in _GATES], axis=1).T
    b_hh = np.concatenate([cell[f"h{g}/bias"] for g in _GATES])
    return {"weight_ih": _t(w_ih), "weight_hh": _t(w_hh),
            "bias_ih": _t(np.zeros_like(b_hh)), "bias_hh": _t(b_hh)}


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Convert ``golf_tpu`` VoiceAutoEncoder variables to a state_dict."""
    flat = {}
    for coll in ("params", "stats", "batch_stats"):
        flat.update(_flatten(variables.get(coll, {})))
    sd: Dict[str, torch.Tensor] = {}
    cells: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    for path, arr in flat.items():
        scope = []
        for part in path[:-1]:
            scope.append(_SCOPES.get(part, part))
        leaf = path[-1]
        m = re.fullmatch(r"OptimizedLSTMCell_(\d+)", path[-3]) \
            if len(path) >= 3 else None
        if m:
            prefix = ".".join(scope[:-2])
            cells.setdefault(prefix, {}).setdefault(int(m.group(1)), {})[
                f"{path[-2]}/{leaf}"] = arr
            continue
        owner = path[-2] if len(path) >= 2 else ""
        if owner.startswith("Conv_"):
            key = ".".join(scope[:-1] + ["convs", owner[5:]])
            sd[f"{key}.{'weight' if leaf == 'kernel' else leaf}"] = _t(
                arr.transpose(3, 2, 0, 1) if leaf == "kernel" else arr)
        elif owner.startswith("BatchNorm_"):
            key = ".".join(scope[:-1] + ["norms", owner[10:]])
            sd[f"{key}.{_LEAF[leaf]}"] = _t(arr)
        elif owner.startswith("Dense_") or owner == "out_linear":
            name = "dense" + owner[6:] if owner.startswith("Dense_") \
                else owner
            key = ".".join(scope[:-1] + [name])
            sd[f"{key}.{'weight' if leaf == 'kernel' else leaf}"] = _t(
                arr.T if leaf == "kernel" else arr)
        elif owner == "LayerNorm_0":
            sd[f"{'.'.join(scope)}.{_LEAF[leaf]}"] = _t(arr)
        elif leaf == "glottal_table":
            sd[".".join(scope + ["table"])] = _t(arr)
        else:                  # room_filter/kernel, log_spec_{min,max}
            sd[".".join(scope + [leaf])] = _t(arr)
    for prefix, by_index in cells.items():
        for idx, cell in by_index.items():
            suffix = f"_l{idx // 2}" + ("_reverse" if idx % 2 else "")
            for name, tensor in _lstm_cell(cell).items():
                sd[f"{prefix}.{name}{suffix}"] = tensor
    return sd


def load_flax_variables(module: nn.Module, variables: Mapping) -> None:
    """Load converted variables into ``module`` strictly: every key of the
    module must come from the variables, except the batch norms' step
    counters, which flax does not keep."""
    sd = flax_to_state_dict(variables)
    own = module.state_dict()
    for key, value in own.items():
        if key.endswith("num_batches_tracked") and key not in sd:
            sd[key] = value
    module.load_state_dict({k: v.to(own[k].device) if k in own else v
                            for k, v in sd.items()}, strict=True)
