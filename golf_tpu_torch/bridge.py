"""One-way weight bridge: ``golf_tpu`` variables -> this port's state_dict.

Input: the JAX task's variables as nested dicts of numpy arrays, with the
collections ``params``, ``stats`` and ``batch_stats`` (as
``jax.tree_util.tree_map(np.asarray, variables)`` gives them). Output: a
``state_dict`` for ``golf_tpu_torch.tasks.ae.VoiceAutoEncoder``,
``golf_tpu_torch.tasks.vocoder.DDSPVocoder``,
``golf_tpu_torch.tasks.lpcnet.LPCNetVocoder`` or a backbone such as
``models.crepe.CREPE`` (``flax_to_state_dict``), or for one of the
standalone modules of ``models/pitchnet.py``, ``models/rnn.py`` and
``models/tspn.py`` (their own functions).

Conversions:
* Conv: flax ``(kh, kw, in, out)`` -> torch ``(out, in, kh, kw)``, and
  ``(k, in, out)`` -> ``Conv1d``'s ``(out, in, k)``.
* BatchNorm: scale/bias/mean/var -> weight/bias/running_mean/running_var
  (eps is 1e-5 in both).
* LayerNorm, GroupNorm: scale/bias -> weight/bias (the port sets flax's
  eps, 1e-6).
* Dense (``Dense_i``, ``out_linear``, LPCNet's ``fc``): ``(in, out)`` ->
  ``Linear.weight (out, in)``.
* GRU (LPCNet's ``GRUCellNoBias``): ``wi (in, 3H)`` and ``wh (H, 3H)`` ->
  ``weight_ih_l0`` and ``weight_hh_l0`` of a bias-free ``nn.GRU``,
  transposed (the gate order r, z, n is the same). The embedding table and
  the head's ``a`` come across as they are.
* ``NonCausalWaveNetLayer_i`` (``WN``'s layers) -> ``layers.i``.
* ``Embed_0`` (``UNetEncoderV2``'s harmonic-mask embedding): ``embedding``
  -> ``embed.weight``.
* ``TransformerEncoderBackbone`` (a scope holding
  ``MultiHeadDotProductAttention_0``), with L attention layers:
  ``MultiHeadDotProductAttention_i`` -> ``layers.i``, whose ``query``,
  ``key`` and ``value`` kernels (c, heads, head_dim) become ``Linear``
  weights (heads head_dim, c) and biases (heads, head_dim) flat, and whose
  ``out`` kernel (heads, head_dim, c) becomes (c, heads head_dim);
  ``Dense_{2i}``, ``Dense_{2i+1}`` -> ``layers.i.ff1``, ``.ff2``;
  ``LayerNorm_{2i}``, ``LayerNorm_{2i+1}`` -> ``layers.i.norm1``,
  ``.norm2``; ``LayerNorm_{2L}`` -> ``final_norm`` and ``LayerNorm_{2L+1}``
  -> ``norm``.
* ``LRUBlock_0`` -> ``lru_block``: its ``Dense_k`` -> ``dense{k}``, its
  ``LayerNorm_i`` -> ``norms.i`` (``LayerNorm_0`` elsewhere is ``norm``),
  ``zi_pred_{re,im}_i`` and ``lru_i/{nu_log, theta_log, B_re, B_im, C_re,
  C_im, D}`` under their own names.
* LSTM: flax keeps per-gate input kernels ``i{i,f,g,o}`` without bias and
  recurrent kernels ``h{i,f,g,o}`` with bias; torch takes
  ``weight_ih = cat(i*).T``, ``weight_hh = cat(h*).T`` in gate order
  i, f, g, o, ``bias_hh = cat(h*.bias)`` and ``bias_ih = 0``.
  ``OptimizedLSTMCell_{2l}`` is layer l, ``_{2l+1}`` its reverse.
* CREPE (``models/crepe.py``): ``Conv_i``, ``BatchNorm_i`` and
  ``out_linear`` by the rules above (``convs.i``, ``norms.i``).
* The standalone modules, each by its own function below: ``PitchNet``
  (``Conv_i`` -> ``convs.i``, ``LayerNorm_i`` -> ``norms.i``, ``Dense_0`` ->
  ``dense``); the one-way ``LSTM`` (``OptimizedLSTMCell_i`` is layer i,
  with no reverse, in ``lstm``); ``TopNGenerator`` (``embeddings`` as it
  is, ``Dense_0`` -> ``proj``); ``TTSPNEncoder`` (``TTSPNEncoderLayer_i``
  -> ``layers.i`` by the transformer backbone's attention rules,
  ``BiLSTM_0`` -> ``lstm.lstm``, ``Dense_0`` -> ``head``).
* State: the acoustic filter's kernel, the running min/max
  (``stats/log_spec_{min,max}``, the vocoder's ``stats/feature_trsfm/
  log_mel_{min,max}``) and the glottal table (``batch_stats/
  glottal_table``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_GATES = ("i", "f", "g", "o")
_SCOPES = {"ConvPyramid_0": "pyramid", "LayerNorm_0": "norm",
           "GroupNorm_0": "group_norm", "BiLSTM_0": "lstm.lstm",
           "LRUBlock_0": "lru_block", "Embed_0": "embed"}
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}
_GRU = {"wi": "weight_ih_l0", "wh": "weight_hh_l0"}


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


def _attention_scopes(flat: Mapping[tuple, np.ndarray]) -> Dict[tuple, int]:
    """The scopes of ``TransformerEncoderBackbone``s: path prefix -> its
    number of attention layers."""
    scopes: Dict[tuple, int] = {}
    for path in flat:
        for k, part in enumerate(path):
            m = re.fullmatch(r"MultiHeadDotProductAttention_(\d+)", part)
            if m:
                scopes[path[:k]] = max(scopes.get(path[:k], 0),
                                       int(m.group(1)) + 1)
    return scopes


def _attention_leaf(path: tuple, arr: np.ndarray, n_layers: int):
    """(name under the backbone, tensor) of a leaf of a transformer
    backbone's attention stack, or None for its other leaves."""
    part, leaf = path[0], path[-1]
    m = re.fullmatch(r"(MultiHeadDotProductAttention|Dense|LayerNorm)_(\d+)",
                     part)
    if m is None:
        return None
    kind, i = m.group(1), int(m.group(2))
    if kind == "MultiHeadDotProductAttention":
        proj = path[1]
        if leaf == "kernel":
            arr = arr.reshape(-1, arr.shape[-1]) if proj == "out" else \
                arr.reshape(arr.shape[0], -1)
            return f"layers.{i}.{proj}.weight", _t(arr.T)
        return f"layers.{i}.{proj}.bias", _t(arr.reshape(-1))
    if kind == "Dense":
        name = f"layers.{i // 2}.ff{i % 2 + 1}"
        return (f"{name}.weight", _t(arr.T)) if leaf == "kernel" else \
            (f"{name}.bias", _t(arr))
    name = f"layers.{i // 2}.norm{i % 2 + 1}" if i < 2 * n_layers else \
        "final_norm" if i == 2 * n_layers else "norm"
    return f"{name}.{_LEAF[leaf]}", _t(arr)


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Convert ``golf_tpu`` VoiceAutoEncoder variables to a state_dict."""
    flat = {}
    for coll in ("params", "stats", "batch_stats"):
        flat.update(_flatten(variables.get(coll, {})))
    sd: Dict[str, torch.Tensor] = {}
    cells: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    attention = _attention_scopes(flat)
    for path, arr in flat.items():
        hit = next(((p, n) for p, n in attention.items()
                    if path[:len(p)] == p and len(path) > len(p) + 1), None)
        if hit is not None:
            prefix, n_layers = hit
            named = _attention_leaf(path[len(prefix):], arr, n_layers)
            if named is not None:
                key = ".".join([_SCOPES.get(p, p) for p in prefix]
                               + [named[0]])
                sd[key] = named[1]
                continue
        scope = []
        for k, part in enumerate(path[:-1]):
            if k and path[k - 1] == "LRUBlock_0" and \
                    re.fullmatch(r"LayerNorm_\d+", part):
                scope.append(f"norms.{part[10:]}")
                continue
            scope.append(_SCOPES.get(part, re.sub(
                r"^NonCausalWaveNetLayer_(\d+)$", r"layers.\1", part)))
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
            if leaf == "kernel":
                arr = arr.transpose((3, 2, 0, 1) if arr.ndim == 4
                                    else (2, 1, 0))
            sd[f"{key}.{'weight' if leaf == 'kernel' else leaf}"] = _t(arr)
        elif owner.startswith("BatchNorm_"):
            key = ".".join(scope[:-1] + ["norms", owner[10:]])
            sd[f"{key}.{_LEAF[leaf]}"] = _t(arr)
        elif owner.startswith("Dense_") or owner in ("out_linear", "fc"):
            name = "dense" + owner[6:] if owner.startswith("Dense_") \
                else owner
            key = ".".join(scope[:-1] + [name])
            sd[f"{key}.{'weight' if leaf == 'kernel' else leaf}"] = _t(
                arr.T if leaf == "kernel" else arr)
        elif re.fullmatch(r"LayerNorm_\d+|GroupNorm_0", owner):
            sd[f"{'.'.join(scope)}.{_LEAF[leaf]}"] = _t(arr)
        elif leaf in _GRU:
            sd[".".join(scope + [_GRU[leaf]])] = _t(arr.T)
        elif owner == "Embed_0":
            sd[".".join(scope + ["weight"])] = _t(arr)
        elif leaf == "glottal_table":
            sd[".".join(scope + ["table"])] = _t(arr)
        else:                  # acoustic filter kernels, running min/max
            sd[".".join(scope + [leaf])] = _t(arr)
    for prefix, by_index in cells.items():
        for idx, cell in by_index.items():
            suffix = f"_l{idx // 2}" + ("_reverse" if idx % 2 else "")
            for name, tensor in _lstm_cell(cell).items():
                sd[f"{prefix}.{name}{suffix}"] = tensor
    return sd


def _params(variables: Mapping) -> Dict[str, Mapping]:
    return variables.get("params", variables)


def _dense(arrays: Mapping, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _t(np.asarray(arrays["kernel"]).T),
            f"{name}.bias": _t(arrays["bias"])}


def pitchnet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``golf_tpu.models.pitchnet.PitchNet``'s variables (or the params
    alone) -> ``models.pitchnet.PitchNet``'s state_dict, float32."""
    sd: Dict[str, torch.Tensor] = {}
    for name, leaves in _params(variables).items():
        kind, _, idx = name.rpartition("_")
        if kind == "Conv":
            sd[f"convs.{idx}.weight"] = _t(
                np.asarray(leaves["kernel"]).transpose(2, 1, 0))
            sd[f"convs.{idx}.bias"] = _t(leaves["bias"])
        elif kind == "LayerNorm":
            sd[f"norms.{idx}.weight"] = _t(leaves["scale"])
            sd[f"norms.{idx}.bias"] = _t(leaves["bias"])
        elif name == "Dense_0":
            sd.update(_dense(leaves, "dense"))
        else:
            raise KeyError(f"unexpected PitchNet parameter {name}")
    return sd


def pitchnet_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``pitchnet_state_dict``: ``models.pitchnet.PitchNet``'s
    state_dict -> ``{"params": ...}`` in ``golf_tpu``'s layout (float32
    numpy), for writing a flax state file."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in state_dict.items():
        a = value.detach().cpu().float().numpy()
        mod, *idx, leaf = key.split(".")
        if mod == "convs":
            params.setdefault(f"Conv_{idx[0]}", {})[
                "kernel" if leaf == "weight" else "bias"] = \
                np.ascontiguousarray(a.transpose(2, 1, 0)) \
                if leaf == "weight" else a
        elif mod == "norms":
            params.setdefault(f"LayerNorm_{idx[0]}", {})[
                "scale" if leaf == "weight" else "bias"] = a
        elif mod == "dense":
            params.setdefault("Dense_0", {})[
                "kernel" if leaf == "weight" else "bias"] = \
                np.ascontiguousarray(a.T) if leaf == "weight" else a
        else:
            raise KeyError(f"unexpected PitchNet state {key}")
    return {"params": params}


def lstm_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``golf_tpu.models.rnn.LSTM``'s variables -> ``models.rnn.LSTM``'s
    state_dict: ``OptimizedLSTMCell_i`` is layer i of ``lstm``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, cell in _params(variables).items():
        m = re.fullmatch(r"OptimizedLSTMCell_(\d+)", name)
        if m is None:
            raise KeyError(f"unexpected LSTM parameter {name}")
        flat = {"/".join(k): v for k, v in _flatten(cell).items()}
        for key, tensor in _lstm_cell(flat).items():
            sd[f"lstm.{key}_l{m.group(1)}"] = tensor
    return sd


def topn_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``golf_tpu.models.tspn.TopNGenerator`` -> ``models.tspn.
    TopNGenerator``: the stored embeddings as they are, ``Dense_0`` ->
    ``proj``."""
    p = _params(variables)
    return {"embeddings": _t(p["embeddings"]), **_dense(p["Dense_0"], "proj")}


def tspn_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``golf_tpu.models.tspn.TTSPNEncoder`` -> ``models.tspn.
    TTSPNEncoder``: ``TTSPNEncoderLayer_i`` -> ``layers.i`` (the query,
    key, value and out projections, ``ff1``, ``ff2``, ``norm1``,
    ``norm2``), ``BiLSTM_0`` -> ``lstm.lstm``, ``Dense_0`` -> ``head``."""
    sd: Dict[str, torch.Tensor] = {}
    rest = {}
    for name, sub in _params(variables).items():
        m = re.fullmatch(r"TTSPNEncoderLayer_(\d+)", name)
        if m is None:
            rest[name] = sub
            continue
        for path, arr in _flatten(sub).items():
            key, tensor = _attention_leaf(path, arr, 1)
            sd[key.replace("layers.0.", f"layers.{m.group(1)}.", 1)] = tensor
    sd.update(_dense(rest.pop("Dense_0"), "head"))
    sd.update(flax_to_state_dict({"params": rest}))
    return sd


def load_flax_variables(module: nn.Module, variables: Mapping,
                        convert=flax_to_state_dict) -> None:
    """Load converted variables into ``module`` strictly: every key of the
    module must come from the variables, except the batch norms' step
    counters, which flax does not keep. ``convert`` is the conversion:
    ``flax_to_state_dict`` or one of the standalone modules' functions."""
    sd = convert(variables)
    own = module.state_dict()
    for key, value in own.items():
        if key.endswith("num_batches_tracked") and key not in sd:
            sd[key] = value
    module.load_state_dict({k: v.to(own[k].device) if k in own else v
                            for k, v in sd.items()}, strict=True)
