"""Config trees: ``class_path``/``init_args`` -> objects (counterpart of
``golf_tpu.config.registry``).

Reference-style class paths (``models.sf.X``, ``ltng.ae.X``) and
``golf_tpu.*`` paths are aliased onto this package, so the shipped
``cfg/`` files work as they are; the reference's
``models.unet.TransformerEncoder`` is ``TransformerEncoderBackbone``. ``${dotted.path}`` interpolation and
``a.b=value`` overrides follow the JAX package. PyYAML is imported only
where a YAML file or an override value is parsed.
"""

from __future__ import annotations

import copy
import importlib
import re
from typing import Any, Dict, Optional, Sequence

_PKG = "golf_tpu_torch"
_ALIASES = {
    "models.sf": f"{_PKG}.models.sf",
    "models.synth": f"{_PKG}.models.synth",
    "models.filters": f"{_PKG}.models.filters",
    "models.noise": f"{_PKG}.models.noise",
    "models.ctrl": f"{_PKG}.models.ctrl",
    "models.enc": f"{_PKG}.models.enc",
    "models.unet": f"{_PKG}.models.unet",
    "models.hpn": f"{_PKG}.models.hpn",
    "models.mel": f"{_PKG}.models.mel",
    "models.lpcnet": f"{_PKG}.models.lpcnet",
    "models.lpc": f"{_PKG}.models.lpc",
    "models.lru": f"{_PKG}.models.lru",
    "models.crepe": f"{_PKG}.models.crepe",
    "models.tspn": f"{_PKG}.models.tspn",
    "loss.spec": f"{_PKG}.loss.spec",
    "ltng.ae": f"{_PKG}.tasks.ae",
    "ltng.vocoder": f"{_PKG}.tasks.vocoder",
    "ltng.lpcnet": f"{_PKG}.tasks.lpcnet",
    "ltng.world_ae": f"{_PKG}.tasks.world_ae",
    "ltng.data": f"{_PKG}.tasks.data",
}

_CLASS_RENAMES = {
    # the reference's class, whose name collides with torch's
    # TransformerEncoder
    f"{_PKG}.models.unet.TransformerEncoder":
        f"{_PKG}.models.unet.TransformerEncoderBackbone",
}

_INTERP_RE = re.compile(r"^\$\{([^}]+)\}$")


def resolve_class_path(path: str) -> str:
    mod, _, cls = path.rpartition(".")
    if mod.startswith("golf_tpu."):
        mod = _PKG + mod[len("golf_tpu"):]
    full = f"{_ALIASES.get(mod, mod)}.{cls}"
    return _CLASS_RENAMES.get(full, full)


def import_object(path: str) -> Any:
    mod, _, name = resolve_class_path(path).rpartition(".")
    return getattr(importlib.import_module(mod), name)


def _get_by_dots(tree: Any, dotted: str) -> Any:
    cur = tree
    for part in dotted.split("."):
        if isinstance(cur, dict):
            cur = cur[part]
        elif isinstance(cur, (list, tuple)):
            cur = cur[int(part)]
        else:
            raise KeyError(dotted)
    return cur


def resolve_interpolations(tree: Any, root: Optional[Any] = None) -> Any:
    """Resolve ``${dotted.path}`` against the root; a path that does not
    resolve is left as it is (a ``--model`` file is resolved against its own
    root first, then the merged tree again)."""
    if root is None:
        root = tree

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str):
            m = _INTERP_RE.match(node)
            if m:
                try:
                    target = _get_by_dots(root, m.group(1))
                except (KeyError, IndexError, ValueError, TypeError):
                    return node
                return walk(target)
        return node

    return walk(tree)


def set_by_dots(tree: Dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    cur = tree
    for p in parts[:-1]:
        cur = cur[int(p)] if isinstance(cur, list) else cur.setdefault(p, {})
    if isinstance(cur, list):
        cur[int(parts[-1])] = value
    else:
        cur[parts[-1]] = value


def apply_overrides(cfg: Dict, overrides: Sequence[str]) -> Dict:
    """Apply ``a.b.c=value`` overrides (values parsed as YAML)."""
    import yaml

    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, val = ov.partition("=")
        set_by_dots(cfg, key.lstrip("-"), yaml.safe_load(val))
    return cfg


def deep_update(base: Dict, extra: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def instantiate(node: Any) -> Any:
    """Recursively build the object tree from ``class_path``/``init_args``
    nodes."""
    if isinstance(node, dict):
        if "class_path" in node:
            cls = import_object(node["class_path"])
            return cls(**{k: instantiate(v)
                          for k, v in (node.get("init_args") or {}).items()})
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


def load_config(paths: Sequence[str], model: Optional[str] = None,
                overrides: Sequence[str] = ()) -> Dict:
    """Merge YAML files in order, merge ``model`` into
    ``model.init_args`` (resolved against its own root first), apply
    overrides, resolve interpolations."""
    import yaml

    cfg: Dict = {}
    for path in paths:
        with open(path) as f:
            cfg = deep_update(cfg, yaml.safe_load(f))
    if model:
        with open(model) as f:
            extra = resolve_interpolations(yaml.safe_load(f))
        cfg.setdefault("model", {}).setdefault("init_args", {})
        cfg["model"]["init_args"] = deep_update(cfg["model"]["init_args"],
                                                extra)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return resolve_interpolations(cfg)


def convert2samplewise(config: dict) -> dict:
    """Frame-wise -> sample-wise filters in a config tree, in place (the
    GOLF-fs evaluation of a GOLF-ff model; ``golf_tpu``'s rewriter with
    this package's class paths): the first frame-wise filter node met on a
    walk of the tree takes its ``Precise`` twin and loses the options the
    twin has not (``window``, ``window_length`` and ``centred``, or
    ``conv_method``); a node holding a converted ``class_path`` is not
    walked further."""
    for key, value in config.items():
        if key == "class_path":
            path = config["class_path"]
            if ".LTVMinimumPhaseFilter" in path and "Precise" not in path:
                config["class_path"] = \
                    f"{_PKG}.models.filters.LTVMinimumPhaseFilterPrecise"
                ia = config.get("init_args", {})
                ia.pop("window", None)
                ia.pop("window_length", None)
                ia.pop("centred", None)
                return config
            if ".LTVMinimumPhaseFIRFilter" in path and "Precise" not in path:
                config["class_path"] = \
                    f"{_PKG}.models.filters.LTVMinimumPhaseFIRFilterPrecise"
                config.get("init_args", {}).pop("conv_method", None)
                return config
            if ".LTVZeroPhaseFIRFilter" in path and "Precise" not in path \
                    and "AP" not in path:
                config["class_path"] = \
                    f"{_PKG}.models.filters.LTVZeroPhaseFIRFilterPrecise"
                config.get("init_args", {}).pop("conv_method", None)
                return config
        elif isinstance(value, dict):
            config[key] = convert2samplewise(value)
    return config
