"""The run's environment: the cards it needs, the configured precision,
the card's name and power limit, and the check that no JAX was loaded."""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List

import torch

# top-level module names a run of the port may not load, compared whole:
# the port (golf_tpu_torch) begins with the JAX package's name
FORBIDDEN = ("jax", "jaxlib", "flax", "golf_tpu")


class NoDevice(RuntimeError):
    pass


def require_cuda(chips: int) -> None:
    """Raise unless ``chips`` CUDA cards are visible."""
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the "
                       f"cell needs {chips}")


def set_precision(config: Dict) -> None:
    """The configuration's precision: float32 with TF32 on or off for
    matmuls and cuDNN."""
    tf32 = bool(config["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def card() -> Dict:
    """The card's name (``torch.cuda.get_device_name``) and power limit
    (``nvidia-smi``, or None where it cannot be read)."""
    out = {"kind": torch.cuda.get_device_name(0), "power_limit_w": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        if smi.returncode == 0:
            out["power_limit_w"] = float(smi.stdout.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return out


def forbidden_modules() -> List[str]:
    """The top-level names of ``sys.modules`` that are in FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})
