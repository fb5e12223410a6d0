"""Inference with the shipped neural pitch estimator (counterpart of
``golf_tpu.utils.pitchnet``).

``predict(x, sr)`` frames the waveform (5 ms hop), runs ``PitchNet`` on
batches of 512 frames on the card (``device="cpu"`` for the CPU) and
gates unvoiced frames at periodicity 0.065, as the reference's penn path
does. The weights are ``golf_tpu/assets/pitchnet.msgpack``, read as a data
file by the port's own msgpack reader (``utils/flax_msgpack.py``; stored in
bf16, run in float32).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..bridge import pitchnet_state_dict
from ..core.device import resolve_device
from ..models.pitchnet import PitchNet, decode, frame_signal
from . import flax_msgpack

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "golf_tpu", "assets", "pitchnet.msgpack")

_CACHE: Dict[Tuple[str, str], PitchNet] = {}


def load_model(path: Optional[str] = None, device=None) -> PitchNet:
    """The PitchNet with the weights at ``path`` (the shipped asset by
    default), in eval mode on ``device``; cached per path and device."""
    path = path or ASSET
    dev = resolve_device(device)
    key = (path, str(dev))
    if key not in _CACHE:
        if not os.path.exists(path):
            raise FileNotFoundError(f"pitchnet weights not found at {path}")
        model = PitchNet()
        model.load_state_dict(pitchnet_state_dict(flax_msgpack.load(path)),
                              strict=True)
        _CACHE[key] = model.to(dev).eval()
    return _CACHE[key]


def predict(x: np.ndarray, sr: int, hop_ms: float = 5.0,
            gate: float = 0.065, weights: Optional[str] = None,
            batch: int = 512, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Waveform -> (f0 (n_frames,), periodicity), f0 = 0 where unvoiced."""
    model = load_model(weights, device)
    dev = next(model.parameters()).device
    frames, n = frame_signal(np.asarray(x, np.float64), sr, hop_ms)
    pad_to = ((n + batch - 1) // batch) * batch
    frames = np.pad(frames, ((0, pad_to - n), (0, 0)))
    f0s, pers = [], []
    with torch.inference_mode():
        for i in range(0, pad_to, batch):
            logits = model(torch.from_numpy(frames[i:i + batch]).to(dev))
            f0, per = decode(logits, gate)
            f0s.append(f0.cpu().numpy())
            pers.append(per.cpu().numpy())
    return np.concatenate(f0s)[:n], np.concatenate(pers)[:n]
