"""WAV I/O on the host with scipy.io.wavfile (PCM16/24/32 and float32)."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy.io import wavfile


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (float32 mono-or-multich audio in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, sr


def write_wav(path: str, data: np.ndarray, sr: int) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = np.clip(np.asarray(data, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, data)
