"""VGGish (AudioSet) embedder (counterpart of ``golf_tpu.models.vggish``),
one of the FAD embeddings of ``fad_torch.py``.

(N, 96, 64) log-mel patches -> the VGG stack (six 3 x 3 convs with ReLU,
max-pooled after the 1st, 2nd, 4th and 6th) -> flattened in
``golf_tpu``'s (width, height, channel) order -> three ReLU linear layers
-> (N, 128). The modules are named as torchvggish's ``features`` and
``embeddings`` Sequentials, so a ``vggish-*.pth`` state dict loads as it
is. Pretrained weights are not in the repository; ``random_state_dict``
gives architecture-only weights. ``log_mel_patches`` is host numpy, copied
from ``golf_tpu``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device

SAMPLE_RATE = 16000
_CHANNELS = (64, 128, 256, 256, 512, 512)
_POOL_AFTER = (0, 1, 3, 5)
_FC_WIDTHS = (4096, 4096, 128)


class VGGish(nn.Module):
    """(N, 1, 96, 64) log-mel patches -> (N, 128) embeddings."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 1
        for i, ch in enumerate(_CHANNELS):
            layers += [nn.Conv2d(in_ch, ch, 3, padding=1), nn.ReLU()]
            if i in _POOL_AFTER:
                layers.append(nn.MaxPool2d(2, 2))
            in_ch = ch
        self.features = nn.Sequential(*layers)
        fcs, width = [], 512 * 6 * 4
        for w in _FC_WIDTHS:
            fcs += [nn.Linear(width, w), nn.ReLU()]
            width = w
        self.embeddings = nn.Sequential(*fcs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.features(x)                          # (N, 512, 6, 4)
        h = h.permute(0, 3, 2, 1).reshape(h.shape[0], -1)
        return self.embeddings(h)


def random_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded architecture-only weights (PyTorch's default init)."""
    torch.manual_seed(seed)
    return VGGish().state_dict()


def log_mel_patches(wav: np.ndarray, sr: int) -> np.ndarray:
    """VGGish's front end: resample to 16 kHz, then 0.96 s patches of
    96 x 64 log-mel frames (25 ms Hann window, 10 ms hop, 64 mel bands
    125-7500 Hz, log(mel + 0.01)): (N, 96, 64) float32."""
    from ..ops.stft import melscale_fbanks

    wav = np.asarray(wav, np.float64).reshape(-1)
    if sr != SAMPLE_RATE:
        from math import gcd

        from scipy.signal import resample_poly
        g = gcd(sr, SAMPLE_RATE)
        wav = resample_poly(wav, SAMPLE_RATE // g, sr // g)
    n_fft, win, hop = 512, 400, 160
    n = (len(wav) - win) // hop + 1
    if n < 96:
        wav = np.pad(wav, (0, (96 - n) * hop + win))
        n = 96
    idx = np.arange(n)[:, None] * hop + np.arange(win)[None, :]
    frames = wav[idx] * np.hanning(win)
    spec = np.abs(np.fft.rfft(frames, n_fft)) ** 2
    fb = melscale_fbanks(n_fft // 2 + 1, 125.0, 7500.0, 64, SAMPLE_RATE)
    mel = np.log(spec @ fb + 0.01)
    patches = [mel[s:s + 96] for s in range(0, n - 95, 96)]
    return np.stack(patches).astype(np.float32)


class VGGishEmbedder:
    """``embed(wav, sr) -> (n_patches, 128)`` for ``fad_torch.py``; the
    network runs on ``device`` (CUDA unless ``"cpu"``)."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], device=None):
        self.device = resolve_device(device)
        self.model = VGGish()
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    def embed(self, wav: np.ndarray, sr: int) -> np.ndarray:
        patches = torch.from_numpy(log_mel_patches(wav, sr))[:, None]
        with torch.inference_mode():
            return self.model(patches.to(self.device)).cpu().numpy()
