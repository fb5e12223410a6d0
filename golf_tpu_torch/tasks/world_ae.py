"""The WORLD analysis-synthesis baseline (counterpart of
``golf_tpu.tasks.world_ae``), ``cfg/ae/pyworld.yaml``: not trainable.

Each utterance is analysed (CheapTrick, D4C) and resynthesised from its own
f0 track on the host in float64 numpy (``utils.world_lite``); the test
metrics, MSS and MCD, run on the task's device. ``test_step`` and
``predict_step`` take numpy batches, as ``golf_tpu``'s do.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.cepstrum import mcep
from ..ops.stft import spectrogram
from ..utils import world_lite


class WORLDAutoEncoder:
    def __init__(self, sample_rate: int = 24000, hop_length: int = 240,
                 criterion: Optional[Any] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """``device`` is where the metrics run: CUDA unless it says
        otherwise."""
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.criterion = criterion
        self.device = resolve_device(device)

    def forward(self, x: np.ndarray, f0: np.ndarray, fs: int,
                frame_period: float = 5.0):
        """One utterance (float64) and its frame-rate f0 -> (the
        resynthesis, {"sp", "ap", "f0"})."""
        t = np.arange(f0.shape[0]) * frame_period / 1000
        sp = world_lite.cheaptrick(x, f0, t, fs)
        ap = world_lite.d4c(x, f0, t, fs)
        y = world_lite.synthesize(f0, sp, ap, fs, frame_period)
        return y, {"sp": sp, "ap": ap, "f0": f0}

    __call__ = forward

    def resynthesize(self, x: np.ndarray, f0_in_hz: np.ndarray
                     ) -> np.ndarray:
        """A batch (B, T) and its sample-rate f0 -> the resyntheses (B, T')
        of each row, f0 taken every ``hop_length`` samples, cut to T."""
        f0 = f0_in_hz[:, ::self.hop_length]
        frame_period = 1000 * self.hop_length / self.sample_rate
        return np.stack([
            self(np.asarray(xi, np.float64), np.asarray(f0i, np.float64),
                 self.sample_rate, frame_period)[0][:x.shape[1]]
            for xi, f0i in zip(x, f0)])

    def metrics(self, x: np.ndarray, x_hat: np.ndarray) -> Dict:
        """MSS (the criterion) and MCD of x_hat against x, in float32 on the
        task's device: mel-cepstra of order 34 at alpha 0.46 from 512-point
        magnitude spectrograms at hop sr/200, no Newton iteration."""
        t = min(x.shape[1], x_hat.shape[1])
        xs = torch.as_tensor(np.asarray(x[:, :t], np.float32),
                             device=self.device)
        ys = torch.as_tensor(np.asarray(x_hat[:, :t], np.float32),
                             device=self.device)
        loss = float(self.criterion(ys, xs))
        hop = self.sample_rate // 200

        def mceps(sig):
            amp = spectrogram(sig, 512, hop, win_length=512,
                              window="hanning", power=1.0, center=True)
            return mcep(amp.transpose(1, 2), 34, alpha=0.46)

        mc_x, mc_y = mceps(xs), mceps(ys)
        f = min(mc_x.shape[1], mc_y.shape[1])
        mcd = float(10 * math.sqrt(2) / math.log(10) * torch.mean(
            torch.linalg.vector_norm(mc_x[:, :f] - mc_y[:, :f], dim=-1)))
        return {"loss": loss, "mcd": mcd, "N": x.shape[0]}

    def test_step(self, x: np.ndarray, f0_in_hz: np.ndarray) -> Dict:
        return self.metrics(x, self.resynthesize(x, f0_in_hz))

    def predict_step(self, x: np.ndarray, f0_in_hz: np.ndarray):
        """One utterance (batch of 1) -> ((1, T') float32, its WORLD
        parameters)."""
        if x.shape[0] != 1:
            raise ValueError(f"predict takes one utterance, got {x.shape[0]}")
        f0 = f0_in_hz[0, ::self.hop_length]
        frame_period = 1000 * self.hop_length / self.sample_rate
        y, params = self(np.asarray(x[0], np.float64),
                         np.asarray(f0, np.float64),
                         self.sample_rate, frame_period)
        return y[None].astype(np.float32), params

    def run_test(self, datamodule) -> Dict[str, float]:
        """``test_step`` over the test split: the N-weighted
        ``avg_mss_loss`` and ``avg_mcd``."""
        datamodule.setup("test")
        totals: Dict[str, float] = {}
        weights = 0.0
        with torch.inference_mode():
            for batch in datamodule.test_dataloader():
                x, f0 = batch[:2]
                out = self.test_step(np.asarray(x), np.asarray(f0))
                n = out.pop("N")
                for k, v in out.items():
                    totals[k] = totals.get(k, 0.0) + v * n
                weights += n
        return {("avg_" + ("mss_loss" if k == "loss" else k)): v / weights
                for k, v in totals.items()}


def build_world_autoencoder(model_cfg: Dict,
                            device: Optional[Union[str, torch.device]] = None
                            ) -> WORLDAutoEncoder:
    """Build the task from a ``model.init_args`` config subtree."""
    from ..config.registry import instantiate

    return WORLDAutoEncoder(
        sample_rate=model_cfg.get("sample_rate", 24000),
        hop_length=model_cfg.get("hop_length", 240),
        criterion=instantiate(model_cfg["criterion"]), device=device)
