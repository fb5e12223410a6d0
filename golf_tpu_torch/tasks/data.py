"""Synthetic voice data (counterpart of ``golf_tpu.tasks.data``'s
``SyntheticVoiceDataset`` and ``Synthetic`` module): train, valid and
predict splits. Corpus loaders (VCTK and the rest) are not ported yet.
Batches are numpy arrays."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class SyntheticVoiceDataset:
    """Voice-like items with no corpus: a harmonic source on a smooth
    random f0 contour with unvoiced gaps, plus a little noise."""

    def __init__(self, n_items: int = 64, duration: float = 2.0,
                 sample_rate: int = 24000, seed: int = 0):
        self.n = n_items
        self.sample_rate = sample_rate
        self.t = int(duration * sample_rate)
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed * 100003 + index)
        knots = rng.uniform(100, 350, 8)
        f0 = np.interp(np.linspace(0, 7, self.t), np.arange(8), knots)
        voiced = np.interp(np.linspace(0, 7, self.t), np.arange(8),
                           rng.uniform(0, 1, 8)) > 0.3
        f0 = np.where(voiced, f0, 0.0)
        phase = np.cumsum(np.where(f0 > 0, f0, 0) / self.sample_rate)
        x = np.zeros(self.t)
        for k in range(1, 9):
            x += np.sin(2 * np.pi * k * phase) / k
        x *= voiced.astype(float)
        x += rng.standard_normal(self.t) * 0.03
        x *= 0.3 / max(np.abs(x).max(), 1e-6)
        return x.astype(np.float32), f0.astype(np.float32)


class DataLoader:
    """Host-side batch iterator (shuffle + drop_last)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in sel]
            yield tuple(np.stack(col) if isinstance(col[0], np.ndarray)
                        else list(col) for col in zip(*items))


class _WithRelPath:
    """(x, f0) dataset -> the inference interface (x, f0, rel_path)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        x, f0 = self.ds[i]
        return x, f0, f"item{i:04d}.wav"


class Synthetic:
    def __init__(self, batch_size: int = 8, n_items: int = 64,
                 duration: float = 2.0, sample_rate: int = 24000,
                 seed: int = 0, wav_dir: str = "", overlap: float = 0.0):
        self.batch_size = batch_size
        self.n_items = n_items
        self.duration = duration
        self.sample_rate = sample_rate
        self.seed = seed
        self.train_dataset = self.valid_dataset = None
        self.predict_dataset = None

    def _make(self, split: str) -> SyntheticVoiceDataset:
        offs = {"train": 0, "valid": 1, "test": 2}[split]
        n = self.n_items if split == "train" else max(4, self.n_items // 8)
        return SyntheticVoiceDataset(n, self.duration, self.sample_rate,
                                     seed=self.seed + offs * 7919)

    def setup(self, stage=None):
        if stage == "fit":
            self.train_dataset = self._make("train")
        if stage in ("fit", "validate"):
            self.valid_dataset = self._make("valid")
        if stage == "predict":
            self.predict_dataset = _WithRelPath(self._make("test"))

    def train_dataloader(self):
        return DataLoader(self.train_dataset, self.batch_size, shuffle=True,
                          drop_last=True, seed=self.seed)

    def val_dataloader(self):
        return DataLoader(self.valid_dataset, self.batch_size)

    def predict_dataloader(self):
        return DataLoader(self.predict_dataset, 1)
