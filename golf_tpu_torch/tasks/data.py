"""Datasets and data modules (counterpart of ``golf_tpu.tasks.data``).

Host-side numpy pipeline: every wav and its ``.pv`` f0 track (5 ms hop) is
loaded into memory and cut into (duration, overlap) segments by cumulative
boundaries and ``np.digitize``; f0 is interpolated to the sample rate with
the unvoiced frames (below ``f0_floor``) masked to 0; splits follow
speaker-folder prefixes (VCTK, M4Singer), file postfixes (MPop600) or file
names (LJSpeech). ``Synthetic`` needs no corpus. Batches are numpy arrays;
the trainer moves them to the device.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.wav import read_wav


def folder_prefix_split(wav_dir: pathlib.Path, cls) -> Dict[str, list]:
    """The files under ``wav_dir`` ending in ``cls.file_suffix``, sorted, by
    split: the folder name's prefix before ``#`` in
    ``cls.test_folder_prefixes`` or ``cls.valid_folder_prefixes``, else
    train."""
    buckets = {"train": [], "valid": [], "test": []}
    for f in sorted(wav_dir.glob("**/*" + cls.file_suffix)):
        prefix = f.parent.name.split("#")[0]
        if prefix in cls.test_folder_prefixes:
            buckets["test"].append(f)
        elif prefix in cls.valid_folder_prefixes:
            buckets["valid"].append(f)
        else:
            buckets["train"].append(f)
    return buckets


def flat_split(wav_dir: pathlib.Path, key, test: set, valid: set
               ) -> Dict[str, list]:
    """The ``*.wav`` files directly in ``wav_dir``, sorted, by split:
    ``key(file)`` in ``test`` or ``valid``, else train."""
    buckets = {"train": [], "valid": [], "test": []}
    for f in sorted(wav_dir.glob("*.wav")):
        k = key(f)
        buckets["test" if k in test else "valid" if k in valid
                else "train"].append(f)
    return buckets


class SegmentDataset:
    """In-memory segments of every file of a split (``split_files``: by
    the folder name's prefix before ``#`` here)."""

    test_folder_prefixes: set = set()
    valid_folder_prefixes: set = set()
    file_suffix: str = ".wav"
    f0_floor: float = 60.0
    check_sample_rate: bool = True

    def split_files(self, wav_dir: pathlib.Path) -> Dict[str, list]:
        return folder_prefix_split(wav_dir, type(self))

    def __init__(self, wav_dir: str, split: str = "train",
                 duration: float = 2.0, overlap: float = 1.0,
                 f0_suffix: str = ".pv"):
        buckets = self.split_files(pathlib.Path(wav_dir))
        if split not in buckets:
            raise ValueError(f"Unknown split: {split}")
        self.files = buckets[split]

        self.sample_rate: Optional[int] = None
        self.samples: List[np.ndarray] = []
        self.f0s: List[np.ndarray] = []
        file_lengths = []
        for filename in self.files:
            x, sr = read_wav(str(filename))
            if x.ndim > 1:
                x = x.mean(axis=-1)
            if self.sample_rate is None:
                self.sample_rate = sr
                self.segment_num_frames = int(duration * sr)
                self.hop_num_frames = int((duration - overlap) * sr)
                self.f0_hop_num_frames = 0.005 * sr
            elif self.check_sample_rate and sr != self.sample_rate:
                raise ValueError(f"{filename}: {sr} Hz, not "
                                 f"{self.sample_rate} as the first file")
            f0 = np.loadtxt(str(filename.with_suffix(f0_suffix)))
            self.f0s.append(np.atleast_1d(f0))
            self.samples.append(x)
            file_lengths.append(
                max(0, x.shape[0] - self.segment_num_frames)
                // self.hop_num_frames + 1)

        self.file_lengths = np.asarray(file_lengths)
        self.boundaries = np.cumsum(np.asarray([0] + file_lengths))

    def __len__(self) -> int:
        return int(self.boundaries[-1])

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        bin_pos = int(np.digitize(index, self.boundaries[1:], right=False))
        x = self.samples[bin_pos]
        f0 = self.f0s[bin_pos]
        f0 = np.where(f0 < self.f0_floor, 0, f0)
        offset = int(index - self.boundaries[bin_pos]) * self.hop_num_frames

        seg = x[offset: offset + self.segment_num_frames]
        tp = np.arange(len(f0)) * self.f0_hop_num_frames
        t = np.arange(offset, offset + self.segment_num_frames)
        mask = np.interp(t, tp, (f0 == 0).astype(float), right=1) > 0
        interp_f0 = np.where(mask, 0, np.interp(t, tp, f0))

        if seg.shape[0] < self.segment_num_frames:
            seg = np.pad(seg, (0, self.segment_num_frames - seg.shape[0]))
        return seg.astype(np.float32), interp_f0.astype(np.float32)


class M4SingerDataset(SegmentDataset):
    test_folder_prefixes = {"Alto-1", "Soprano-1", "Tenor-1", "Bass-1"}
    valid_folder_prefixes = {"Alto-2", "Alto-3", "Tenor-2", "Tenor-3"}


class VCTKDataset(SegmentDataset):
    test_folder_prefixes = {"p360", "p361", "p362", "p363", "p364", "p374",
                            "p376", "s5"}
    valid_folder_prefixes = {"p225", "p226", "p227", "p228", "p229", "p230",
                             "p231", "p232", "p233", "p234", "p236", "p237",
                             "p238", "p239", "p240", "p241"}
    file_suffix = "mic1.wav"


class MPop600Dataset(SegmentDataset):
    """MPop600: a flat tree of ``<singer>_<postfix>`` files, split by the
    postfix; no sample-rate check across files, as in ``golf_tpu``."""

    test_file_postfix = {"001.wav", "002.wav", "003.wav"}
    valid_file_postfix = {"004.wav", "005.wav", "006.wav"}
    f0_floor = 80.0
    check_sample_rate = False

    def __init__(self, wav_dir: str, split: str = "train",
                 duration: float = 2.0, overlap: float = 0.5,
                 f0_suffix: str = ".pv"):
        super().__init__(wav_dir, split, duration, overlap, f0_suffix)

    def split_files(self, wav_dir: pathlib.Path) -> Dict[str, list]:
        return flat_split(wav_dir, lambda f: f.name.split("_")[-1],
                          self.test_file_postfix, self.valid_file_postfix)


class LJSpeechDataset(SegmentDataset):
    """LJSpeech: a flat tree, split by file name."""

    test_file_names = {f"LJ001-{i:04d}.wav" for i in range(1, 21)}
    valid_file_names = {f"LJ001-{i:04d}.wav" for i in range(21, 101)}
    f0_floor = 80.0

    def split_files(self, wav_dir: pathlib.Path) -> Dict[str, list]:
        return flat_split(wav_dir, lambda f: f.name, self.test_file_names,
                          self.valid_file_names)


class MIR1KDataset(SegmentDataset):
    """MIR-1K: the vocal channel of stereo files, all in one split; a
    file without a ``.pv`` gets a zero f0."""

    def __init__(self, data_dir: str, segment: int, overlap: int = 0,
                 upsample_f0: bool = False, in_hertz: bool = True,
                 f0_suffix: str = ".pv"):
        wav_dir = pathlib.Path(data_dir)
        self.files = sorted(wav_dir.glob("**/*.wav"))
        self.sample_rate = None
        self.samples, self.f0s = [], []
        file_lengths = []
        for filename in self.files:
            x, sr = read_wav(str(filename))
            if x.ndim > 1:
                x = x[..., -1]  # vocal channel
            if self.sample_rate is None:
                self.sample_rate = sr
                self.segment_num_frames = int(segment)
                self.hop_num_frames = max(1, int(segment - overlap))
                self.f0_hop_num_frames = 0.005 * sr
            pv = filename.with_suffix(f0_suffix)
            if pv.exists():
                f0 = np.atleast_1d(np.loadtxt(str(pv)))
            else:
                f0 = np.zeros(int(len(x) / self.f0_hop_num_frames) + 1)
            self.f0s.append(f0)
            self.samples.append(x)
            file_lengths.append(
                max(0, x.shape[0] - self.segment_num_frames)
                // self.hop_num_frames + 1)
        self.file_lengths = np.asarray(file_lengths)
        self.boundaries = np.cumsum(np.asarray([0] + file_lengths))


class InferenceDataset:
    """Whole utterances of a split as (wav, f0, path relative to
    ``wav_dir``), for ``predict``."""

    def __init__(self, wav_dir: str, split: str = "test",
                 f0_suffix: str = ".pv",
                 dataset_cls=VCTKDataset):
        self.wav_dir = pathlib.Path(wav_dir)
        buckets = folder_prefix_split(self.wav_dir, dataset_cls)
        self.files = buckets[split]
        self.f0_suffix = f0_suffix

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int):
        filename = self.files[index]
        y, sr = read_wav(str(filename))
        if y.ndim > 1:
            y = y.mean(axis=-1)
        f0 = np.atleast_1d(np.loadtxt(str(filename.with_suffix(
            self.f0_suffix))))
        f0 = np.where(f0 < 60, 0, f0)
        tp = np.arange(len(f0)) * sr // 200
        t = np.arange(y.shape[0])
        mask = np.interp(t, tp, (f0 == 0).astype(float), right=1) > 0
        interp_f0 = np.where(mask, 0, np.interp(t, tp, f0))
        rel = filename.relative_to(self.wav_dir)
        return (y.astype(np.float32), interp_f0.astype(np.float32), str(rel))


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

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        nb = len(self)
        for b in range(nb):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in sel]
            yield tuple(np.stack(col) if isinstance(col[0], np.ndarray)
                        else list(col) for col in zip(*items))


class DataModule:
    """The split datasets and their loaders."""

    dataset_cls = SegmentDataset
    inference_cls = InferenceDataset

    def __init__(self, batch_size: int, wav_dir: str, duration: float = 2.0,
                 overlap: float = 0.5, f0_suffix: str = ".pv", seed: int = 0):
        self.batch_size = batch_size
        self.wav_dir = wav_dir
        self.duration = duration
        self.overlap = overlap
        self.f0_suffix = f0_suffix
        self.seed = seed
        self.train_dataset = self.valid_dataset = None
        self.test_dataset = self.predict_dataset = None

    def _make(self, split):
        return self.dataset_cls(self.wav_dir, split, self.duration,
                                self.overlap, self.f0_suffix)

    def setup(self, stage: Optional[str] = None):
        if stage == "fit":
            self.train_dataset = self._make("train")
        if stage in ("fit", "validate"):
            self.valid_dataset = self._make("valid")
        if stage == "test":
            self.test_dataset = self._make("test")
        if stage == "predict":
            self.predict_dataset = self.inference_cls(
                self.wav_dir, "test", self.f0_suffix, self.dataset_cls)

    def train_dataloader(self):
        return DataLoader(self.train_dataset, self.batch_size, shuffle=True,
                          drop_last=True, seed=self.seed)

    def val_dataloader(self):
        return DataLoader(self.valid_dataset, self.batch_size)

    def test_dataloader(self):
        return DataLoader(self.test_dataset, self.batch_size)

    def predict_dataloader(self):
        return DataLoader(self.predict_dataset, 1)

    @property
    def sample_rate(self):
        for ds in (self.train_dataset, self.valid_dataset,
                   self.test_dataset):
            if ds is not None and getattr(ds, "sample_rate", None):
                return ds.sample_rate
        return None


class VCTK(DataModule):
    dataset_cls = VCTKDataset


class M4Singer(DataModule):
    dataset_cls = M4SingerDataset


class LJSpeech(DataModule):
    dataset_cls = LJSpeechDataset


class MPop600(DataModule):
    dataset_cls = MPop600Dataset


class MIR1K(DataModule):
    def __init__(self, batch_size: int, data_dir: str, segment: int,
                 overlap: int = 0, upsample_f0: bool = False,
                 in_hertz: bool = True, seed: int = 0):
        super().__init__(batch_size, data_dir, seed=seed)
        self.segment = segment
        self.seg_overlap = overlap
        self.upsample_f0 = upsample_f0
        self.in_hertz = in_hertz

    def setup(self, stage=None):
        if stage == "fit":
            self.train_dataset = MIR1KDataset(
                self.wav_dir, self.segment, self.seg_overlap,
                self.upsample_f0, self.in_hertz)


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


class Synthetic(DataModule):
    """``SyntheticVoiceDataset`` splits: ``n_items`` to train, an eighth
    (at least 4) each to validate and test, the test split to predict."""

    def __init__(self, batch_size: int = 8, n_items: int = 64,
                 duration: float = 2.0, sample_rate: int = 24000,
                 seed: int = 0, wav_dir: str = "", overlap: float = 0.0):
        super().__init__(batch_size, wav_dir, duration, overlap, seed=seed)
        self.n_items = n_items
        self._sr = sample_rate

    def _make(self, split):
        offs = {"train": 0, "valid": 1, "test": 2}[split]
        n = self.n_items if split == "train" else max(4, self.n_items // 8)
        return SyntheticVoiceDataset(n, self.duration, self._sr,
                                     seed=self.seed + offs * 7919)

    def setup(self, stage=None):
        if stage == "predict":
            self.predict_dataset = _WithRelPath(self._make("test"))
        else:
            super().setup(stage)


class _WithRelPath:
    """(x, f0) dataset -> the inference interface (x, f0, rel_path)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        x, f0 = self.ds[i]
        return x, f0, f"item{i:04d}.wav"
