"""The port's corpus loaders against golf_tpu's, on miniature wav and ``.pv``
trees written into ``tmp_path`` as ``tests/test_data_disk.py`` writes them.

For each of the five corpora (VCTK, M4Singer, MPop600, LJSpeech, MIR-1K):
every split's file list, length and boundaries, every item, and every
batch of the loaders (the shuffled, drop-last training loader over two
epochs, the validation and test loaders) equal golf_tpu's exactly
(``np.array_equal``: the same numpy arithmetic on the same files).
``InferenceDataset`` likewise, split by split, with its integer f0 hop
``sr // 200`` beside the segment datasets' float ``0.005 * sr`` (the trees
at 22.05 kHz make the two differ). The quirks are golf_tpu's and kept:
MPop600 checks no sample rate across files, ``DataModule``'s default
overlap is 0.5.
"""

import numpy as np
import pytest

from golf_tpu.tasks import data as jdata
from golf_tpu.utils.wav import write_wav
from golf_tpu_torch.tasks import data as tdata


def _write_utt(path, n, seed, sr, f0_track=None):
    """A wav of ``n`` samples and its ``.pv`` (5 ms hop): a 200-260 Hz track
    with an unvoiced hole and a frame under every corpus's floor."""
    rng = np.random.default_rng(seed)
    write_wav(str(path), (rng.standard_normal(n) * 0.1).astype(np.float32),
              sr)
    if f0_track is None:
        frames = int(n / (0.005 * sr)) + 1
        f0_track = rng.uniform(200.0, 260.0, frames)
        f0_track[3:6] = 0.0
        f0_track[8] = 70.0       # voiced for VCTK (floor 60), not MPop600
        f0_track[10] = 40.0
    np.savetxt(str(path.with_suffix(".pv")), f0_track)


def _vctk(root):
    sr = 8000
    for spk, lengths in (("p225", (9000,)), ("p360", (7000, 4500)),
                         ("s5", (5200,)), ("p300", (10000, 6000, 3000)),
                         ("p301", (8000,))):
        d = root / spk
        d.mkdir()
        for i, n in enumerate(lengths):
            _write_utt(d / f"{spk}_{i:03d}_mic1.wav", n, len(spk) + i, sr)
        # another microphone: not a VCTK item (file_suffix mic1.wav)
        write_wav(str(d / f"{spk}_000_mic2.wav"), np.zeros(3000, np.float32),
                  sr)


def _m4singer(root):
    for j, folder in enumerate(("Alto-1#song1", "Alto-2#song2",
                                "Bass-2#song3", "Tenor-4#song4")):
        d = root / folder
        d.mkdir()
        for i, n in enumerate((6000, 9100)):
            _write_utt(d / f"{i:04d}.wav", n, 10 * j + i, 8000)


def _mpop600(root):
    for i, (name, sr) in enumerate((("f1_001.wav", 8000),
                                    ("f1_004.wav", 8000),
                                    ("f1_100.wav", 8000),
                                    ("m2_101.wav", 8000),
                                    # another rate: golf_tpu does not check
                                    ("m2_102.wav", 16000),
                                    # no postfix: the whole name, train
                                    ("solo.wav", 8000))):
        _write_utt(root / name, 9000 + 700 * i, i, sr)


def _ljspeech(root):
    for i, name in enumerate(("LJ001-0001.wav", "LJ001-0050.wav",
                              "LJ002-0001.wav", "LJ002-0002.wav")):
        _write_utt(root / name, 12000 + 1500 * i, i, 22050)


def _mir1k(root):
    n = 5000
    rng = np.random.default_rng(0)
    for name, with_pv in (("abc_1_01.wav", True), ("abc_1_02.wav", False)):
        stereo = (rng.standard_normal((n, 2)) * 0.1).astype(np.float32)
        write_wav(str(root / name), stereo, 8000)
        if with_pv:
            np.savetxt(str(root / name.replace(".wav", ".pv")),
                       rng.uniform(150, 300, int(n / 40) + 1))


def _modules(name, root):
    """(golf_tpu's module, the port's module) for one corpus tree."""
    if name == "mir1k":
        return tuple(m.MIR1K(batch_size=2, data_dir=str(root), segment=2000,
                             overlap=500, seed=3) for m in (jdata, tdata))
    cls = {"vctk": "VCTK", "m4singer": "M4Singer", "mpop600": "MPop600",
           "ljspeech": "LJSpeech"}[name]
    return tuple(getattr(m, cls)(batch_size=2, wav_dir=str(root),
                                 duration=0.5, overlap=0.25, seed=3)
                 for m in (jdata, tdata))


TREES = {"vctk": _vctk, "m4singer": _m4singer, "mpop600": _mpop600,
         "ljspeech": _ljspeech, "mir1k": _mir1k}


def _same_dataset(ref, got):
    assert [str(f) for f in got.files] == [str(f) for f in ref.files]
    assert len(got) == len(ref) and len(ref) > 0
    assert got.sample_rate == ref.sample_rate
    np.testing.assert_array_equal(got.boundaries, ref.boundaries)
    for i in range(len(ref)):
        for a, b in zip(ref[i], got[i]):
            assert a.dtype == b.dtype and np.array_equal(a, b), i


def _same_batches(ref_loader, got_loader):
    assert len(got_loader) == len(ref_loader)
    n = 0
    for ref, got in zip(ref_loader, got_loader, strict=True):
        for a, b in zip(ref, got, strict=True):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            else:
                assert a == b
        n += 1
    assert n == len(ref_loader)


@pytest.mark.parametrize("name", sorted(TREES))
def test_datamodule_matches_golf_tpu(tmp_path, name):
    TREES[name](tmp_path)
    ref, got = _modules(name, tmp_path)
    stages = ["fit"] if name == "mir1k" else ["fit", "test"]
    for stage in stages:
        ref.setup(stage)
        got.setup(stage)
    _same_dataset(ref.train_dataset, got.train_dataset)
    assert got.sample_rate == ref.sample_rate
    # two epochs of the shuffled loader: the same permutations
    ref_train, got_train = ref.train_dataloader(), got.train_dataloader()
    for _ in range(2):
        _same_batches(ref_train, got_train)
    if name == "mir1k":
        return
    for split in ("valid", "test"):
        if getattr(ref, f"{split}_dataset").files:
            _same_dataset(getattr(ref, f"{split}_dataset"),
                          getattr(got, f"{split}_dataset"))
    _same_batches(ref.val_dataloader(), got.val_dataloader())
    _same_batches(ref.test_dataloader(), got.test_dataloader())


@pytest.mark.parametrize("name,split", [
    ("vctk", "train"), ("vctk", "valid"), ("vctk", "test"),
    ("m4singer", "train"), ("m4singer", "test"), ("ljspeech", "train")])
def test_inference_dataset_matches_golf_tpu(tmp_path, name, split):
    TREES[name](tmp_path)
    cls = {"vctk": "VCTKDataset", "m4singer": "M4SingerDataset",
           "ljspeech": "LJSpeechDataset"}[name]
    ref = jdata.InferenceDataset(str(tmp_path), split,
                                 dataset_cls=getattr(jdata, cls))
    got = tdata.InferenceDataset(str(tmp_path), split,
                                 dataset_cls=getattr(tdata, cls))
    assert [str(f) for f in got.files] == [str(f) for f in ref.files]
    assert len(ref) > 0
    for i in range(len(ref)):
        y_r, f0_r, rel_r = ref[i]
        y_g, f0_g, rel_g = got[i]
        assert np.array_equal(y_r, y_g) and np.array_equal(f0_r, f0_g)
        assert rel_r == rel_g


def test_predict_loader_matches_golf_tpu(tmp_path):
    _vctk(tmp_path)
    ref, got = _modules("vctk", tmp_path)
    ref.setup("predict")
    got.setup("predict")
    _same_batches(ref.predict_dataloader(), got.predict_dataloader())


def test_default_overlap_and_ljspeech_f0_hop(tmp_path):
    """``DataModule``'s default overlap is 0.5 (``cfg/ae/vctk.yaml`` passes
    1.5); at 22.05 kHz the segment datasets' f0 hop is 110.25 samples and
    ``InferenceDataset``'s 110, as in golf_tpu."""
    _ljspeech(tmp_path)
    ref = jdata.LJSpeech(batch_size=2, wav_dir=str(tmp_path), duration=0.6)
    got = tdata.LJSpeech(batch_size=2, wav_dir=str(tmp_path), duration=0.6)
    assert got.overlap == ref.overlap == 0.5
    ref.setup("fit")
    got.setup("fit")
    _same_dataset(ref.train_dataset, got.train_dataset)
    assert got.train_dataset.f0_hop_num_frames == 110.25
    item = tdata.InferenceDataset(str(tmp_path), "train",
                                  dataset_cls=tdata.LJSpeechDataset)[0]
    ref_item = jdata.InferenceDataset(str(tmp_path), "train",
                                      dataset_cls=jdata.LJSpeechDataset)[0]
    assert np.array_equal(item[1], ref_item[1])


def test_synthetic_module_matches_golf_tpu():
    ref = jdata.Synthetic(batch_size=2, n_items=4, duration=0.1, seed=2)
    got = tdata.Synthetic(batch_size=2, n_items=4, duration=0.1, seed=2)
    for stage in ("fit", "test", "predict"):
        ref.setup(stage)
        got.setup(stage)
    assert got.sample_rate == ref.sample_rate == 24000
    _same_batches(ref.train_dataloader(), got.train_dataloader())
    _same_batches(ref.val_dataloader(), got.val_dataloader())
    _same_batches(ref.test_dataloader(), got.test_dataloader())
    _same_batches(ref.predict_dataloader(), got.predict_dataloader())


def test_segment_dataset_refuses_a_second_sample_rate(tmp_path):
    """Where golf_tpu asserts one sample rate across a split's files, the
    port raises ValueError (MPop600 checks none, as above)."""
    _vctk(tmp_path)
    _write_utt(tmp_path / "p300" / "p300_009_mic1.wav", 9000, 1, 16000)
    with pytest.raises(AssertionError):
        jdata.VCTKDataset(str(tmp_path), "train", 0.5, 0.25)
    with pytest.raises(ValueError, match="16000 Hz"):
        tdata.VCTKDataset(str(tmp_path), "train", 0.5, 0.25)
