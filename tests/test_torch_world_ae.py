"""The WORLD analysis-synthesis baseline of the port (``cfg/ae/pyworld.yaml``)
against golf_tpu's, on the CPU:

* ``cheaptrick``, ``d4c`` and ``synthesize`` (host numpy, copied) equal to
  golf_tpu's, array for array, on a voiced and unvoiced synthetic voice;
* ``WORLDAutoEncoder.test_step``'s MSS loss and MCD within 1e-5 relative
  of golf_tpu's on the same batch (B = 2 x 0.5 s), and ``predict_step``'s
  output and parameters equal;
* ``autoencode_torch.py test`` and ``predict`` from a miniature VCTK tree
  with ``--device cpu`` (the test metrics within 1e-5 relative of
  golf_tpu's ``run_test`` on the same tree, one wav per test utterance);
  ``fit`` and ``validate`` raise (no parameters); without ``--device`` and
  without a card the CLI refuses.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from golf_tpu.loss.spec import MSSLoss as JMSSLoss
from golf_tpu.tasks import data as jdata
from golf_tpu.tasks.data import SyntheticVoiceDataset
from golf_tpu.tasks.world_ae import WORLDAutoEncoder as JWORLD
from golf_tpu.utils import world_lite as jwl
from golf_tpu.utils.wav import write_wav
from golf_tpu_torch.loss.spec import MSSLoss as TMSSLoss
from golf_tpu_torch.tasks.world_ae import WORLDAutoEncoder as TWORLD
from golf_tpu_torch.utils import world_lite as twl
from golf_tpu_torch.utils.wav import read_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 24000
HOP = 240                  # cfg/ae/pyworld.yaml
REL_TOL = 1e-5
N_FFTS = (509, 1021, 2053)  # cfg/ae/pyworld.yaml's criterion


def voices(n=2, seconds=0.5, seed=5):
    ds = SyntheticVoiceDataset(n, seconds, SR, seed=seed)
    return (np.stack([ds[i][0] for i in range(n)]).astype(np.float32),
            np.stack([ds[i][1] for i in range(n)]).astype(np.float32))


def analysis_inputs():
    """One voice of 0.5 s (float64) with its f0 every 10 ms, unvoiced gaps
    included, and the frame times."""
    x, f0 = voices(1)
    f0 = f0[0, ::HOP].astype(np.float64)
    assert (f0 == 0).any() and (f0 > 0).any()
    return x[0].astype(np.float64), f0, np.arange(len(f0)) * HOP / SR


@pytest.mark.parametrize("name", ["cheaptrick", "d4c", "synthesize"])
def test_world_lite_equals_golf_tpus(name):
    x, f0, t = analysis_inputs()
    if name == "synthesize":
        sp = jwl.cheaptrick(x, f0, t, SR)
        ap = jwl.d4c(x, f0, t, SR)
        ref = jwl.synthesize(f0, sp, ap, SR, 1000 * HOP / SR)
        got = twl.synthesize(f0, sp, ap, SR, 1000 * HOP / SR)
    else:
        ref = getattr(jwl, name)(x, f0, t, SR)
        got = getattr(twl, name)(x, f0, t, SR)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)


def tasks():
    return (JWORLD(SR, HOP, JMSSLoss(n_ffts=N_FFTS, alpha=1.0,
                                     window="hanning", center=True)),
            TWORLD(SR, HOP, TMSSLoss(n_ffts=N_FFTS, alpha=1.0,
                                     window="hanning", center=True),
                   device="cpu"))


def test_test_step_matches_golf_tpu():
    x, f0 = voices()
    ref = tasks()[0].test_step(x, f0)
    got = tasks()[1].test_step(x, f0)
    assert got["N"] == ref["N"] == 2
    for k in ("loss", "mcd"):
        assert abs(got[k] - ref[k]) <= REL_TOL * abs(ref[k]), (k, got, ref)


def test_predict_step_equals_golf_tpus():
    x, f0 = voices(1)
    (y_j, p_j), (y_t, p_t) = (task.predict_step(x, f0) for task in tasks())
    assert y_t.dtype == np.float32 and y_t.shape == y_j.shape
    np.testing.assert_array_equal(y_t, y_j)
    for k in ("sp", "ap", "f0"):
        np.testing.assert_array_equal(p_t[k], p_j[k])


def vctk_tree(root):
    """A 24 kHz VCTK tree: train speaker p300, valid p225, test p360 (two
    utterances of 0.6 s: two 0.5 s segments each at overlap 0.4)."""
    hop = SR // 200
    files = (("p300", 1), ("p225", 1), ("p360", 1), ("p360", 2))
    ds = SyntheticVoiceDataset(len(files), 0.6, SR, seed=9)
    for i, (spk, k) in enumerate(files):
        x, f0 = ds[i]
        d = root / spk
        d.mkdir(exist_ok=True)
        path = d / f"{spk}_{k:03d}_mic1.wav"
        write_wav(str(path), x, SR)
        np.savetxt(str(path.with_suffix(".pv")),
                   f0[np.minimum(np.arange(len(x) // hop + 1) * hop,
                                 len(x) - 1)])


def cli_args(tree, run_dir, device=True):
    return ["--config", "cfg/ae/pyworld.yaml",
            *(["--device", "cpu"] if device else []),
            f"data.init_args.wav_dir={tree}", "data.init_args.batch_size=2",
            "data.init_args.duration=0.5", "data.init_args.overlap=0.4",
            "--run_dir", str(run_dir)]


def cli(argv):
    from golf_tpu_torch.tasks.cli import run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run(argv) == 0
    return out.getvalue().strip().splitlines()


@pytest.fixture
def tree(tmp_path):
    root = tmp_path / "vctk"
    root.mkdir()
    vctk_tree(root)
    return root


def test_autoencode_torch_test_and_predict(tree, tmp_path):
    """``test`` (``autoencode_torch.py`` in its own process) prints
    ``avg_mss_loss`` and ``avg_mcd`` within 1e-5 relative of golf_tpu's
    ``run_test`` on the same tree; ``predict`` writes each test utterance,
    equal to golf_tpu's ``predict_step`` (a float wav, clipped to
    [-1, 1])."""
    done = subprocess.run(
        [sys.executable, "autoencode_torch.py", "test",
         *cli_args(tree, tmp_path / "t")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    dm = jdata.VCTK(batch_size=2, wav_dir=str(tree), duration=0.5,
                    overlap=0.4)
    ref = tasks()[0].run_test(dm)
    assert set(got) == set(ref) == {"avg_mss_loss", "avg_mcd"}
    for k, v in ref.items():
        assert abs(got[k] - v) <= REL_TOL * abs(v), (k, got, ref)

    cli(["predict", *cli_args(tree, tmp_path / "p")])
    out = tmp_path / "p" / "predictions" / "p360"
    assert sorted(os.listdir(out)) == ["p360_001_mic1.wav",
                                       "p360_002_mic1.wav"]
    dm.setup("predict")
    x, f0, _ = dm.predict_dataset[0]
    y_ref, _ = tasks()[0].predict_step(x[None], f0[None])
    y, sr = read_wav(str(out / "p360_001_mic1.wav"))
    assert sr == SR and y.shape == y_ref[0].shape
    np.testing.assert_array_equal(y, np.clip(y_ref[0], -1, 1))


@pytest.mark.parametrize("subcommand", ["fit", "validate"])
def test_training_subcommands_raise(tree, tmp_path, subcommand):
    with pytest.raises(ValueError, match="not trainable"):
        cli([subcommand, *cli_args(tree, tmp_path / "r")])


def test_autoencode_torch_needs_a_card_unless_asked_for_the_cpu(
        tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli(["test", *cli_args(tree, tmp_path / "r", device=False)])
