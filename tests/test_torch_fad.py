"""The port's FAD tools against golf_tpu's, on the CPU:
``frechet_distance`` and ``stats`` on their closed forms (1e-9 relative);
``LogMelEmbedding`` (within 1e-4 of max-abs: two FFT libraries under a
log) and the per-speaker scores of ``fad_torch.py`` (1e-3 relative) and
its CLI; VGGish on seeded torchvggish-layout weights, two patches, and
the DAC encoder at full width on 3200 samples, on a seeded
descript-audio-codec state dict (weight norm folded by each package's
loader), each within 1e-4 of max|y| of golf_tpu's flax module; the
loudness and windows (host numpy, bit for bit); and both state-dict
loaders: VGGish takes torchvggish's keys as they are, DAC folds the
``weight_g``/``weight_v`` and the parametrize layouts alike, each to
golf_tpu's kernels bit for bit."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fad as j_fad
import fad_torch
from golf_tpu.models import dac as j_dac
from golf_tpu.models import vggish as j_vggish
from golf_tpu.utils.wav import write_wav
from golf_tpu_torch.models import dac as t_dac
from golf_tpu_torch.models import vggish as t_vggish

torch.set_num_threads(1)

SR = 24000


def test_frechet_distance_closed_forms():
    rng = np.random.default_rng(0)
    d = 6
    mu = rng.standard_normal(d)
    a = rng.standard_normal((d, d))
    s = a @ a.T + np.eye(d)
    assert fad_torch.frechet_distance(mu, s, mu, s) == pytest.approx(
        0.0, abs=1e-8)
    mu1, mu2 = rng.standard_normal(d), rng.standard_normal(d)
    d1, d2 = rng.uniform(0.5, 2.0, d), rng.uniform(0.5, 2.0, d)
    want = (np.sum((mu1 - mu2) ** 2)
            + np.sum(d1 + d2 - 2 * np.sqrt(d1 * d2)))
    assert fad_torch.frechet_distance(mu1, np.diag(d1), mu2, np.diag(
        d2)) == pytest.approx(want, rel=1e-9)
    b = rng.standard_normal((d, d))
    s2 = b @ b.T + np.eye(d)
    assert fad_torch.frechet_distance(mu1, s, mu2, s2) == pytest.approx(
        j_fad.frechet_distance(mu1, s, mu2, s2), rel=1e-9)
    e = rng.standard_normal((50, d))
    mu_s, s_s = fad_torch.stats(e)
    np.testing.assert_allclose(mu_s, e.mean(0))
    np.testing.assert_allclose(s_s, np.cov(e, rowvar=False))


def _voice(seconds, f0, seed):
    t = np.arange(int(SR * seconds)) / SR
    x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 10))
    x += 0.05 * np.random.default_rng(seed).standard_normal(t.size)
    return (0.2 * x).astype(np.float32)


def test_logmel_embedding_matches_golf_tpu():
    wav = _voice(8.0, 150.0, 0)
    ref = j_fad.LogMelEmbedding().embed(wav, SR)
    got = fad_torch.LogMelEmbedding(device="cpu").embed(wav, SR)
    assert got.shape == ref.shape == (2, 128)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.fixture(scope="module")
def fad_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("fad")
    for role, shift in (("ref", 0.0), ("eval", 20.0)):
        for s, spk in enumerate(("spk0", "spk1")):
            for i in range(2):
                write_wav(str(root / role / spk / f"u{i}.wav"),
                          _voice(5.5, 120.0 + 60 * s + 15 * i + shift,
                                 10 * s + i), SR)
    return root


def test_fad_logmel_scores_and_cli(fad_trees, tmp_path, capsys):
    ref_dir, eval_dir = fad_trees / "ref", fad_trees / "eval"
    emb = j_fad.LogMelEmbedding()
    want = {}
    for spk in ("spk0", "spk1"):
        r = np.concatenate([emb.embed(*_read(p)) for p in
                            sorted((ref_dir / spk).glob("*.wav"))])
        e = np.concatenate([emb.embed(*_read(p)) for p in
                            sorted((eval_dir / spk).glob("*.wav"))])
        want[spk] = j_fad.frechet_distance(*j_fad.stats(r),
                                           *j_fad.stats(e))
    got = fad_torch.speaker_scores(
        fad_torch.LogMelEmbedding(device="cpu"), ref_dir, eval_dir)
    assert sorted(got) == sorted(want)
    for spk in want:
        assert got[spk] > 0
        assert got[spk] == pytest.approx(want[spk], rel=1e-3)
    csv = tmp_path / "fad.csv"
    assert fad_torch.main([str(ref_dir), str(eval_dir), "--csv", str(csv),
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "log-mel statistics" in out and "mean" in out
    assert csv.read_text().startswith("speaker,fad\nspk0,")


def _read(path):
    from golf_tpu_torch.utils.wav import read_wav
    return read_wav(str(path))


def test_vggish_matches_golf_tpu_and_loads_torchvggish_keys():
    sd = t_vggish.random_state_dict(3)
    port = t_vggish.VGGish()
    port.load_state_dict(sd, strict=True)
    assert sorted(sd) == sorted(
        [f"features.{i}.{p}" for i in (0, 3, 6, 8, 11, 13)
         for p in ("weight", "bias")]
        + [f"embeddings.{i}.{p}" for i in (0, 2, 4)
           for p in ("weight", "bias")])
    variables = j_vggish.params_from_torch_state_dict(sd)
    assert np.array_equal(
        np.asarray(variables["params"]["conv_2"]["kernel"]),
        sd["features.6.weight"].numpy().transpose(2, 3, 1, 0))
    patches = t_vggish.log_mel_patches(_voice(2.0, 200.0, 1), SR)
    assert patches.shape == (2, 96, 64)
    assert np.array_equal(patches, j_vggish.log_mel_patches(
        _voice(2.0, 200.0, 1), SR))
    ref = np.asarray(j_vggish.VGGish().apply(variables,
                                             jnp.asarray(patches[..., None])))
    with torch.no_grad():
        got = port(torch.from_numpy(patches)[:, None]).numpy()
    assert got.shape == ref.shape == (2, 128)
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    emb = t_vggish.VGGishEmbedder(sd, device="cpu")
    assert np.abs(emb.embed(_voice(2.0, 200.0, 1), SR) - ref).max() <= \
        1e-4 * np.abs(ref).max()


def _descript_state_dict(seed, parametrize=False):
    """A seeded descript-audio-codec state dict (the whole model's
    ``encoder.`` keys, weight norm as g and v)."""
    r = np.random.default_rng(seed)
    sd = {}
    for key, t in t_dac.DACEncoder().state_dict().items():
        shape = tuple(t.shape)
        name = "encoder." + key
        if key.endswith("alpha"):
            sd[name] = torch.from_numpy(
                r.uniform(0.25, 1.75, shape).astype(np.float32))
        elif key.endswith("bias"):
            sd[name] = torch.from_numpy(
                (0.05 * r.standard_normal(shape)).astype(np.float32))
        else:
            g_key, v_key = (".parametrizations.weight.original0",
                            ".parametrizations.weight.original1") \
                if parametrize else (".weight_g", ".weight_v")
            prefix = name[:-len(".weight")]
            sd[prefix + g_key] = torch.from_numpy(
                r.uniform(0.5, 1.5, (shape[0], 1, 1)).astype(np.float32))
            sd[prefix + v_key] = torch.from_numpy(
                r.standard_normal(shape).astype(np.float32))
    sd["decoder.model.0.weight"] = torch.zeros(3)   # ignored: not encoder
    return sd


def test_dac_loaders_fold_weight_norm_like_golf_tpu():
    sd = _descript_state_dict(5)
    classic = t_dac.state_dict_from_dac(sd)
    param = t_dac.state_dict_from_dac(_descript_state_dict(5, True))
    assert sorted(classic) == sorted(t_dac.DACEncoder().state_dict())
    for k in classic:
        assert torch.equal(classic[k], param[k]), k
    ref = j_dac.params_from_torch_state_dict(sd)["params"]
    # block.1.block.2 is block_0's third residual unit
    assert np.array_equal(
        np.asarray(ref["block_0"]["res_2"]["conv_0"]["conv"]["kernel"]),
        classic["block.1.block.2.block.1.weight"].numpy().transpose(2, 1, 0))
    assert np.array_equal(np.asarray(ref["conv_out"]["conv"]["bias"]),
                          classic["block.6.bias"].numpy())
    assert np.array_equal(np.asarray(ref["snake_out"]["alpha"]),
                          classic["block.5.alpha"].numpy().reshape(-1))


def test_dac_matches_golf_tpu_full_width():
    sd = _descript_state_dict(6)
    variables = j_dac.params_from_torch_state_dict(sd)
    port = t_dac.DACEncoder()
    port.load_state_dict(t_dac.state_dict_from_dac(sd), strict=True)
    x = (np.random.default_rng(2).standard_normal((1, 3200)) * 0.1).astype(
        np.float32)
    ref = np.asarray(j_dac.DACEncoder().apply(variables,
                                              jnp.asarray(x[..., None])))
    with torch.no_grad():
        got = port(torch.from_numpy(x)[:, None]).numpy().transpose(0, 2, 1)
    assert got.shape == ref.shape == (1, 10, 1024)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_loudness_and_windows_bit_for_bit():
    t = np.arange(SR * 3) / SR
    x = np.sin(2 * np.pi * 997.0 * t)
    for sig in (x, 0.1 * x, np.zeros(SR), _voice(1.0, 150.0, 3)):
        assert t_dac.integrated_loudness(sig, SR) == \
            j_dac.integrated_loudness(sig, SR)
    assert t_dac.integrated_loudness(x, SR) == pytest.approx(-3.01, abs=0.5)
    wav = (np.random.default_rng(2).standard_normal(SR * 6) * 0.05).astype(
        np.float32)
    for sr in (SR, 16000):
        got, ref = t_dac.dac_windows(wav, sr), j_dac.dac_windows(wav, sr)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert t_dac.dac_windows(wav, SR).shape == (3, 120000)
