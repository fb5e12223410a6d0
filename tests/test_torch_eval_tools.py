"""The port's evaluation tools against golf_tpu's, on the CPU, with the
weights of ``cfg/ae/synthetic.yaml`` carried over by the bridge and the
noise field captured from golf_tpu's run:

* ``test_rtf_torch``: the analysis' raw groups within 1e-4 of max-abs and
  the synthesis (``decoder.apply_ctrl`` then the synthesizer on f0 / sr)
  within 1e-4 of max|y| of golf_tpu's ``test_rtf.py`` bodies (GOLF-ff and
  GOLF-ss; measured near 1e-6), and its report and CLI;
* ``harm_and_noise_torch``: ``crossfade_chunks`` within 1e-12 of
  golf_tpu's, the two branches within 1e-4 of max|y| of golf_tpu's body,
  and the CLI on a VCTK tree;
* ``biquads_torch``: the same npz keys as golf_tpu's body, values within
  1e-4 relative (``biquads`` 1e-3: roots amplify the LPC's rounding);
* ``eval_pesq_torch.score_pair`` within 1e-6 of ``eval_pesq.score_pair``
  (the 16 kHz resampling on the device is scipy's within 1e-15), its CLI
  label, and the port's build of ``native/pesq862.cpp`` against the
  anchors of ``tests/test_pesq862.py`` (skipped only without ``g++``);
* every new entry point raises without a GPU unless given the CPU."""

import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import biquads_torch
import eval_pesq_torch
import fad_torch
import harm_and_noise as j_hn
import harm_and_noise_torch as t_hn
import test_rtf_torch
from golf_tpu.config.registry import load_config as j_load_config
from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models.noise import StandardNormalNoise as JNoise
from golf_tpu.tasks.ae import build_voice_autoencoder as j_build
from golf_tpu.utils import pesq862 as j_pesq862
from golf_tpu.utils.wav import write_wav
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.config.registry import load_config as t_load_config
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.tasks.ae import build_voice_autoencoder as t_build
from golf_tpu_torch.utils import native as t_native
from golf_tpu_torch.utils import pesq862 as t_pesq862
from tests.test_torch_slice import _batch, _seeded

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 24000
HAS_GXX = shutil.which("g++") is not None


def _cfg(loader, decoder, **encoder):
    cfg = loader("cfg/ae/synthetic.yaml")
    dec = loader(f"cfg/ae/decoder/{decoder}.yaml")
    init = {**cfg["model"]["init_args"], "decoder": dec["decoder"]}
    init["encoder_init_args"] = {**init["encoder_init_args"], **encoder}
    return init


def _pair(decoder, x, f0, **encoder):
    """golf_tpu's task with seeded variables (its init on this batch, as
    its tools do) and the port's task with the same weights, on the CPU."""
    j_task = j_build(_cfg(j_load_config, decoder, **encoder))

    def init(x_, f0_):
        return j_task.init(
            {"params": jax.random.key(0), "noise": jax.random.key(1),
             "dropout": jax.random.key(2)}, JSig(x_, 1), JSig(f0_, 1),
            train=True, method=lambda m, *a, **k: m.training_step(*a, **k))

    vs = _seeded(dict(jax.jit(init)(jnp.asarray(x), jnp.asarray(f0))), 5)
    t_task = t_build(_cfg(lambda p: t_load_config([p]), decoder, **encoder),
                     device="cpu")
    load_flax_variables(t_task, jax.tree_util.tree_map(np.asarray, vs))
    return j_task, vs, t_task.eval()


def _capture_noise(state):
    return torch.from_numpy(np.array(
        state["intermediates"]["decoder"]["noise_generator"]["__call__"][0]
        .data))


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("decoder", ["golf", "golf-precise"])
def test_rtf_analysis_and_synthesis_match_golf_tpu(decoder):
    x, _ = _batch(1, 0.5)
    f0 = np.full_like(x, 180.0)                  # test_rtf.py's f0
    j_task, vs, t_task = _pair(decoder, x, f0)
    rngs = {"noise": jax.random.key(3), "dropout": jax.random.key(4)}
    # the bodies of golf_tpu's test_rtf.py
    params = j_task.apply(vs, JSig(jnp.asarray(x), 1),
                          f0=JSig(jnp.asarray(f0), 1), train=False, rngs=rngs,
                          method=lambda m, *a, **k: m.encoder(*a, **k))
    raw = {k: v for k, v in params.items() if k.endswith("_params")}
    phase = JSig(jnp.asarray(f0) / SR, 1)

    def body(mdl, params, phase):
        p = mdl.decoder.apply_ctrl(params)
        p["phase"] = phase
        return mdl.decoder(**p)

    y_j, state = jax.jit(lambda v, r, ph: j_task.apply(
        v, r, ph, rngs=rngs, method=body, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise)))(
            vs, raw, phase)

    xt = TSig(torch.from_numpy(x), 1)
    f0t = TSig(torch.from_numpy(f0), 1)
    t_params = test_rtf_torch.analysis(t_task, xt, f0t)
    t_raw = {k: v for k, v in t_params.items() if k.endswith("_params")}
    assert set(t_raw) == set(raw)
    for k in raw:
        for a, b in zip(t_raw[k], raw[k]):
            assert _rel(a.data, b.data) <= 1e-4, k
    y_t = test_rtf_torch.synthesis(t_task, t_raw, t_task.cycles(f0t),
                                   noise=_capture_noise(state))
    assert np.isfinite(np.asarray(y_j.data)).all()
    assert _rel(y_t.data, y_j.data) <= 1e-4


def test_rtf_measure_and_cli(capsys):
    task, sr = test_rtf_torch.load_task(["cfg/ae/synthetic.yaml"],
                                        "cfg/ae/decoder/golf.yaml",
                                        device="cpu")
    x, f0 = test_rtf_torch.clip(sr, 0.25)
    out = test_rtf_torch.measure(task, x, f0, sr, num=3)
    assert out["device"] == "cpu" and out["launches_per_synthesis"] == {}
    for stage in ("analysis", "synthesis"):
        r = out[stage]
        assert r["ms"] > 0 and r["rtf"] == pytest.approx(r["ms"] / 250.0)
    assert test_rtf_torch.main(
        ["--config", "cfg/ae/synthetic.yaml", "--model",
         "cfg/ae/decoder/golf-precise.yaml", "--device", "cpu",
         "--duration", "0.25", "--num", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    assert any(ln.startswith("synthesis:") and "x realtime" in ln
               for ln in lines)


def test_crossfade_chunks_matches_golf_tpu():
    r = np.random.default_rng(0)
    for n, chunk, overlap in ((1, 50, 10), (3, 50, 10), (4, 64, 0),
                              (2, 40, 39)):
        chunks = [r.standard_normal(chunk) for _ in range(n)]
        ref = j_hn.crossfade_chunks(chunks, chunk, overlap)
        got = t_hn.crossfade_chunks(chunks, chunk, overlap)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-12


@pytest.mark.parametrize("decoder", ["golf", "golf-precise"])
def test_branches_match_golf_tpu(decoder):
    x, f0 = _batch(1, 0.5)
    j_task, vs, t_task = _pair(decoder, x, f0)

    def body(mdl, x, f0):
        # golf_tpu's harm_and_noise.py, its branches
        params = mdl.encoder(x, f0=f0)
        params.pop("f0", None)
        params.pop("voicing_logits", None)
        phase = JSig(jnp.where(f0.data == 0, 150.0, f0.data) / SR, 1)
        p = mdl.decoder.apply_ctrl(params)
        dec = mdl.decoder
        harm = dec.harm_oscillator(phase, *p["harm_oscillator_params"])
        noise = dec.noise_filter(
            dec.noise_generator(harm, *p["noise_generator_params"]),
            *p["noise_filter_params"])
        return (dec.end_filter(harm, *p["end_filter_params"]).data,
                dec.end_filter(noise, *p["end_filter_params"]).data)

    (h_j, n_j), state = jax.jit(lambda v, a, b: j_task.apply(
        v, JSig(a, 1), JSig(b, 1), rngs={"noise": jax.random.key(3)},
        method=body, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise)))(
            vs, jnp.asarray(x), jnp.asarray(f0))
    h_t, n_t = t_hn.branches(t_task, TSig(torch.from_numpy(x), 1),
                             TSig(torch.from_numpy(f0), 1),
                             noise=_capture_noise(state))
    assert _rel(h_t, h_j) <= 1e-4
    assert _rel(n_t, n_j) <= 1e-4


def _vctk_tree(root, seconds=0.6):
    """Two test speakers of the VCTK split (p360, p361), one 24 kHz file
    each, with 5 ms ``.pv`` tracks."""
    from golf_tpu_torch.tasks.data import SyntheticVoiceDataset
    ds = SyntheticVoiceDataset(2, seconds, SR, seed=7)
    for i, spk in enumerate(("p360", "p361")):
        x, f0 = ds[i]
        write_wav(str(root / spk / f"{spk}_001.wav"), x, SR)
        np.savetxt(root / spk / f"{spk}_001.pv", f0[::SR // 200],
                   fmt="%.3f")
    return root


def test_harm_and_noise_cli_writes_both_branches(tmp_path):
    tree = _vctk_tree(tmp_path / "vctk")
    rc = t_hn.main(["--config", "cfg/ae/synthetic.yaml", "--model",
                    "cfg/ae/decoder/golf.yaml", "--wav-dir", str(tree),
                    "--out-dir", str(tmp_path / "out"), "--chunk-secs",
                    "0.4", "--fade-secs", "0.1", "--device", "cpu"])
    assert rc == 0
    from golf_tpu_torch.utils.wav import read_wav
    for branch in ("harm", "noise"):
        for spk in ("p360", "p361"):
            y, sr = read_wav(str(tmp_path / "out" / branch / spk
                                 / f"{spk}_001.wav"))
            assert sr == SR and y.shape == (int(0.6 * SR),)
            assert np.isfinite(y).all() and np.abs(y).max() > 0


def test_biquads_npz_matches_golf_tpu(tmp_path):
    x, f0 = _batch(1, 0.5)
    f0 = np.full_like(f0, 150.0)
    enc = {"learn_voicing": True, "learn_f0": True}
    j_task, vs, t_task = _pair("golf", x, f0, **enc)

    def body(mdl, x, f0):
        # golf_tpu's biquads.py
        raw = mdl.encoder(x, f0=f0)
        voicing = raw.pop("voicing_logits", None)
        f0_hat = raw.pop("f0", None)
        return {"params": mdl.decoder.apply_ctrl(raw),
                "voicing": jax.nn.sigmoid(voicing.data),
                "f0": f0_hat.data}

    out = j_task.apply(vs, JSig(jnp.asarray(x), 1), JSig(jnp.asarray(f0), 1),
                       rngs={"noise": jax.random.key(3)}, method=body)
    gain, a = out["params"]["end_filter_params"]
    ref = {"gain": gain.data, "lpc": a.data,
           "biquads": biquads_torch.lpc_biquads(np.asarray(a.data)[0]),
           "table_weight": out["params"]["harm_oscillator_params"][0].data,
           "voicing": out["voicing"], "f0": out["f0"]}
    got = biquads_torch.extract(t_task, x[0], init_stats=False)
    assert sorted(got) == sorted(ref) == ["biquads", "f0", "gain", "lpc",
                                          "table_weight", "voicing"]
    for k in ref:
        assert _rel(got[k], ref[k]) <= (1e-3 if k == "biquads" else 1e-4), k
    # the CLI writes the same keys
    wav = tmp_path / "in.wav"
    write_wav(str(wav), x[0], SR)
    assert biquads_torch.main(
        ["--config", "cfg/ae/synthetic.yaml", "--model",
         "cfg/ae/decoder/golf.yaml", "--wav", str(wav), "--out",
         str(tmp_path / "o.npz"), "--device", "cpu"]) == 0
    assert sorted(np.load(tmp_path / "o.npz").files) == [
        "biquads", "gain", "lpc", "table_weight"]


def _speech_like(seconds=3.0, seed=0, fs=16000):
    # tests/test_pesq862.py's signal
    t = np.arange(int(fs * seconds)) / fs
    env = (np.sin(2 * np.pi * 1.3 * t) ** 2) * \
        (np.sin(2 * np.pi * 0.31 * t) > -0.2)
    x = env * sum(np.sin(2 * np.pi * 180 * k * t + 0.1 * k * k) / k
                  for k in range(1, 40))
    return (x * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def golf_pesq():
    """golf_tpu's ``eval_pesq`` on the native P.862 (its own
    ``native/libpesq862.so``, else the port's build of the same source)."""
    if not HAS_GXX:
        pytest.skip("no g++: native/pesq862.cpp cannot be built")
    if not j_pesq862._LIB_PATH.exists():
        j_pesq862._LIB_PATH = t_native.build_host_library("pesq862.cpp")
        j_pesq862._tried = False
    assert j_pesq862.available()
    import eval_pesq
    assert eval_pesq.HAS_NATIVE_PESQ
    return eval_pesq


def test_score_pair_matches_golf_tpu(golf_pesq, tmp_path):
    ref = _speech_like(2.0, fs=24000)
    rng = np.random.default_rng(1)
    for i, snr in enumerate((30, 10)):
        deg = ref + rng.standard_normal(ref.size).astype(np.float32) * \
            np.sqrt((ref ** 2).mean() / 10 ** (snr / 10))
        for root, x in (("ref", ref), ("deg", deg)):
            write_wav(str(tmp_path / root / "s" / f"{i}.wav"), x, SR)
    pairs = eval_pesq_torch.matched_pairs(tmp_path / "ref", tmp_path / "deg")
    assert len(pairs) == 2
    got = [eval_pesq_torch.score_pair(p, "cpu") for p in pairs]
    want = [golf_pesq.score_pair(p) for p in pairs]
    assert np.abs(np.subtract(got, want)).max() <= 1e-6
    assert got[0] > got[1]
    assert eval_pesq_torch.main([str(tmp_path / "ref"), str(tmp_path / "deg"),
                                 "--workers", "2", "--device", "cpu"]) == 0


@pytest.mark.skipif(not HAS_GXX, reason="no g++: pesq862.cpp not built")
@pytest.mark.parametrize("case", ["identity", "noise", "level", "delay",
                                  "quantization"])
def test_built_pesq862_holds_the_anchors(case):
    x = _speech_like()
    fs = 16000
    if case == "identity":
        assert t_pesq862.pesq(x, x, fs, "wb") > 4.5
    elif case == "noise":
        rng = np.random.default_rng(0)
        scores = []
        for snr in (40, 30, 20, 10, 0):
            noise = rng.standard_normal(len(x)) * np.sqrt(
                (x ** 2).mean() / 10 ** (snr / 10))
            scores.append(t_pesq862.pesq(x, (x + noise).astype(np.float32),
                                         fs, "wb"))
        assert all(a > b for a, b in zip(scores, scores[1:])), scores
        assert scores[0] > 4.0 and scores[-1] < 1.6
    elif case == "level":
        assert t_pesq862.pesq(x, 0.5 * x, fs, "wb") > 4.5
        assert t_pesq862.pesq(x, 2.0 * x, fs, "wb") > 4.5
    elif case == "delay":
        assert t_pesq862.pesq(x, np.roll(x, 160), fs, "wb") > 4.2
    else:
        q = np.round(x * 32) / 32
        assert 1.5 < t_pesq862.pesq(x, q, fs, "wb") < 4.4
    assert t_native.library_path("pesq862.cpp").exists()


def _script_main(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


ENTRY = {
    "test_rtf_torch": lambda: test_rtf_torch.main(
        ["--config", "cfg/ae/synthetic.yaml", "--model",
         "cfg/ae/decoder/golf.yaml"]),
    "harm_and_noise_torch": lambda: t_hn.main(
        ["--config", "cfg/ae/synthetic.yaml", "--model",
         "cfg/ae/decoder/golf.yaml", "--wav-dir", ".", "--out-dir", "."]),
    "biquads_torch": lambda: biquads_torch.main(
        ["--config", "cfg/ae/synthetic.yaml", "--model",
         "cfg/ae/decoder/golf.yaml", "--wav", "x.wav", "--out", "x.npz"]),
    "eval_pesq_torch": lambda: eval_pesq_torch.main([".", "."]),
    "fad_torch": lambda: fad_torch.main([".", "."]),
    "wav2f0_torch": lambda: _script_main("wav2f0_torch")(["."]),
    "resample_dir_torch": lambda: _script_main("resample_dir_torch")(
        [".", "."]),
    "pitchnet.predict": lambda: __import__(
        "golf_tpu_torch.utils.pitchnet", fromlist=["predict"]).predict(
            np.zeros(1600, np.float32), 16000),
}


@pytest.mark.parametrize("entry", sorted(ENTRY))
def test_entry_points_default_to_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY[entry]()
