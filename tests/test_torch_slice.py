"""The whole serving slice of the port against golf_tpu, on the CPU:
``VoiceAutoEncoder.predict_step`` at small widths (the encoder of
``cfg/ae/synthetic.yaml``) with the GOLF-ff and GOLF-ss decoders, weights
carried over by ``golf_tpu_torch.bridge``; plus the port's rules: no JAX
import, CUDA by default, the chip smoke config equal to the YAML files,
and the ``predict`` CLI."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.config.registry import load_config as j_load_config
from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models.noise import StandardNormalNoise as JNoise
from golf_tpu.tasks.ae import build_voice_autoencoder as j_build
from golf_tpu.tasks.data import SyntheticVoiceDataset
from golf_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from golf_tpu_torch.config.registry import load_config as t_load_config
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.tasks.ae import build_voice_autoencoder as t_build

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model_cfg(loader, decoder):
    cfg = loader("cfg/ae/synthetic.yaml")
    dec = loader(f"cfg/ae/decoder/{decoder}.yaml")
    return {**cfg["model"]["init_args"], "decoder": dec["decoder"]}


def _batch(n=2, seconds=0.5):
    ds = SyntheticVoiceDataset(n, seconds, 24000, seed=3)
    items = [ds[i] for i in range(n)]
    return (np.stack([x for x, _ in items]), np.stack([f for _, f in items]))


def _seeded(variables, seed):
    """Every parameter replaced by seeded normals (the zero-initialised
    head and room filter would make the comparison trivial); batch-norm
    statistics moved off their initial values too."""
    r = np.random.default_rng(seed)

    def normal(a, scale=0.1):
        return jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                           * scale)

    params = jax.tree_util.tree_map(normal, variables["params"])
    bstats = jax.tree_util.tree_map(lambda a: a, variables["batch_stats"])
    for bn in bstats["encoder"]["backbone"]["ConvPyramid_0"].values():
        bn["mean"] = normal(bn["mean"])
        bn["var"] = 1.0 + jnp.abs(normal(bn["var"]))
    return {**variables, "params": params, "batch_stats": bstats}


def _jax_task_and_variables(decoder, x, f0):
    task = j_build(_model_cfg(j_load_config, decoder))

    # as golf_tpu's Trainer.init_state: a train-mode forward on this batch,
    # which sets the encoder's running min/max (jitted: one compile instead
    # of one per primitive)
    def init(x_, f0_):
        phase = JSig(jnp.where(f0_ == 0, 150.0, f0_) / 24000.0, 1)
        return task.init(
            {"params": jax.random.key(0), "noise": jax.random.key(1),
             "dropout": jax.random.key(2)},
            JSig(x_, 1), JSig(f0_, 1), {"phase": phase}, True)

    variables = jax.jit(init)(jnp.asarray(x), jnp.asarray(f0))
    return task, _seeded(dict(variables), seed=5)


@pytest.mark.parametrize("decoder", ["golf", "golf-precise"])
def test_predict_step_matches_golf_tpu(decoder):
    x, f0 = _batch()
    j_task, variables = _jax_task_and_variables(decoder, x, f0)
    (y_j, _), state = jax.jit(lambda v, x_, f0_: j_task.apply(
        v, JSig(x_, 1), JSig(f0_, 1), rngs={"noise": jax.random.key(3)},
        mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise),
        method=lambda m, *a: m.predict_step(*a)))(
            variables, jnp.asarray(x), jnp.asarray(f0))
    noise = np.array(state["intermediates"]["decoder"]["noise_generator"]
                     ["__call__"][0].data)

    t_task = t_build(_model_cfg(lambda p: t_load_config([p]), decoder),
                     device="cpu")
    load_flax_variables(t_task, jax.tree_util.tree_map(np.asarray,
                                                       variables))
    t_task.eval()
    with torch.inference_mode():
        y_t, _ = t_task.predict_step(TSig(torch.from_numpy(x), 1),
                                     TSig(torch.from_numpy(f0), 1),
                                     noise=torch.from_numpy(noise))
    ref = np.asarray(y_j.data)
    out = y_t.data.numpy()
    assert out.shape == ref.shape
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    # fp32 on both sides through a 1-layer BiLSTM, two FFT libraries and
    # the all-pole filters; the decoder alone agrees to ~1.5e-5 of its peak
    # (test_torch_decoder.py), the whole slice measured ~5e-5, so 1e-3
    # leaves room for the encoder's sum-order noise on other inputs
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err < 1e-3, err


def test_bridge_shapes_and_running_stats():
    x, f0 = _batch()
    _, variables = _jax_task_and_variables("golf", x, f0)
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    t_task = t_build(_model_cfg(lambda p: t_load_config([p]), "golf"),
                     device="cpu")
    own = {k: tuple(v.shape) for k, v in t_task.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert {k: tuple(v.shape) for k, v in sd.items()} == own
    # the port's init of the running min/max equals golf_tpu's
    t_task.init_running_stats(TSig(torch.from_numpy(x), 1),
                              TSig(torch.from_numpy(f0), 1))
    stats = variables["stats"]["encoder"]["backbone"]
    bb = t_task.encoder.backbone
    np.testing.assert_allclose(bb.log_spec_min.item(),
                               float(stats["log_spec_min"]), rtol=1e-5)
    np.testing.assert_allclose(bb.log_spec_max.item(),
                               float(stats["log_spec_max"]), rtol=1e-5)


def test_port_imports_without_jax():
    """golf_tpu_torch and chip_smoke import with JAX, flax, optax and
    golf_tpu made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'optax', 'golf_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import golf_tpu_torch\n"
        "for info in pkgutil.walk_packages(golf_tpu_torch.__path__,\n"
        "                                  'golf_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda(monkeypatch):
    cfg = _model_cfg(lambda p: t_load_config([p]), "golf")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build(cfg)
    assert next(t_build(cfg, device="cpu").parameters()).device.type == "cpu"
    from golf_tpu_torch.tasks.cli import run
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(["predict", "--config", "cfg/ae/synthetic.yaml", "--model",
             "cfg/ae/decoder/golf.yaml"])


@pytest.mark.parametrize("decoder", ["golf", "golf-precise", "nhv", "mlsa",
                                     "mlsa-taylor", "world"])
def test_chip_smoke_config_equals_yaml(decoder):
    import chip_smoke
    cfg = j_load_config("cfg/ae/vctk.yaml")
    dec = j_load_config(f"cfg/ae/decoder/{decoder}.yaml")
    expected = {**cfg["model"]["init_args"], "decoder": dec["decoder"]}
    assert chip_smoke.model_config(decoder) == expected


def test_predict_cli_writes_wavs(tmp_path):
    from golf_tpu_torch.tasks.cli import run
    from golf_tpu_torch.utils.wav import read_wav
    rc = run(["predict", "--config", "cfg/ae/synthetic.yaml", "--model",
              "cfg/ae/decoder/golf.yaml", "--device", "cpu", "--run_dir",
              str(tmp_path), "data.init_args.n_items=8",
              "data.init_args.duration=0.3", "data.init_args.batch_size=2"])
    assert rc == 0
    wavs = sorted((tmp_path / "predictions").glob("*.wav"))
    assert len(wavs) == 4
    audio, sr = read_wav(str(wavs[0]))
    assert sr == 24000 and audio.shape[0] > 0.9 * 0.3 * sr
    assert np.isfinite(audio).all()
    assert (tmp_path / "config.yaml").exists()


def test_predict_cli_takes_overrides_between_options():
    from golf_tpu_torch.tasks.cli import _parse_args
    args = _parse_args(["predict", "--config", "a.yaml", "--model", "b.yaml",
                        "x.y=1", "--run_dir", "r", "z=2"])
    assert (args.config, args.model, args.run_dir, args.overrides) == (
        ["a.yaml"], "b.yaml", "r", ["x.y=1", "z=2"])
