"""``tools/orbax_to_torch.py`` against golf_tpu, on the CPU.

An orbax checkpoint saved in ``tmp_path`` by golf_tpu's
``CheckpointManager`` (GOLF-ff on the ``cfg/ae/synthetic.yaml`` encoder,
seeded weights, an Adam or an SGD optimizer state) is converted; the
port restores it params-only, and its ``predict_step`` is held to
golf_tpu's on the same batch and noise within 1e-4 of max|y| (fp32 on both
sides through the BiLSTM and two FFT libraries). The converted checkpoint
carries no optimizer state: a full restore raises, and the CLI's
``--ckpt_path`` reads it.
"""

import contextlib
import importlib.util
import io
import json
import os

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
from golf_tpu.train.checkpoint import CheckpointManager
from golf_tpu.train.loop import TrainState, make_optimizer
from golf_tpu_torch.config.registry import load_config as t_load_config
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.tasks.ae import build_voice_autoencoder as t_build
from golf_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREDICT_TOL = 1e-4     # of max|y|, golf_tpu's predict against the port's


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(ROOT, "tools", "orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_cfg(loader):
    cfg = loader("cfg/ae/synthetic.yaml")
    dec = loader("cfg/ae/decoder/golf.yaml")
    return {**cfg["model"]["init_args"], "decoder": dec["decoder"]}


@pytest.fixture(scope="module")
def reference():
    """golf_tpu's task, seeded variables, one batch, its predict_step's
    output and the noise it drew."""
    ds = SyntheticVoiceDataset(2, 0.5, 24000, seed=3)
    x = np.stack([ds[i][0] for i in range(2)])
    f0 = np.stack([ds[i][1] for i in range(2)])
    # white noise at -30 dB of full scale keeps the spectrogram's bins off
    # the floor, where the two FFT libraries' rounding is amplified by log
    x = (x + 0.03 * np.random.default_rng(11).standard_normal(x.shape)
         ).astype(np.float32)
    task = j_build(_model_cfg(j_load_config))

    def init(x_, f0_):
        phase = JSig(jnp.where(f0_ == 0, 150.0, f0_) / 24000.0, 1)
        return task.init(
            {"params": jax.random.key(0), "noise": jax.random.key(1),
             "dropout": jax.random.key(2)},
            JSig(x_, 1), JSig(f0_, 1), {"phase": phase}, True)

    variables = dict(jax.jit(init)(jnp.asarray(x), jnp.asarray(f0)))
    r = np.random.default_rng(5)
    variables["params"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * 0.1), variables["params"])
    (y, _), state = jax.jit(lambda v, x_, f0_: task.apply(
        v, JSig(x_, 1), JSig(f0_, 1), rngs={"noise": jax.random.key(3)},
        mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise),
        method=lambda m, *a: m.predict_step(*a)))(
            variables, jnp.asarray(x), jnp.asarray(f0))
    noise = np.array(state["intermediates"]["decoder"]["noise_generator"]
                     ["__call__"][0].data)
    return variables, x, f0, np.asarray(y.data), noise


def _save_orbax(path, variables, optimizer, step):
    params = variables["params"]
    state = TrainState(params, make_optimizer(1e-4, 0.5, optimizer)
                       .init(params), variables.get("stats", {}),
                       variables.get("batch_stats", {}), step)
    CheckpointManager(str(path)).save_last(state)
    return str(path / "last")


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_converted_checkpoint_predicts_as_golf_tpu(tmp_path, reference,
                                                   optimizer):
    variables, x, f0, y_ref, noise = reference
    src = _save_orbax(tmp_path / "ckpt", variables, optimizer, step=7)
    dst = str(tmp_path / "port.pt")
    assert _tool().convert(src, dst) == 7
    task = t_build(_model_cfg(lambda p: t_load_config([p])), device="cpu")
    trainer = Trainer(task, run_dir=str(tmp_path / "run"))
    trainer.restore(dst, params_only=True)
    assert trainer.step == 0
    task.eval()
    with torch.inference_mode():
        y, _ = task.predict_step(TSig(torch.from_numpy(x), 1),
                                 TSig(torch.from_numpy(f0), 1),
                                 noise=torch.from_numpy(noise))
    out = y.data.numpy()
    assert out.shape == y_ref.shape and np.abs(y_ref).max() > 0
    err = np.abs(out - y_ref).max() / np.abs(y_ref).max()
    assert err <= PREDICT_TOL, err


def test_converted_checkpoint_restores_params_only(tmp_path, reference):
    variables = reference[0]
    src = _save_orbax(tmp_path / "ckpt", variables, "adam", step=3)
    dst = str(tmp_path / "port.pt")
    _tool().convert(src, dst)
    task = t_build(_model_cfg(lambda p: t_load_config([p])), device="cpu")
    trainer = Trainer(task, run_dir=str(tmp_path / "run"))
    with pytest.raises(ValueError, match="params-only"):
        trainer.restore(dst)
    # the CLI's --ckpt_path reads it: validate restores params-only
    args = ["--config", "cfg/ae/synthetic.yaml", "--model",
            "cfg/ae/decoder/golf.yaml", "--device", "cpu",
            "data.init_args.n_items=4", "data.init_args.duration=0.3",
            "data.init_args.batch_size=2", "--run_dir", str(tmp_path / "v"),
            "--ckpt_path", dst]
    from golf_tpu_torch.tasks.cli import run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run(["validate", *args]) == 0
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    assert np.isfinite(got["val_loss"])
