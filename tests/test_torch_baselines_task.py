"""The Interspeech24 baseline decoders (``cfg/ae/decoder/{nhv,mlsa,
mlsa-taylor,world}.yaml``) in the port's ``VoiceAutoEncoder`` against
golf_tpu's, on the CPU, on the small encoder of ``cfg/ae/synthetic.yaml``
(two pyramid levels of 8 and 16 channels, one LSTM layer of 32) at
B = 2 x 0.3 s:

* one training step: the same weights (through ``bridge``), the same noise
  (captured from golf_tpu's ``StandardNormalNoise``), f0 voiced
  everywhere; the loss within 1e-5 relative and every parameter's
  gradient within 1e-3 of its max-abs (``check_training_step``);
* ``predict_step`` on the same weights and noise, within 1e-5 of max|y|
  on an f0 whose phase increments both packages sum exactly; on the
  batch's own f0, no further than golf_tpu's from a float64 run of the
  port;
* ``autoencode_torch.py fit`` (2 steps), ``predict`` and ``test`` with
  ``--device cpu`` for nhv and mlsa-taylor.
"""

import contextlib
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
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.tasks.ae import build_voice_autoencoder as t_build
from tests.test_torch_train import (RNGS, _batch, _jax_init, _model_cfg,
                                    _seeded_params, _t_cfg, _train_apply,
                                    check_training_step)

torch.set_num_threads(1)

DECODERS = ["nhv", "mlsa", "mlsa-taylor", "world"]
SECONDS = 0.3


class BaselineStep:
    """golf_tpu's training step for one baseline decoder at B = 2 x 0.3 s:
    its seeded variables, the noise it drew, its first loss and gradients
    (the attributes ``check_training_step`` reads)."""

    def __init__(self, decoder):
        self.decoder = decoder
        self.x, self.f0 = _batch(2, SECONDS)
        self.task = j_build(_model_cfg(j_load_config, decoder))
        v = _jax_init(self.task, self.x, self.f0)
        self.variables = {**v, "params": _seeded_params(v["params"])}
        (_, _), state = jax.jit(lambda v_, x_, f_: _train_apply(
            self.task, v_, x_, f_, RNGS,
            mutable=["intermediates", "stats", "batch_stats"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise)))(
                self.variables, self.x, self.f0)
        self.noise = np.array(state["intermediates"]["decoder"]
                              ["noise_generator"]["__call__"][0].data)

        def loss_fn(params, others, x, f0):
            (loss, _), mutated = _train_apply(
                self.task, {**others, "params": params}, x, f0, RNGS,
                mutable=["stats", "batch_stats"])
            return loss, mutated

        others = {k: a for k, a in self.variables.items() if k != "params"}
        (loss, mutated), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                self.variables["params"], others, self.x, self.f0)
        self.first = (float(loss), grads, mutated)


@pytest.mark.parametrize("decoder", DECODERS)
def test_training_step_matches_golf_tpu(decoder):
    check_training_step(BaselineStep(decoder))


def exact_phase_f0(f0):
    """f0 rounded to a multiple of 24000 / 4096 Hz: the phase increments
    f0 / 24000 are then multiples of 1 / 4096, whose float32 cumsums are
    exact in any order. golf_tpu's float32 cumsum of other increments
    strays by up to a few 1e-6 cycles (the port accumulates each block in
    float64), and the 155-harmonic bank multiplies that by the harmonic's
    index: 2.9e-4 of max|y| for nhv on the unrounded f0 of this batch."""
    step = np.float32(24000 / 4096)
    return (np.round(f0 / step) * step).astype(np.float32)


def _predict_both(decoder, f0_fn, dtypes=(torch.float32,)):
    """golf_tpu's predict_step and the port's (in each of ``dtypes``) on the
    same weights, batch (its f0 through ``f0_fn``) and noise."""
    x, f0 = _batch(2, SECONDS)
    f0 = f0_fn(f0)
    j_task = j_build(_model_cfg(j_load_config, decoder))
    v = _jax_init(j_task, x, f0)
    variables = {**v, "params": _seeded_params(v["params"])}
    (y_j, _), state = jax.jit(lambda v_, x_, f_: j_task.apply(
        v_, JSig(x_, 1), JSig(f_, 1), rngs={"noise": jax.random.key(3)},
        mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise),
        method=lambda m, *a: m.predict_step(*a)))(
            variables, jnp.asarray(x), jnp.asarray(f0))
    noise = np.array(state["intermediates"]["decoder"]["noise_generator"]
                     ["__call__"][0].data)
    outs = []
    for dtype in dtypes:
        t_task = t_build(_t_cfg(decoder), device="cpu")
        load_flax_variables(t_task, jax.tree_util.tree_map(np.asarray,
                                                           variables))
        t_task.eval().to(dtype)
        with torch.inference_mode():
            y_t, _ = t_task.predict_step(
                TSig(torch.from_numpy(x).to(dtype), 1),
                TSig(torch.from_numpy(f0).to(dtype), 1),
                noise=torch.from_numpy(noise).to(dtype))
        assert y_t.hop == 1
        outs.append(y_t.data.double().numpy())
    return np.asarray(y_j.data, np.float64), outs


@pytest.mark.parametrize("decoder", DECODERS)
def test_predict_step_matches_golf_tpu(decoder):
    """Serving on the same weights and noise, within 1e-5 of max|y|; the
    output's length follows golf_tpu's (NHV's harmonic branch is
    (frames - 1) * hop long and the sum truncates to it)."""
    ref, (out,) = _predict_both(decoder, exact_phase_f0)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("decoder", DECODERS)
def test_predict_step_unrounded_f0_against_float64(decoder):
    """On the batch's own f0, a float64 run of the port arbitrates: the
    port's float32 output is no further from it than golf_tpu's (measured
    5.1e-5 to 6.2e-5 of max|y| against golf_tpu's 2.9e-4 to 3.5e-4)."""
    ref, (out, out64) = _predict_both(decoder, lambda f0: f0,
                                      (torch.float32, torch.float64))
    scale = np.abs(out64).max()
    err = np.abs(out - out64).max() / scale
    ref_err = np.abs(ref - out64).max() / scale
    assert err <= ref_err, (err, ref_err)


@pytest.mark.parametrize("decoder", ["nhv", "mlsa-taylor"])
def test_cli_fit_predict_test(decoder, tmp_path):
    """``fit`` for 2 steps, then ``predict`` (one wav an item) and ``test``
    (finite ``avg_mcd`` and ``avg_mss_loss``) from its checkpoint."""
    from golf_tpu_torch.tasks.cli import run
    args = ["--config", "cfg/ae/synthetic.yaml", "--model",
            f"cfg/ae/decoder/{decoder}.yaml", "--device", "cpu",
            "data.init_args.duration=0.5", "data.init_args.n_items=4",
            "data.init_args.batch_size=2"]
    fit_dir = tmp_path / "fit"
    assert run(["fit", *args, "--run_dir", str(fit_dir),
                "trainer.max_steps=2"]) == 0
    ckpt = str(fit_dir / "ckpt" / "last")
    assert run(["predict", *args, "--run_dir", str(tmp_path / "p"),
                "--ckpt_path", ckpt]) == 0
    wavs = os.listdir(tmp_path / "p" / "predictions")
    assert len(wavs) == 4 and all(w.endswith(".wav") for w in wavs)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run(["test", *args, "--run_dir", str(tmp_path / "t"),
                    "--ckpt_path", ckpt]) == 0
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    assert np.isfinite(got["avg_mcd"]) and np.isfinite(got["avg_mss_loss"])
