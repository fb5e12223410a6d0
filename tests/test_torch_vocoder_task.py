"""The ISMIR23 mel vocoder task of the port (``DDSPVocoder``) against
golf_tpu's, on the CPU, at the widths of ``tests/test_torch_vocoder.py``
(``cfg/vocoder.yaml`` cut to 24 mels and a 16 x 2 Mel2Control, B = 2 x
0.5 s), with ``golf-v1.yaml`` and ``ddsp.yaml``:

* ``training_step`` (the recipe's golf-v1, golf-v1 with the voicing
  detached, ddsp): the loss within 1e-5 relative, ``l1_loss``, ``f0_loss``
  and ``voicing_loss`` too, against ``jax.value_and_grad`` of golf_tpu's;
  every parameter's gradient within 1e-3 of its max-abs of golf_tpu's, on
  the recipe's path (the voicing's gradient through the wavetable's
  phase, where float32 is ill-conditioned on both sides) within 1e-3 of a
  float64 run or twice golf_tpu's distance from it; the lookup's forward
  is the residual one (B3a's plain twin) exactly when the phase needs a
  gradient; three Adam steps against golf_tpu's ``make_optimizer`` (rtol
  1e-4);
* ``predict_step`` and ``chunked_ola_predict`` (an identity and the
  model's own function on 14 s, three chunks) on the same weights;
* ``run_vocoder_test`` on a small ``Synthetic`` split (MSS and cents);
* a golf_tpu orbax checkpoint converted by ``tools/orbax_to_torch.py``;
* ``main_torch.py fit``, ``validate``, ``test`` and ``predict`` with
  ``--device cpu``, and its refusal without a card.

Weights cross through ``bridge``; noise is captured from golf_tpu's run.
golf_tpu's training-step gradient is compiled without XLA:CPU's expensive
passes (``fast_jit``): at the default level the GOLF decoders' gradient
takes tens of minutes to compile.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models.noise import StandardNormalNoise as JNoise
from golf_tpu.tasks import vocoder as jvoc
from golf_tpu.tasks.data import Synthetic as JSynthetic
from golf_tpu.train.checkpoint import CheckpointManager
from golf_tpu.train.loop import TrainState, make_optimizer
from golf_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.ops import lookup as tlk
from golf_tpu_torch.tasks import vocoder as tvoc
from golf_tpu_torch.tasks.data import Synthetic as TSynthetic
from golf_tpu_torch.train.loop import (ClippedOptimizer, Trainer,
                                       trainable_parameters)
from tests.test_torch_orbax import _tool
from tests.test_torch_vocoder import (batch, fast_jit, j_cfg, np_tree,
                                      seeded, t_cfg, within)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 24000
LR = 1e-3        # twice the recipe's, so that three steps move the loss
LOSS_TOL = 1e-5  # relative
GRAD_TOL = 1e-3  # of each gradient's max-abs
# a whole forward, of max|y|, as tests/test_torch_slice.py holds the
# autoencoder's: the decoder alone agrees within 1e-4 (test_torch_vocoder.py),
# the fp32 BiLSTM and the mel's log add their sum-order rounding, and the
# phase's float32 sums (golf_tpu's) grow with the clip (measured 1.5e-4 over
# the OLA's 6 s chunks)
PREDICT_TOL = 1e-3
RNGS = {"noise": jax.random.key(3), "dropout": jax.random.key(4)}


def _train_apply(task, variables, x, f0, rngs, **kw):
    return task.apply(variables, JSig(x, 1), JSig(f0, 1), True, rngs=rngs,
                      method=lambda m, *a: m.training_step(*a), **kw)


def jax_variables(task, x, f0):
    """golf_tpu's Trainer.init_state (a train-mode training_step init on
    the first batch, which sets the log-mel min/max), every parameter then
    seeded."""
    v = dict(fast_jit(lambda x_, f0_: task.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1),
         "dropout": jax.random.key(2)}, JSig(x_, 1), JSig(f0_, 1), True,
        method=lambda m, *a: m.training_step(*a)))(x, f0))
    return {**v, "params": seeded(v["params"])}


# the training-step cases: the recipe (golf-v1, the voicing not detached,
# so its gradient reaches the phase), golf-v1 with the voicing detached, and
# ddsp
CASES = {"golf-v1": ("golf-v1", {}),
         "golf-v1/detach_voicing": ("golf-v1", {"detach_voicing": True}),
         "ddsp": ("ddsp", {})}


def case_cfg(cfg_fn, case):
    decoder, extra = CASES[case]
    return {**cfg_fn(decoder), **extra}


class JaxStep:
    """golf_tpu's DDSPVocoder training step for one case: the first loss,
    metrics and gradients, the noise it drew, and the eager
    ``jax.value_and_grad`` for more steps."""

    def __init__(self, case):
        self.case = case
        self.x, self.f0 = batch()
        self.task = jvoc.build_ddsp_vocoder(case_cfg(j_cfg, case))
        self.variables = jax_variables(self.task, self.x, self.f0)

        def loss_fn(params, others, x, f0):
            (loss, metrics), mutated = _train_apply(
                self.task, {**others, "params": params}, x, f0, RNGS,
                mutable=["stats", "intermediates"],
                capture_intermediates=lambda mdl, _: isinstance(mdl,
                                                                JNoise))
            return loss, (metrics, mutated)

        self.value_and_grad = fast_jit(jax.value_and_grad(loss_fn,
                                                          has_aux=True))
        self.first = self.loss_and_grads(self.variables)

    def loss_and_grads(self, variables):
        """(loss, metrics, gradients, updated stats); keeps the noise."""
        others = {k: v for k, v in variables.items() if k != "params"}
        (loss, (metrics, mutated)), grads = self.value_and_grad(
            variables["params"], others, self.x, self.f0)
        self.noise = np.array(mutated.pop("intermediates")["decoder"]
                              ["noise_generator"]["__call__"][0].data)
        return float(loss), {k: float(v) for k, v in metrics.items()}, \
            grads, mutated


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_step(request):
    return JaxStep(request.param)


@pytest.fixture(scope="module")
def v1_reference():
    """golf_tpu's golf-v1 task and its seeded variables (the init on
    ``batch()``)."""
    task = jvoc.build_ddsp_vocoder(j_cfg("golf-v1"))
    return task, jax_variables(task, *batch())


def port_task(case, variables, mode="train"):
    task = tvoc.build_ddsp_vocoder(case_cfg(t_cfg, case), device="cpu")
    load_flax_variables(task, np_tree(variables))
    task.train(mode == "train")
    return task


def port_loss(task, step, dtype=torch.float32):
    def sig(a):
        return TSig(torch.from_numpy(a).to(dtype), 1)
    return task.training_step(sig(step.x), sig(step.f0),
                              noise=torch.from_numpy(step.noise).to(dtype))


def test_training_step_matches_golf_tpu(jax_step, monkeypatch):
    """The loss and its metrics within 1e-5 relative and the clip's global
    norm within 1e-4 of golf_tpu's. Every trainable parameter's gradient
    within 1e-3 of its max-abs of golf_tpu's, except on the recipe's path
    where the voicing's gradient reaches the phase: through the phase of a
    wavetable the gradient sums long oscillating terms that nearly cancel,
    and both sides' float32 gradients stray from the float64 one (a
    float64 run of the port) by more than 1e-3 of its max-abs (measured
    5.1e-3 for the port and 6.6e-3 for golf_tpu here). There each of the
    port's gradients (and the global norm) is held within 1e-3 of the
    float64 one, or within twice golf_tpu's own distance from it: two
    float32 evaluations of the same sum, whose rounding differs run to run
    by a factor of about one. When the phase needs a gradient the lookup
    runs its residual forward (B3a's plain twin), else the plain one
    (B1's)."""
    loss_j, metrics_j, grads_j, _ = jax_step.first
    calls = {"fwd": 0, "res": 0}

    def counted(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run

    monkeypatch.setattr(tlk, "PLAIN_OPS", tlk.LookupOps(
        counted("fwd", tlk.lookup_blocks_plain),
        counted("res", tlk.lookup_res_plain), tlk.lookup_dtab_plain))
    task = port_task(jax_step.case, jax_step.variables)
    loss, metrics = port_loss(task, jax_step)
    loss.backward()
    assert abs(loss.item() - loss_j) <= LOSS_TOL * abs(loss_j)
    assert set(metrics) == set(metrics_j) == {
        "loss", "l1_loss", "f0_loss", "voicing_loss"}
    for k, v in metrics_j.items():
        assert abs(metrics[k].item() - v) <= LOSS_TOL * abs(v), k
    expect = {"golf-v1": (0, 1), "golf-v1/detach_voicing": (1, 0),
              "ddsp": (0, 0)}[jax_step.case]
    assert (calls["fwd"], calls["res"]) == expect

    ref = flax_to_state_dict({"params": np_tree(grads_j)})
    named = dict(task.named_parameters())
    trainable = {k for k, p in named.items() if p.requires_grad}
    assert trainable == {k for k in ref
                         if not k.split(".")[-1].startswith("bias_ih")}
    if jax_step.case == "golf-v1":
        task64 = port_task(jax_step.case, jax_step.variables).double()
        port_loss(task64, jax_step, torch.float64)[0].backward()
        exact = dict(task64.named_parameters())
        for k in sorted(trainable):
            g64 = exact[k].grad.numpy()
            scale = np.abs(g64).max()
            err = np.abs(named[k].grad.numpy() - g64).max() / scale
            err_j = np.abs(ref[k].numpy() - g64).max() / scale
            assert err <= max(GRAD_TOL, 2 * err_j), (k, err, err_j)
    else:
        for k in sorted(trainable):
            within(named[k].grad, ref[k], GRAD_TOL, k)
    def norm(m):
        return float(torch.sqrt(sum(torch.sum(p.grad.double() ** 2)
                                    for p in trainable_parameters(m))))

    norm_t, norm_j = norm(task), float(optax.global_norm(grads_j))
    if jax_step.case == "golf-v1":
        norm_64 = norm(task64)
        assert abs(norm_t - norm_64) <= max(1e-4 * norm_64,
                                            2 * abs(norm_j - norm_64))
    else:
        assert abs(norm_t - norm_j) <= 1e-4 * norm_j


def port_adam_losses(task, step, dtype=torch.float32):
    opt = ClippedOptimizer(trainable_parameters(task), lr=LR, grad_clip=0.5)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss, _ = port_loss(task, step, dtype)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return np.array(losses)


def test_adam_trajectory_tracks_golf_tpu(jax_step):
    """Three Adam steps with the 0.5 global-norm clip from the same weights,
    on the same batch and noise: each step's loss within 1e-4 relative of
    golf_tpu's. On the recipe's path Adam's normalised steps carry the
    float32 noise of the phase's gradient into the weights (the third loss
    of the two float32 runs measured 1e-3 apart): there each loss is held
    within 1e-4 of a float64 run of the port, or within twice golf_tpu's
    distance from it."""
    tx = make_optimizer(lr=LR, grad_clip=0.5)
    variables = dict(jax_step.variables)
    opt_state = tx.init(variables["params"])
    losses_j = []
    for i in range(3):
        loss, _, grads, mutated = jax_step.first if i == 0 else \
            jax_step.loss_and_grads(variables)
        losses_j.append(loss)
        updates, opt_state = tx.update(grads, opt_state, variables["params"])
        variables = {**variables, **mutated,
                     "params": optax.apply_updates(variables["params"],
                                                   updates)}

    losses_t = port_adam_losses(port_task(jax_step.case,
                                          jax_step.variables), jax_step)
    assert losses_t[2] != losses_t[0]
    if jax_step.case == "golf-v1":
        losses_64 = port_adam_losses(port_task(
            jax_step.case, jax_step.variables).double(), jax_step,
            torch.float64)
        bound = np.maximum(1e-4 * np.abs(losses_64),
                           2 * np.abs(np.array(losses_j) - losses_64))
        assert (np.abs(losses_t - losses_64) <= bound).all(), (
            losses_t, losses_j, losses_64)
    else:
        np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)


def jax_predict(task, variables, x):
    """golf_tpu's predict_step (jitted, noise key 0 as its CLI draws it) and
    the noise it drew."""
    y, state = fast_jit(lambda v, x_: task.apply(
        v, JSig(x_, 1), rngs={"noise": jax.random.key(0),
                              "dropout": jax.random.key(0)},
        mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise),
        method=lambda m, xs: m.predict_step(xs)[0].data))(
            variables, jnp.asarray(x))
    noise = np.array(state["intermediates"]["decoder"]["noise_generator"]
                     ["__call__"][0].data)
    return np.asarray(y), noise


def port_predict(task, x, noise):
    with torch.inference_mode():
        y, _ = task.predict_step(TSig(torch.from_numpy(x), 1),
                                 noise=torch.from_numpy(noise))
    return y.data.numpy()


def test_predict_step_matches_golf_tpu(jax_step):
    """One batch in eval mode, the log-mel min/max of golf_tpu's init:
    within PREDICT_TOL of max|y|."""
    y_j, noise = jax_predict(jax_step.task, jax_step.variables, jax_step.x)
    task = port_task(jax_step.case, jax_step.variables, mode="eval")
    y_t = port_predict(task, jax_step.x, noise)
    assert y_t.shape == y_j.shape and np.isfinite(y_t).all()
    within(y_t, y_j, PREDICT_TOL, jax_step.case)


def test_chunked_ola_identity_matches_golf_tpu():
    """With an identity resynthesis the OLA gives back its input, and the
    port's host numpy equals golf_tpu's bit for bit."""
    x = np.random.default_rng(0).standard_normal(14200).astype(np.float32)
    ref = jvoc.chunked_ola_predict(lambda fr: fr, x, 1000)
    got = tvoc.chunked_ola_predict(lambda fr: fr, x, 1000)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, x, atol=1e-5)


def test_chunked_ola_of_the_model_matches_golf_tpu(v1_reference):
    """golf-v1 on one 14 s utterance: three 6 s chunks through each side's
    predict_step (the same weights and noise), crossfaded over 0.3 s;
    within PREDICT_TOL of max|y|, with the input's length."""
    x, f0 = batch(1, 14.0, seed=6)
    task_j, variables = v1_reference
    captured = {}

    def apply_j(frames):
        y, captured["noise"] = jax_predict(task_j, variables, frames)
        return y

    ref = jvoc.chunked_ola_predict(apply_j, x, SR)
    assert captured["noise"].shape[0] == 3
    task = port_task("golf-v1", variables, mode="eval")
    got = tvoc.chunked_ola_predict(
        lambda fr: port_predict(task, fr, captured["noise"]), x, SR)
    assert got.shape == ref.shape == (x.shape[-1],)
    within(got, ref, PREDICT_TOL, "ola")


def test_run_vocoder_test_matches_golf_tpu(v1_reference):
    """The test split of ``Synthetic`` (4 items of 0.5 s in 2 batches of
    2), the same weights; the port's run is given golf_tpu's noise (its
    key 0, the same every batch): the MSS within 1e-5 relative and the
    cents MAE of the re-estimated f0 within 1e-6 relative."""
    task_j, variables = v1_reference
    dm_args = dict(batch_size=2, n_items=4, duration=0.5)
    ref = jvoc.run_vocoder_test(task_j, variables, JSynthetic(**dm_args), SR,
                                240, task_j.criterion)
    dm = TSynthetic(**dm_args)
    dm.setup("test")
    noises = [torch.from_numpy(jax_predict(task_j, variables, x)[1])
              for x, _ in dm.test_dataloader()]
    assert len(noises) == 2
    task = port_task("golf-v1", variables)
    got = tvoc.run_vocoder_test(task, dm, noises)
    assert task.training
    assert set(got) == set(ref) == {"avg_mss_loss", "avg_f0_loss"}
    assert abs(got["avg_mss_loss"] - ref["avg_mss_loss"]) <= \
        1e-5 * abs(ref["avg_mss_loss"])
    assert abs(got["avg_f0_loss"] - ref["avg_f0_loss"]) <= \
        1e-6 * abs(ref["avg_f0_loss"])


def test_inverse_target_raises():
    cfg = t_cfg("golf-v1")
    cfg["inverse_target"] = True
    with pytest.raises(NotImplementedError, match="inverse_target"):
        tvoc.build_ddsp_vocoder(cfg, device="cpu")


def test_converted_vocoder_checkpoint_predicts_as_the_bridge(
        tmp_path, v1_reference):
    """A golf_tpu vocoder's orbax checkpoint (golf-v1, Adam state) through
    ``tools/orbax_to_torch.py``, restored params-only into the port's
    DDSPVocoder, predicts exactly as the bridged variables do."""
    x, _ = batch()
    variables = v1_reference[1]
    params = variables["params"]
    state = TrainState(params, make_optimizer(1e-4, 0.5).init(params),
                       variables["stats"], variables["batch_stats"], 5)
    CheckpointManager(str(tmp_path / "ckpt")).save_last(state)
    dst = str(tmp_path / "port.pt")
    assert _tool().convert(str(tmp_path / "ckpt" / "last"), dst) == 5
    task = tvoc.build_ddsp_vocoder(t_cfg("golf-v1"), device="cpu")
    Trainer(task, run_dir=str(tmp_path / "run")).restore(dst,
                                                         params_only=True)
    task.eval()
    bridged = port_task("golf-v1", variables, mode="eval")
    outs = []
    for t in (task, bridged):
        with torch.inference_mode():
            y, _ = t.predict_step(TSig(torch.from_numpy(x), 1),
                                  generator=torch.Generator().manual_seed(2))
        outs.append(y.data.numpy())
    assert np.isfinite(outs[0]).all()
    np.testing.assert_array_equal(*outs)


# ---------------------------------------------------------------------------
# main_torch.py
# ---------------------------------------------------------------------------

CLI_ARGS = ["--model", "cfg/ae/decoder/golf-v1.yaml", "--device", "cpu",
            "data.class_path=ltng.data.Synthetic",
            "data.init_args.n_items=4", "data.init_args.duration=0.5",
            "data.init_args.batch_size=2",
            "model.init_args.encoder_init_args.hidden_channels=16",
            "model.init_args.encoder_init_args.num_layers=1"]


def cli(argv):
    from golf_tpu_torch.tasks.cli import run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run(argv, default_config="cfg/vocoder.yaml") == 0
    return out.getvalue().strip().splitlines()


def test_main_torch_fit_validate_test_predict(tmp_path):
    """``fit`` 2 steps of cfg/vocoder.yaml + golf-v1 on Synthetic data
    (``main_torch.py`` in its own process), then ``validate`` of its
    checkpoint reproduces the fit's last val_loss, ``test`` prints finite
    ``avg_mss_loss`` and ``avg_f0_loss`` and ``predict`` writes one wav per
    test item."""
    run_dir = tmp_path / "fit"
    done = subprocess.run(
        [sys.executable, "main_torch.py", "fit", *CLI_ARGS,
         "trainer.max_steps=2", "--run_dir", str(run_dir)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    recs = [json.loads(ln) for ln in open(run_dir / "metrics.jsonl")]
    fit_val = [r["val_loss"] for r in recs if "val_loss" in r][-1]
    assert np.isfinite(fit_val)
    ckpt = ["--ckpt_path", str(run_dir / "ckpt" / "last")]

    val = json.loads(cli(["validate", *CLI_ARGS, *ckpt, "--run_dir",
                          str(tmp_path / "v")])[-1])
    assert val["val_loss"] == fit_val
    assert {"val_l1_loss", "val_f0_loss", "val_voicing_loss"} <= set(val)

    test = json.loads(cli(["test", *CLI_ARGS, *ckpt, "--run_dir",
                           str(tmp_path / "t")])[-1])
    assert set(test) == {"avg_mss_loss", "avg_f0_loss"}
    assert all(np.isfinite(v) for v in test.values())

    cli(["predict", *CLI_ARGS, *ckpt, "--run_dir", str(tmp_path / "p")])
    wavs = sorted(os.listdir(tmp_path / "p" / "predictions"))
    assert wavs == [f"item{i:04d}.wav" for i in range(4)]
    from golf_tpu_torch.utils.wav import read_wav
    y, sr = read_wav(str(tmp_path / "p" / "predictions" / wavs[0]))
    assert sr == SR and y.shape == (12000,) and np.isfinite(y).all()


def test_main_torch_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    args = [a for a in CLI_ARGS if a not in ("--device", "cpu")]
    done = subprocess.run(
        [sys.executable, "main_torch.py", "fit", *args, "--run_dir",
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert done.returncode != 0
    assert "device='cpu'" in done.stderr

