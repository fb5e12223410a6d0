"""The port's training slice against golf_tpu, on the CPU.

* ``VoiceAutoEncoder.training_step``: the loss and every parameter's
  gradient against ``jax.value_and_grad`` of golf_tpu's, for the GOLF-ff
  (``golf.yaml``; GOLF-ss, ``golf-precise.yaml``, in
  ``test_torch_train_ss.py``) decoder on the
  ``cfg/ae/synthetic.yaml`` encoder, B = 2 x 0.5 s, f0 voiced everywhere
  (so the random f0 of unvoiced frames plays no part), the same weights
  (through ``bridge``) and the same noise (captured from JAX);
* three Adam steps with the clip against golf_tpu's ``make_optimizer``;
* the three repairs of the encoder (the LSTM's second bias, BatchNorm's
  running variance, the ``train`` flag against the module's mode);
* ``ClippedOptimizer`` against optax on toy tensors, checkpoints and the
  ``fit``/``validate`` CLI, and the port's import rule.
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from golf_tpu.config.registry import load_config as j_load_config
from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models.noise import StandardNormalNoise as JNoise
from golf_tpu.tasks.ae import build_voice_autoencoder as j_build
from golf_tpu.tasks.data import SyntheticVoiceDataset
from golf_tpu.train.loop import make_optimizer
from golf_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from golf_tpu_torch.config.registry import load_config as t_load_config
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.tasks.ae import build_voice_autoencoder as t_build
from golf_tpu_torch.train.loop import (ClippedOptimizer, global_norm,
                                       trainable_parameters)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3       # ten times vctk's, so that three steps move the loss


def _model_cfg(loader, decoder, **encoder_args):
    cfg = loader("cfg/ae/synthetic.yaml")
    dec = loader(f"cfg/ae/decoder/{decoder}.yaml")
    cfg = {**cfg["model"]["init_args"], "decoder": dec["decoder"]}
    cfg["encoder_init_args"] = {**cfg["encoder_init_args"], **encoder_args}
    return cfg


def _t_cfg(decoder, **encoder_args):
    return _model_cfg(lambda p: t_load_config([p]), decoder, **encoder_args)


def _batch(n=2, seconds=0.5):
    """Synthetic items with f0 voiced everywhere (130 Hz in the gaps), plus
    white noise at -30 dB of full scale. Without it most spectrogram bins
    are near silent, and the encoder's log amplifies the two FFT
    libraries' fp32 rounding there: the first conv layer's gradient then
    differs by ~1e-2, and by ~1e-5 when the port's spectrogram is taken in
    fp64."""
    ds = SyntheticVoiceDataset(n, seconds, 24000, seed=3)
    items = [ds[i] for i in range(n)]
    x = np.stack([x for x, _ in items])
    x = x + 0.03 * np.random.default_rng(11).standard_normal(x.shape)
    f0 = np.stack([f for _, f in items])
    return (x.astype(np.float32),
            np.where(f0 > 0, f0, 130.0).astype(np.float32))


def _seeded_params(params, seed=5, scale=0.1):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * scale), params)


def _jax_init(task, x, f0):
    """golf_tpu's Trainer.init_state: a train-mode training_step init on
    the first batch (sets the running min/max)."""
    return dict(jax.jit(lambda x_, f0_: task.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1),
         "dropout": jax.random.key(2)}, JSig(x_, 1), JSig(f0_, 1), True,
        method=lambda m, *a: m.training_step(*a)))(x, f0))


def _train_apply(task, variables, x, f0, rngs, **kw):
    return task.apply(variables, JSig(x, 1), JSig(f0, 1), True, rngs=rngs,
                      method=lambda m, *a: m.training_step(*a), **kw)


RNGS = {"noise": jax.random.key(3), "dropout": jax.random.key(4)}


class JaxStep:
    """golf_tpu's training step for one decoder: its loss and gradients
    (``jax.value_and_grad``), the noise it drew, and golf_tpu's Adam."""

    def __init__(self, decoder):
        self.x, self.f0 = _batch()
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

        # eagerly: XLA:CPU takes tens of minutes to jit the GOLF decoders'
        # gradient, and builds at a lower optimisation level gave conv
        # pyramid gradients that differ from the eager ones (and NaN); the
        # eager primitives compile in ~100 s
        self.value_and_grad = jax.value_and_grad(loss_fn, has_aux=True)

    def loss_and_grads(self, variables):
        others = {k: v for k, v in variables.items() if k != "params"}
        (loss, mutated), grads = self.value_and_grad(
            variables["params"], others, self.x, self.f0)
        return float(loss), grads, mutated


def make_jax_step(decoder):
    """golf_tpu's step for ``decoder``, with its first loss and
    gradients."""
    step = JaxStep(decoder)
    step.decoder = decoder
    step.first = step.loss_and_grads(step.variables)
    return step


@pytest.fixture(scope="module")
def jax_step():
    """GOLF-ff here; GOLF-ss in test_torch_train_ss.py, so that the two
    slow JAX references run on two test workers."""
    return make_jax_step("golf")


def _port_task(step):
    task = t_build(_t_cfg(step.decoder), device="cpu")
    load_flax_variables(task, jax.tree_util.tree_map(np.asarray,
                                                     step.variables))
    task.train()
    return task


def _port_loss(task, step):
    loss, _ = task.training_step(
        TSig(torch.from_numpy(step.x), 1), TSig(torch.from_numpy(step.f0), 1),
        noise=torch.from_numpy(step.noise))
    return loss


def test_training_step_matches_golf_tpu(jax_step):
    check_training_step(jax_step)


def test_adam_trajectory_tracks_golf_tpu(jax_step):
    check_adam_trajectory(jax_step)


def check_training_step(jax_step):
    loss_j, grads_j, _ = jax_step.first
    task = _port_task(jax_step)
    loss = _port_loss(task, jax_step)
    loss.backward()
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)

    ref = flax_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, grads_j)})
    named = dict(task.named_parameters())
    trainable = {k for k, p in named.items() if p.requires_grad}
    assert trainable == {k for k in ref if not k.split(".")[-1].startswith(
        "bias_ih")}
    # fp32 on both sides through the BiLSTM, two FFT libraries and the
    # all-pole filters' blocked forms, in other summation orders: every
    # gradient within 1e-3 of its own largest entry. The conv biases in
    # front of a train-mode batch norm have a zero gradient in exact
    # arithmetic and hold rounding noise on both sides: they are held to
    # 1e-4 of their conv weight's gradient instead.
    for k in sorted(trainable):
        g, r = named[k].grad.numpy(), ref[k].numpy()
        scale = np.abs(r).max()
        if ".pyramid.convs." in k and k.endswith(".bias"):
            scale = 10 * np.abs(ref[k[:-4] + "weight"].numpy()).max()
        assert scale > 0, k
        assert np.abs(g - r).max() <= 1e-3 * scale, (
            k, np.abs(g - r).max() / scale)
    # the clip sees the same global norm (the LSTM's bias_ih is not in it)
    norm_t = global_norm(p.grad for p in trainable_parameters(task)).item()
    norm_j = float(optax.global_norm(grads_j))
    assert abs(norm_t - norm_j) <= 1e-4 * norm_j


def check_adam_trajectory(jax_step):
    """Three steps of Adam with the 0.5 global-norm clip, from the same
    weights, on the same batch and noise."""
    tx = make_optimizer(lr=LR, grad_clip=0.5)
    variables = dict(jax_step.variables)
    opt_state = tx.init(variables["params"])
    losses_j = []
    for i in range(3):
        loss, grads, mutated = jax_step.first if i == 0 else \
            jax_step.loss_and_grads(variables)
        losses_j.append(loss)
        updates, opt_state = tx.update(grads, opt_state, variables["params"])
        variables = {**variables, **mutated,
                     "params": optax.apply_updates(variables["params"],
                                                   updates)}

    task = _port_task(jax_step)
    opt = ClippedOptimizer(trainable_parameters(task), lr=LR, grad_clip=0.5)
    losses_t = []
    for _ in range(3):
        opt.zero_grad()
        loss = _port_loss(task, jax_step)
        loss.backward()
        opt.step()
        losses_t.append(loss.item())
    assert losses_t[2] != losses_t[0]
    # each step's loss within 1e-4 relative: 1e-5 at the first step, and
    # Adam's normalised steps carry the gradients' 1e-3 differences into
    # the weights
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)


# ---------------------------------------------------------------------------
# The three repairs of the encoder
# ---------------------------------------------------------------------------

def _jax_variables(decoder="golf", seconds=0.5, scale=0.1, n=2,
                   **encoder_args):
    x, f0 = _batch(n, seconds)
    task = j_build(_model_cfg(j_load_config, decoder, **encoder_args))
    v = _jax_init(task, x, f0)
    return task, {**v, "params": _seeded_params(v["params"], scale=scale)}, \
        x, f0


def test_trainable_parameters_match_golf_tpu_params():
    """flax's LSTM cell has one bias: the port trains exactly the
    parameters golf_tpu has (``bias_ih`` stays zero and frozen)."""
    _, variables, _, _ = _jax_variables()
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(variables["params"]))
    task = t_build(_t_cfg("golf"), device="cpu")
    assert sum(p.numel() for p in trainable_parameters(task)) == n_jax
    frozen = [n for n, p in task.named_parameters() if not p.requires_grad]
    assert frozen and all(n.split(".")[-1].startswith("bias_ih")
                          for n in frozen)
    assert all(not p.any() for n, p in task.named_parameters()
               if n in frozen)


def _encoder_apply(task, variables, x, f0, train):
    return task.apply(variables, JSig(x, 1), f0=JSig(f0, 1), train=train,
                      method=lambda m, x_, f0, train: m.encoder(
                          x_, f0=f0, train=train),
                      mutable=["stats", "batch_stats"])


def test_batchnorm_running_stats_match_golf_tpu():
    """After one train-mode forward the running mean and variance equal
    flax's, which averages the biased batch variance. A 64-point FFT and
    one item of 720 samples (3 frames) leave the batch norms 99 and 24
    elements a channel: n/(n-1) would move the running variances by ~1e-4
    to ~4e-4 relative, and fp32 sums this short round alike on both
    sides."""
    task_j, variables, x, f0 = _jax_variables(seconds=0.03, n=1, n_fft=64)
    _, mutated = jax.jit(lambda v, x_, f_: _encoder_apply(
        task_j, v, x_, f_, True))(variables, x, f0)
    task = t_build(_t_cfg("golf", n_fft=64), device="cpu")
    load_flax_variables(task, jax.tree_util.tree_map(np.asarray, variables))
    task.train()
    task.encoder(TSig(torch.from_numpy(x), 1), f0=TSig(torch.from_numpy(f0),
                                                        1), train=True)
    stats = mutated["batch_stats"]["encoder"]["backbone"]["ConvPyramid_0"]
    for i, norm in enumerate(task.encoder.backbone.pyramid.norms):
        bn = stats[f"BatchNorm_{i}"]
        np.testing.assert_allclose(norm.running_var.numpy(),
                                   np.asarray(bn["var"]), rtol=1e-6)
        np.testing.assert_allclose(norm.running_mean.numpy(),
                                   np.asarray(bn["mean"]), rtol=1e-6,
                                   atol=1e-9)


def test_train_flag_drives_the_encoder_like_golf_tpu():
    """``train`` and the module's mode must agree (golf_tpu drives the
    batch norms, the dropout and the running min/max from ``train``); in
    each mode the encoder matches golf_tpu's."""
    task_j, variables, x, f0 = _jax_variables()
    task = t_build(_t_cfg("golf"), device="cpu")
    load_flax_variables(task, jax.tree_util.tree_map(np.asarray, variables))
    xs, f0s = TSig(torch.from_numpy(x), 1), TSig(torch.from_numpy(f0), 1)
    for train in (False, True):
        task.train(not train)
        with pytest.raises(ValueError, match="mode"):
            task.encoder(xs, f0=f0s, train=train)
        task.train(train)
        with torch.no_grad():
            out = task.encoder(xs, f0=f0s, train=train)
        ref, _ = jax.jit(lambda v, x_, f_: _encoder_apply(
            task_j, v, x_, f_, train))(variables, x, f0)
        for key, group in ref.items():
            for r_sig, t_sig in zip(group, out[key]):
                r, o = np.asarray(r_sig.data), t_sig.data.numpy()
                # 1e-4 of the largest entry: fp32 BiLSTM and batch norms
                assert np.abs(o - r).max() <= 1e-4 * np.abs(r).max(), (
                    key, train)


# ---------------------------------------------------------------------------
# Optimizer, checkpoints, CLI, rules
# ---------------------------------------------------------------------------

def test_clipped_adam_matches_optax():
    """Adam, the global-norm clip and the skip of non-finite updates, on
    toy tensors, against optax's chain (golf_tpu's make_optimizer)."""
    r = np.random.default_rng(0)
    shapes = [(3, 4), (5,)]
    p0 = [r.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[r.standard_normal(s).astype(np.float32) * scale
              for s in shapes] for scale in (0.01, 3.0, 0.1, 2.0)]
    grads.insert(2, [np.full(s, np.nan, np.float32) for s in shapes])
    tx = make_optimizer(lr=0.01, grad_clip=0.5)
    params_j = [jnp.asarray(p) for p in p0]
    state = tx.init(params_j)
    params_t = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = ClippedOptimizer(params_t, lr=0.01, grad_clip=0.5)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, params_j)
        params_j = optax.apply_updates(params_j, upd)
        for p, a in zip(params_t, g):
            p.grad = torch.from_numpy(a.copy())
        info = opt.step()
        assert bool(info["update_applied"]) == bool(np.isfinite(g[0]).all())
        for p, q in zip(params_t, params_j):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       rtol=1e-6, atol=1e-7)


def test_clipped_adam_applies_after_100_skips():
    p = torch.nn.Parameter(torch.ones(2))
    opt = ClippedOptimizer([p], lr=0.1, grad_clip=0.5)
    for i in range(100):
        p.grad = torch.full((2,), float("nan"))
        assert not bool(opt.step()["update_applied"])
    p.grad = torch.full((2,), float("nan"))
    assert bool(opt.step()["update_applied"])
    assert torch.isnan(p).all()


FIT_ARGS = ["--config", "cfg/ae/synthetic.yaml", "--model",
            "cfg/ae/decoder/golf.yaml", "--device", "cpu",
            "data.init_args.n_items=4", "data.init_args.duration=0.3",
            "data.init_args.batch_size=2", "trainer.max_steps=2"]


def test_fit_then_validate_reproduces_val_loss(tmp_path):
    from golf_tpu_torch.tasks.cli import run
    from golf_tpu_torch.train.checkpoint import load
    run_dir = str(tmp_path / "run")
    assert run(["fit", *FIT_ARGS, "--run_dir", run_dir]) == 0
    recs = [json.loads(ln) for ln in open(os.path.join(run_dir,
                                                       "metrics.jsonl"))]
    fit_val = [r["val_loss"] for r in recs if "val_loss" in r][-1]
    assert np.isfinite(fit_val)
    ckpt = tmp_path / "run" / "ckpt"
    assert (ckpt / "last").exists()
    assert (ckpt / f"step=2-val_loss={fit_val:.3f}").exists()
    assert (tmp_path / "run" / "config.yaml").exists()
    assert load(str(ckpt / "last"))["step"] == 2

    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run(["validate", *FIT_ARGS, "--run_dir", str(tmp_path / "v"),
                    "--ckpt_path", str(ckpt / "last")]) == 0
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    assert got["val_loss"] == fit_val


def test_fit_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from golf_tpu_torch.tasks.cli import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in FIT_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(["fit", *args, "--run_dir", str(tmp_path)])


def test_port_sources_import_neither_jax_nor_golf_tpu():
    """Every module of golf_tpu_torch (loss/ and train/ included),
    chip_smoke.py and the root entry points autoencode_torch.py and
    main_torch.py, read as source: no import of jax, flax, optax or
    golf_tpu."""
    banned = ("jax", "flax", "optax", "golf_tpu")
    pkg = os.path.join(ROOT, "golf_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")] + [
                 os.path.join(ROOT, name) for name in
                 ("chip_smoke.py", "autoencode_torch.py", "main_torch.py")]
    assert any("/train/" in f for f in files)
    assert any("/loss/" in f for f in files)
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
