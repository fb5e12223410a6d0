"""The LPCNet vocoder of the port (``cfg/lpcnet.yaml``) against golf_tpu's,
on the CPU, at the narrow widths of ``tests/test_tasks.py``'s LPCNet tests
(24 mels at n_fft 512, a 32-wide Mel2Control, Q = 64, condition 64, GRUs
of 24 and 8, LPC order 8, 256-sample LPC frames; B = 2 x 480 samples):

* ``levinson``, ``lpc2rc``, ``rc2lar``, ``lar2rc`` and ``lpc_from_frames``
  (with a near-silent frame) within 1e-5 of max-abs;
* the mu-law pair, ``InterpolatedEmbedding`` (forward and the table's
  gradient), ``SampleNet`` teacher-forced and one ``sample_forward`` step,
  within 1e-5;
* ``preemphasis`` and ``deemphasis`` within 1e-5 of max|y|;
* ``_prepare``'s six outputs; ``training_step``'s loss and metrics within
  1e-5 relative and every gradient within 1e-3 of its max-abs, with the
  same teacher-forcing noise (golf_tpu's loss composed from its module's
  methods around that noise); three steps of the recipe's amsgrad within
  1e-4 relative of golf_tpu's optimizer;
* ``generate`` against a loop over golf_tpu's ``sample_forward`` with the
  same Gumbel draws, within 1e-5 of max|y|; the draws of the port's
  sampler follow softmax(logits * temperature) (chi-square);
* ``LPCFrameNet`` and ``WN`` forward;
* ``run_lpcnet_test``'s metrics, and ``main_torch.py fit`` (2 steps),
  ``validate`` and ``test`` from a miniature LJSpeech tree with ``--device
  cpu``; ``predict`` raises, as golf_tpu's has no ``predict_step``; without
  ``--device`` and without a card the CLI refuses.

Inputs come from numpy seeds; weights cross through ``bridge``.
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
import pytest
import torch
from scipy import stats

from golf_tpu.config.registry import load_config as j_load_config
from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models import lpcnet as jlpc
from golf_tpu.models import mel as jmel
from golf_tpu.ops import cepstrum as jcep
from golf_tpu.ops import dsp as jdsp
from golf_tpu.tasks import lpcnet as jtask
from golf_tpu.tasks.data import SyntheticVoiceDataset
from golf_tpu.utils.wav import write_wav
from golf_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from golf_tpu_torch.config.registry import load_config as t_load_config
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.models import lpcnet as tlpc
from golf_tpu_torch.models import mel as tmel
from golf_tpu_torch.ops import cepstrum as tcep
from golf_tpu_torch.ops import dsp as tdsp
from golf_tpu_torch.tasks import lpcnet as ttask
from golf_tpu_torch.tasks.data import Synthetic as TSynthetic
from tests.test_torch_vocoder import fast_jit, np_tree, seeded, within

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 24000
T = 480
Q = 64
ORDER = 8
TOL = 1e-5            # of max-abs (relative for the loss)
GRAD_TOL = 1e-3       # of each gradient's max-abs
TEMPERATURE = 2.0


def model_cfg(loader):
    """``cfg/lpcnet.yaml``'s model.init_args at the narrow widths."""
    cfg = loader("cfg/lpcnet.yaml")["model"]["init_args"]
    cfg["frame_decoder"]["init_args"].update(in_channels=24,
                                             hidden_channels=32)
    cfg["feature_trsfm"]["init_args"].update(n_fft=512, n_mels=24)
    cfg["sample_decoder"]["init_args"].update(
        quantization_channels=Q, condition_channels=64, a_channels=24,
        b_channels=8)
    # the reference's spelling of the LPC frame length
    cfg.update(lpc_order=ORDER, quantization_channels=Q,
               lpc_frame_lengeth=256)
    return cfg


def batch(n=2, t=T, seed=3):
    """Synthetic voices plus white noise at -30 dB of full scale (no mel bin
    near silent)."""
    ds = SyntheticVoiceDataset(n, t / SR, SR, seed=seed)
    x = np.stack([ds[i][0] for i in range(n)])
    x = x + 0.03 * np.random.default_rng(11).standard_normal(x.shape)
    f0 = np.stack([ds[i][1] for i in range(n)])
    return x.astype(np.float32), f0.astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """golf_tpu's task and its variables: the init on ``batch()`` (which
    sets the log-mel min/max), every parameter then seeded, the frame net's
    zero-initialised head included."""
    task = jtask.build_lpcnet_vocoder(model_cfg(j_load_config))
    x, f0 = batch()
    v = dict(fast_jit(lambda x_, f0_: task.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1),
         "dropout": jax.random.key(2)}, JSig(x_, 1), JSig(f0_, 1), True,
        method=lambda m, *a: m.training_step(*a)))(jnp.asarray(x),
                                                   jnp.asarray(f0)))
    return task, {**v, "params": seeded(v["params"])}


def port_task(variables, train=True):
    task = ttask.build_lpcnet_vocoder(model_cfg(lambda p: t_load_config([p])),
                                      device="cpu")
    load_flax_variables(task, np_tree(variables))
    return task.train(train)


# ---------------------------------------------------------------------------
# LPC analysis
# ---------------------------------------------------------------------------

def lpc_frames():
    """Five 256-sample frames: white noise, a noisy two-tone, a decaying
    resonance, a near-silent frame (1e-4 of full scale) and a silent one
    lifted by the 1e-7 that ``_gt_lar`` adds."""
    rng = np.random.default_rng(7)
    n = np.arange(256)
    frames = np.stack([
        rng.standard_normal(256) * 0.3,
        np.sin(0.21 * n) + 0.5 * np.sin(0.83 * n + 1)
        + 0.05 * rng.standard_normal(256),
        np.exp(-n / 60) * np.sin(0.4 * n) + 0.01 * rng.standard_normal(256),
        1e-4 * rng.standard_normal(256),
        np.full(256, 1e-7)])
    return frames.astype(np.float32)


def test_lpc_from_frames_and_levinson_match_golf_tpu():
    """The noise frame, the near-silent and the silent one within 1e-5 of
    max-abs of golf_tpu's. The tonal frames' autocorrelation is
    ill-conditioned: there both packages' float32 LPC stray about 2e-5 from
    a float64 run of the port (the two FFT libraries round differently), so
    the port is held within 1e-5 of that float64 run or within twice
    golf_tpu's distance from it."""
    frames = lpc_frames()
    win = jdsp.get_window_fn("hanning")(256)
    ref = np.asarray(jcep.lpc_from_frames(
        jnp.asarray(frames), ORDER, jnp.asarray(win.astype(np.float32))))
    got = tcep.lpc_from_frames(torch.from_numpy(frames), ORDER,
                               torch.from_numpy(win.astype(np.float32)))
    exact = tcep.lpc_from_frames(torch.from_numpy(frames).double(), ORDER,
                                 torch.from_numpy(win)).numpy()
    for j in (0, 3, 4):
        within(got[j].numpy(), ref[j], TOL, f"frame {j}")
    for j in (1, 2):
        scale = np.abs(exact[j]).max()
        err = np.abs(got[j].numpy() - exact[j]).max() / scale
        err_j = np.abs(ref[j] - exact[j]).max() / scale
        assert err <= max(TOL, 2 * err_j), (j, err, err_j)
    r = np.random.default_rng(8).standard_normal((3, 64)).astype(np.float32)
    r = np.stack([np.correlate(v, v, "full")[63:63 + ORDER + 1] for v in r])
    within(tdsp.levinson(torch.from_numpy(r), ORDER).numpy(),
           np.asarray(jdsp.levinson(jnp.asarray(r), ORDER)), TOL)


@pytest.mark.parametrize("name", ["lpc2rc", "rc2lar", "lar2rc"])
def test_lar_chain_matches_golf_tpu(name):
    """On the LPC of the analysis frames (lpc2rc), on reflection
    coefficients out to +-0.9999 (rc2lar clips at 0.999) and on LAR
    (lar2rc)."""
    rng = np.random.default_rng(9)
    if name == "lpc2rc":
        win = jdsp.get_window_fn("hanning")(256).astype(np.float32)
        arg = np.asarray(jcep.lpc_from_frames(
            jnp.asarray(lpc_frames()), ORDER, jnp.asarray(win)))[:, 1:]
    elif name == "rc2lar":
        arg = np.concatenate([rng.uniform(-0.99, 0.99, (4, ORDER)),
                              [[0.9999, -0.9999, 0.999, -0.5] * 2]])
    else:
        arg = rng.standard_normal((4, ORDER)) * 3
    arg = arg.astype(np.float32)
    ref = np.asarray(getattr(jcep, name)(jnp.asarray(arg)))
    got = getattr(tcep, name)(torch.from_numpy(arg)).numpy()
    within(got, ref, TOL, name)


# ---------------------------------------------------------------------------
# The sample-rate network
# ---------------------------------------------------------------------------

def test_mu_law_pair_matches_golf_tpu():
    x = np.concatenate([np.linspace(-1.2, 1.2, 241),
                        [0.0, 1e-6, -1e-6]]).astype(np.float32)
    enc = np.asarray(jlpc.mu_law_encode_continuous(jnp.asarray(x), Q))
    within(tlpc.mu_law_encode_continuous(torch.from_numpy(x), Q).numpy(),
           enc, TOL, "encode")
    within(tlpc.mu_law_decode_continuous(torch.from_numpy(enc.copy()), Q).numpy(),
           np.asarray(jlpc.mu_law_decode_continuous(jnp.asarray(enc), Q)),
           TOL, "decode")


def test_interpolated_embedding_and_its_table_gradient():
    """Indices inside [0, Q - 1] and outside it (extrapolated); the
    table's gradient of sum(out * g)."""
    rng = np.random.default_rng(10)
    idx = np.concatenate([rng.uniform(0, Q - 1, 200),
                          [-0.7, 0.0, Q - 1.0, Q - 0.4, 17.0]]
                         ).astype(np.float32).reshape(5, 41)
    g = rng.standard_normal((5, 41, Q)).astype(np.float32)
    mod = jlpc.InterpolatedEmbedding(Q, Q)
    params = seeded(mod.init(jax.random.key(0), jnp.asarray(idx)), scale=1.0)
    out, vjp = jax.vjp(lambda p: mod.apply(p, jnp.asarray(idx)), params)
    (dtab,) = vjp(jnp.asarray(g))
    emb = tlpc.InterpolatedEmbedding(Q, Q)
    load_flax_variables(emb, np_tree(params))
    got = emb(torch.from_numpy(idx))
    (got * torch.from_numpy(g)).sum().backward()
    within(got.detach().numpy(), np.asarray(out), TOL, "forward")
    within(emb.embedding.grad.numpy(),
           np.asarray(dtab["params"]["embedding"]), TOL, "table gradient")


def sample_net_inputs(b=2, t=40, c=64, seed=12):
    rng = np.random.default_rng(seed)
    f = np.tanh(rng.standard_normal((b, t, c))).astype(np.float32)
    idx = [rng.uniform(0, Q - 1, (b, t)).astype(np.float32)
           for _ in range(3)]
    return f, idx


@pytest.fixture(scope="module")
def sample_nets():
    f, idx = sample_net_inputs()
    mod = jlpc.SampleNet(Q, 64, 24, 8)
    params = seeded(fast_jit(lambda *a: mod.init(jax.random.key(0), *a))(
        jnp.asarray(f), *map(jnp.asarray, idx)), scale=0.3)
    net = tlpc.SampleNet(Q, 64, 24, 8)
    load_flax_variables(net, np_tree(params))
    return mod, params, net


def test_sample_net_teacher_forced_matches_golf_tpu(sample_nets):
    mod, params, net = sample_nets
    f, idx = sample_net_inputs()
    ref = np.asarray(mod.apply(params, jnp.asarray(f),
                               *map(jnp.asarray, idx)))
    got = net(torch.from_numpy(f), *map(torch.from_numpy, idx))
    within(got.detach().numpy(), ref, TOL)


def test_sample_forward_matches_golf_tpu(sample_nets):
    """Three steps from zero states, each fed its own inputs; the logits
    and both states."""
    mod, params, net = sample_nets
    f, idx = sample_net_inputs()
    states_j, states_t = None, None
    for i in range(3):
        args = [f[:, i]] + [v[:, i] for v in idx]
        logits_j, states_j = mod.apply(
            params, *map(jnp.asarray, args), states_j,
            method=jlpc.SampleNet.sample_forward)
        with torch.no_grad():
            logits_t, states_t = net.sample_forward(
                *map(torch.from_numpy, args), states_t)
        within(logits_t.numpy(), np.asarray(logits_j), TOL, f"step {i}")
        for sj, st in zip(states_j, states_t):
            within(st.numpy(), np.asarray(sj), TOL, f"state {i}")


# ---------------------------------------------------------------------------
# The task
# ---------------------------------------------------------------------------

def test_pre_and_deemphasis_match_golf_tpu():
    x, _ = batch()
    within(ttask.preemphasis(torch.from_numpy(x), 0.85).numpy(),
           np.asarray(jtask.preemphasis(jnp.asarray(x), 0.85)), TOL)
    within(ttask.deemphasis(torch.from_numpy(x), 0.85).numpy(),
           np.asarray(fast_jit(lambda v: jtask.deemphasis(v, 0.85))(
               jnp.asarray(x))), TOL)


def test_build_reads_the_references_key_spelling(reference):
    task = port_task(reference[1])
    assert reference[0].lpc_frame_length == task.lpc_frame_length == 256
    assert task.frame_decoder.out_linear.out_features == 64


@pytest.mark.parametrize("train", [False, True])
def test_prepare_matches_golf_tpu(reference, train):
    """s, f, up_lpc, p, e and lar, eval and train mode."""
    jt, variables = reference
    x, _ = batch()
    ref = jax_prepare(jt, variables, x, train)
    task = port_task(variables, train)
    with torch.no_grad():
        got = task._prepare(torch.from_numpy(x), train)
    for name, g, r in zip(("s", "f", "up_lpc", "p", "e", "lar"), got, ref):
        assert g.shape == r.shape, name
        within(g.numpy(), np.asarray(r), TOL, name)


@pytest.fixture(scope="module")
def jax_value_and_grad(reference):
    """golf_tpu's ``training_step`` composed from its module's methods, with
    the teacher-forcing noise given (its own draws it from the "noise"
    rng): ``_prepare``, the mu-law, ``sample_decoder``, ``interp_loss`` and
    ``_gt_lar``; jitted, (params, x, noise) -> ((loss, metrics), grads)."""
    task, variables = reference
    others = {k: v for k, v in variables.items() if k != "params"}

    def body(m, x, noise):
        q = m.quantization_channels
        s, f, _, p, e, lar = m._prepare(x, True)
        p_mu, e_mu, s_mu = (jlpc.mu_law_encode_continuous(v, q)
                            for v in (p, e, s))
        logits = m.sample_decoder(f[:, 1:], p_mu[:, 1:], s_mu[:, :-1],
                                  e_mu[:, :-1] + noise / q)
        ll, reg = m.interp_loss(e_mu[:, 1:], logits)
        gt = jax.lax.stop_gradient(m._gt_lar(x))
        fmin = min(gt.shape[1], lar.shape[1])
        lar_l2 = jnp.mean((lar[:, :fmin] - gt[:, :fmin]) ** 2)
        loss = -ll + m.gamma * reg + lar_l2
        return loss, {"ll": ll, "reg": reg, "lar_l2": lar_l2, "loss": loss}

    def loss_fn(params, x, noise):
        (loss, metrics), _ = task.apply({**others, "params": params}, x,
                                        noise, method=body,
                                        mutable=["stats"])
        return loss, metrics

    return fast_jit(jax.value_and_grad(loss_fn, has_aux=True))


def step_inputs():
    x, f0 = batch()
    noise = np.random.default_rng(13).standard_normal(
        (x.shape[0], T - 1)).astype(np.float32)
    return x, f0, noise


def test_training_step_matches_golf_tpu(reference, jax_value_and_grad):
    """The loss and metrics within 1e-5 relative, every trainable
    parameter's gradient within 1e-3 of its max-abs, the same N(0, 1)
    noise; the port's ``training_step`` with ``noise=`` is the task's own
    step."""
    variables = reference[1]
    x, f0, noise = step_inputs()
    (loss_j, metrics_j), grads_j = jax_value_and_grad(
        variables["params"], jnp.asarray(x), jnp.asarray(noise))
    task = port_task(variables)
    loss, metrics = task.training_step(
        TSig(torch.from_numpy(x), 1), TSig(torch.from_numpy(f0), 1),
        noise=torch.from_numpy(noise))
    loss.backward()
    assert set(metrics) == set(metrics_j)
    for k, v in metrics_j.items():
        assert abs(metrics[k].item() - float(v)) <= TOL * abs(float(v)), k
    ref = flax_to_state_dict({"params": np_tree(grads_j)})
    named = {k: p for k, p in task.named_parameters() if p.requires_grad}
    assert set(named) == {k for k in ref
                          if not k.split(".")[-1].startswith("bias_ih")}
    for k, p in sorted(named.items()):
        within(p.grad.numpy(), ref[k].numpy(), GRAD_TOL, k)


def test_amsgrad_steps_track_golf_tpu(reference, jax_value_and_grad):
    """Three steps of the recipe's optimizer (amsgrad, lr 1e-3 decayed by
    1 / (1 + 5e-5 step), the 0.5 global-norm clip) from the same weights on
    the same batch and noise: each step's loss within 1e-4 relative of
    golf_tpu's ``make_optimizer`` run."""
    from golf_tpu.train.loop import make_optimizer
    from golf_tpu_torch.train.loop import (ClippedOptimizer,
                                           trainable_parameters)
    variables = reference[1]
    x, f0, noise = step_inputs()
    tx = make_optimizer(lr=1e-3, grad_clip=0.5, optimizer="amsgrad",
                        lr_decay=5e-5)

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params,
                                      updates), state

    params = variables["params"]
    state = tx.init(params)
    losses_j = []
    for _ in range(3):
        (loss, _), grads = jax_value_and_grad(params, jnp.asarray(x),
                                              jnp.asarray(noise))
        losses_j.append(float(loss))
        params, state = update(grads, state, params)
    task = port_task(variables)
    opt = ClippedOptimizer(trainable_parameters(task), lr=1e-3, grad_clip=0.5,
                           optimizer="amsgrad", lr_decay=5e-5)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss, _ = task.training_step(
            TSig(torch.from_numpy(x), 1), TSig(torch.from_numpy(f0), 1),
            noise=torch.from_numpy(noise))
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_training_step_draws_its_noise_from_the_generator(reference):
    """Without ``noise=`` the step draws N(0, 1) from ``generator``: the
    same loss as ``noise=`` that draw."""
    x, f0 = batch()
    task = port_task(reference[1])
    xs, f0s = TSig(torch.from_numpy(x), 1), TSig(torch.from_numpy(f0), 1)
    with torch.no_grad():
        loss, _ = task.training_step(
            xs, f0s, generator=torch.Generator().manual_seed(5))
        noise = torch.randn((2, T - 1),
                            generator=torch.Generator().manual_seed(5))
        again, _ = task.training_step(xs, f0s, noise=noise)
    assert loss.item() == again.item()


def jax_prepare(task, variables, x, train):
    """golf_tpu's ``_prepare`` (jitted)."""
    out, _ = fast_jit(lambda v, x_: task.apply(
        v, x_, train, method=lambda m, *a: m._prepare(*a),
        mutable=["stats"]))(variables, jnp.asarray(x))
    return out


def jax_generate(task, variables, x, gumbel):
    """golf_tpu's ``generate`` loop, one jitted step a sample over its
    ``sample_forward``, with golf_tpu's mu-law and ``deemphasis``, the
    categorical draw replaced by Gumbel-max on the given draws."""
    q = task.quantization_channels
    _, f, up_lpc, _, _, _ = jax_prepare(task, variables, x, False)
    lpc_flip = jnp.flip(up_lpc, -1)

    @jax.jit
    def step(carry, f_t, a_t, g_t):
        s_buf, e_mu, st_a, st_b = carry
        p = -jnp.sum(s_buf * a_t, axis=1)
        logits, (st_a, st_b) = task.apply(
            variables, f_t, jlpc.mu_law_encode_continuous(p, q),
            jlpc.mu_law_encode_continuous(s_buf[:, -1], q), e_mu,
            (st_a, st_b),
            method=lambda m, *a: m.sample_decoder.sample_forward(*a))
        e_mu = jnp.argmax(logits * TEMPERATURE + g_t,
                          axis=-1).astype(jnp.float32)
        pred = jnp.clip(jlpc.mu_law_decode_continuous(e_mu, q) + p, -1, 1)
        s_buf = jnp.concatenate([s_buf[:, 1:], pred[:, None]], axis=1)
        return (s_buf, e_mu, st_a, st_b), pred

    b, t = f.shape[:2]
    net = task.sample_decoder
    carry = (jnp.zeros((b, up_lpc.shape[-1])), jnp.full((b,), (q - 1) * 0.5),
             jnp.zeros((b, net.a_channels)), jnp.zeros((b, net.b_channels)))
    preds = []
    for i in range(t):
        carry, pred = step(carry, f[:, i], lpc_flip[:, i],
                           jnp.asarray(gumbel[:, i]))
        preds.append(pred)
    return np.asarray(fast_jit(lambda y: jtask.deemphasis(y, task.alpha))(
        jnp.stack(preds, axis=1)))


def test_generate_matches_the_golf_tpu_loop(reference):
    """The same Gumbel draws (the port's sampler's) through both loops:
    within 1e-5 of max|y|; the port's B2 route is its plain version
    here. Drawn from the generator instead, the port's loop gives the same
    output."""
    jt, variables = reference
    x, _ = batch()
    # drawn in the order generate draws them, one (B, Q) a step
    gumbel = ttask.gumbel_noise((T, x.shape[0], Q),
                                torch.Generator().manual_seed(14)
                                ).transpose(0, 1)
    ref = jax_generate(jt, variables, x, gumbel.numpy())
    task = port_task(variables, train=False)
    got = task.generate(TSig(torch.from_numpy(x), 1), TEMPERATURE,
                        noise=gumbel)
    assert got.shape == ref.shape == x.shape
    within(got.numpy(), ref, TOL)
    again = task.generate(TSig(torch.from_numpy(x), 1),
                          generator=torch.Generator().manual_seed(14))
    assert torch.equal(again, got)


def test_excitation_draws_follow_softmax_of_scaled_logits():
    """40 000 draws from one row of 8 logits: the counts against
    40 000 * softmax(logits * 2) by chi-square (7 degrees of freedom),
    p > 1e-3; and against softmax(logits), far off (p < 1e-30)."""
    logits = torch.tensor([0.3, -0.5, 1.1, 0.0, 0.8, -1.2, 0.4, 0.6])
    n = 40000
    g = ttask.gumbel_noise((n, 8), torch.Generator().manual_seed(15))
    draws = ttask.sample_excitation(logits.expand(n, 8), TEMPERATURE, g)
    counts = np.bincount(draws.long().numpy(), minlength=8)
    for temp, check in ((TEMPERATURE, lambda p: p > 1e-3),
                        (1.0, lambda p: p < 1e-30)):
        expected = n * torch.softmax(logits.double() * temp, 0).numpy()
        assert check(stats.chisquare(counts, expected).pvalue), temp


@pytest.mark.parametrize("name", ["LPCFrameNet", "WN"])
def test_frame_nets_match_golf_tpu(name):
    """The other frame-rate nets a ``frame_decoder`` may name, with seeded
    weights (WN at depth 7, cycle 3)."""
    rng = np.random.default_rng(16)
    mels = rng.standard_normal((2, 30, 24)).astype(np.float32)
    kw = ({"hidden_channels": 32} if name == "LPCFrameNet" else
          {"residual_channels": 16, "depth": 7, "cycle": 3})
    mod = getattr(jmel, name)(**kw)
    params = seeded(mod.init(jax.random.key(0), JSig(jnp.asarray(mels), 120),
                             out_channels=40))
    ref = mod.apply(params, JSig(jnp.asarray(mels), 120), out_channels=40)
    net = getattr(tmel, name)(40, in_channels=24, **kw)
    load_flax_variables(net, np_tree(params))
    with torch.no_grad():
        got = net(TSig(torch.from_numpy(mels), 120))
    assert got.hop == ref.hop == 120
    within(got.data.numpy(), np.asarray(ref.data), TOL)


def test_run_lpcnet_test_metrics(reference, tmp_path):
    """The port's test protocol on a Synthetic split (4 items of 0.1 s,
    B = 2): the teacher-forced metrics of golf_tpu's ``training_step``, and
    the autoregressive MSS and cents on the first batch; all finite. The
    first batch's outputs and references go to ``ar_dump_dir``."""
    task = port_task(reference[1], train=True)
    dm = TSynthetic(batch_size=2, duration=0.1, n_items=8)
    out = ttask.run_lpcnet_test(task, dm, max_ar_batches=1,
                                ar_dump_dir=str(tmp_path))
    assert set(out) == {"avg_loss", "avg_ll", "avg_reg", "avg_lar_l2",
                        "avg_ar_mss", "avg_ar_f0_cents"}
    assert all(np.isfinite(v) for v in out.values()), out
    assert task.training
    assert sorted(os.listdir(tmp_path)) == ["ar_00.wav", "ar_01.wav",
                                            "ref_00.wav", "ref_01.wav"]


# ---------------------------------------------------------------------------
# main_torch.py --config cfg/lpcnet.yaml
# ---------------------------------------------------------------------------

def ljspeech_tree(root):
    """A flat 24 kHz LJSpeech tree: LJ001-0001 and -0002 test (0.1 s),
    LJ001-0021 valid (0.1 s), LJ002-0001 and -0002 train (0.3 s: five
    0.1 s segments each at overlap 0.05); synthetic voices with their 5 ms
    f0 tracks."""
    files = (("LJ001-0001", 0.1), ("LJ001-0002", 0.1), ("LJ001-0021", 0.1),
             ("LJ002-0001", 0.3), ("LJ002-0002", 0.3))
    hop = SR // 200
    for i, (name, secs) in enumerate(files):
        x, f0 = SyntheticVoiceDataset(1, secs, SR, seed=20 + i)[0]
        write_wav(str(root / f"{name}.wav"), x, SR)
        np.savetxt(str(root / f"{name}.pv"),
                   f0[np.minimum(np.arange(len(x) // hop + 1) * hop,
                                 len(x) - 1)])


def cli_args(tree):
    w = "model.init_args."
    return ["--config", "cfg/lpcnet.yaml", "--device", "cpu",
            f"data.init_args.wav_dir={tree}", "data.init_args.batch_size=2",
            "data.init_args.duration=0.1", "data.init_args.overlap=0.05",
            f"{w}frame_decoder.init_args.in_channels=24",
            f"{w}frame_decoder.init_args.hidden_channels=16",
            f"{w}feature_trsfm.init_args.n_fft=512",
            f"{w}feature_trsfm.init_args.n_mels=24",
            f"{w}sample_decoder.init_args.quantization_channels={Q}",
            f"{w}sample_decoder.init_args.condition_channels=32",
            f"{w}sample_decoder.init_args.a_channels=16",
            f"{w}sample_decoder.init_args.b_channels=8",
            f"{w}quantization_channels={Q}"]


def cli(argv):
    from golf_tpu_torch.tasks.cli import run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run(argv, default_config="cfg/vocoder.yaml") == 0
    return out.getvalue().strip().splitlines()


def test_main_torch_lpcnet_fit_validate_test(tmp_path):
    """``fit`` 2 amsgrad steps (``main_torch.py`` in its own process), then
    ``validate`` of its checkpoint prints the fit's last val_loss exactly
    and ``test`` the protocol's finite metrics, one AR batch."""
    tree = tmp_path / "lj"
    tree.mkdir()
    ljspeech_tree(tree)
    args = cli_args(tree)
    run_dir = tmp_path / "fit"
    done = subprocess.run(
        [sys.executable, "main_torch.py", "fit", *args,
         "trainer.max_steps=2", "--run_dir", str(run_dir)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    recs = [json.loads(ln) for ln in open(run_dir / "metrics.jsonl")]
    fit_val = [r["val_loss"] for r in recs if "val_loss" in r][-1]
    assert np.isfinite(fit_val)
    ckpt = ["--ckpt_path", str(run_dir / "ckpt" / "last")]
    val = json.loads(cli(["validate", *args, *ckpt, "--run_dir",
                          str(tmp_path / "v")])[-1])
    assert val["val_loss"] == fit_val
    assert {"val_ll", "val_reg", "val_lar_l2"} <= set(val)
    test = json.loads(cli(["test", *args, *ckpt, "--run_dir",
                           str(tmp_path / "t")])[-1])
    assert {"avg_loss", "avg_ar_mss", "avg_ar_f0_cents"} <= set(test)
    assert all(np.isfinite(v) for v in test.values()), test


def test_main_torch_lpcnet_predict_raises(tmp_path):
    tree = tmp_path / "lj"
    tree.mkdir()
    ljspeech_tree(tree)
    with pytest.raises(NotImplementedError, match="predict_step"):
        cli(["predict", *cli_args(tree), "--run_dir", str(tmp_path / "p")])


def test_main_torch_lpcnet_needs_a_card_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    args = [a for a in cli_args(tmp_path) if a not in ("--device", "cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli(["fit", *args, "--run_dir", str(tmp_path / "r")])
