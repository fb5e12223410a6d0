"""The options of the port's ``UNetEncoder`` against golf_tpu's on the CPU:
the bf16 compute dtype (``ConvPyramid`` and the BiLSTM), the env features,
the ``LRU`` and ``LRUBlock``, the whole encoder under each option and the
bridge's mapping of ``LRUBlock_0``. Small widths (n_fft 512, hop 240, two
conv layers of 8 and 16 channels, hidden 16, B = 2 x 0.5 s), inputs from a
numpy seed, weights carried over by the bridge.

Tolerances: the fp32 paths within 1e-5 of max|y| and their gradients
within 1e-3 of each gradient's max-abs. The bf16 paths within twice
golf_tpu's own distance between its bf16 and fp32 runs on the same inputs
plus one bf16 rounding step (2^-8 of max-abs: XLA's CPU bf16 convolutions
and matmuls sum in another order than oneDNN's, and each side rounds its
result to bf16), and in absolute terms within 5e-2 of max-abs, the conv
pyramid's gradients within 0.5. Where one module runs on golf_tpu's own
inputs and cotangent (the BiLSTM, the ConvPyramid), every result is also
no further from golf_tpu's bf16 result than golf_tpu's fp32 result is,
plus one bf16 step (measured: at most 3.6e-3 past it, the pyramid's
output). Through the whole encoder each module's inputs and cotangent
already carry the upstream modules' bf16 rounding, so the distances
compound (measured up to 2.35 times golf_tpu's own, and 0.43 of max-abs
in the first conv layer's gradient, which sums thousands of bf16-rounded
products that nearly cancel in front of a train-mode batch norm, where
golf_tpu's own bf16 run strays 0.42 from its fp32 run): there the bound
stays twice golf_tpu's own. Everywhere the port must really compute in
bf16: summed over the leaves of each part (the LSTM, the conv pyramid,
the rest) whose own distance is at least one bf16 step, the port's
distance from golf_tpu's fp32 result is at least half golf_tpu's own (a
port that ran the part in fp32 would sit at fp32 parity, ~1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models import lru as j_lru
from golf_tpu.models import rnn as j_rnn
from golf_tpu.models import unet as j_unet
from golf_tpu.tasks.ae import build_encoder as j_build_encoder
from golf_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.models import lru as t_lru
from golf_tpu_torch.models import rnn as t_rnn
from golf_tpu_torch.models import unet as t_unet
from golf_tpu_torch.tasks.ae import build_encoder as t_build_encoder
from tests.test_enc_stream import _init, _inputs

torch.set_num_threads(1)

FP32_TOL = 1e-5
GRAD_TOL = 1e-3
BF16_ABS_TOL = 5e-2
BF16_PYRAMID_GRAD_TOL = 0.5
BF16_STEP = 2 ** -8
ENC_ARGS = {"f0_min": 60.0, "f0_max": 1000.0,
            "backbone_type": "models.unet.UNetEncoder",
            "n_fft": 512, "hop_length": 240, "channels": [8, 16],
            "strides": [4, 4], "lstm_hidden_size": 16, "num_layers": 2,
            "dropout": 0.0, "learn_voicing": True, "learn_f0": False}
LAYOUT = (((6,), (4, 3)), ("alpha_params", "beta_params"))
OPTIONS = {
    "lru": {"use_lru": True},
    "env": {"include_env_features": True, "sample_rate": 24000,
            "num_harmonics": 64},
    "bf16": {"compute_dtype": "bfloat16"},
    "lru_env": {"use_lru": True, "include_env_features": True,
                "sample_rate": 24000, "num_harmonics": 64},
    "bf16_env": {"compute_dtype": "bfloat16", "include_env_features": True,
                 "sample_rate": 24000, "num_harmonics": 64},
}


def _np(a):
    return np.asarray(a.detach().float().numpy() if torch.is_tensor(a)
                      else a, np.float64)


def _rel(a, b):
    """max|a - b| over max|b|."""
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _randomize(params, seed, scale=0.1):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * scale), params)


def _assert_bf16(got, ref16, ref32, what, near=False):
    """``got`` (the port in bf16) within twice golf_tpu's own bf16-to-fp32
    distance of golf_tpu's bf16 result plus one bf16 step, and within the
    absolute bound; with ``near``, also no further from it than golf_tpu's
    fp32 result is, plus one bf16 step. Returns (golf_tpu's own distance,
    the port's distance from golf_tpu's fp32 result)."""
    own = _rel(ref16, ref32)
    err = _rel(got, ref16)
    bound = BF16_PYRAMID_GRAD_TOL if "pyramid." in what else BF16_ABS_TOL
    assert err <= 2 * own + BF16_STEP and err <= bound, (what, err, own)
    if near:
        assert err <= own + BF16_STEP, (what, err, own)
    return own, _rel(got, ref32)


def _assert_ran_bf16(dists):
    """``dists``: leaf name -> ``_assert_bf16``'s (own, distance from fp32).
    For each part (the LSTM, the conv pyramid, the rest), summed over its
    leaves whose own distance is at least one bf16 step: the port's
    distance from golf_tpu's fp32 result is at least half golf_tpu's
    own."""
    parts = {}
    for name, (own, far) in dists.items():
        if own >= BF16_STEP:
            part = "lstm" if "lstm" in name else \
                "pyramid" if "pyramid" in name else "rest"
            sums = parts.setdefault(part, [0.0, 0.0])
            sums[0] += own
            sums[1] += far
    assert parts
    for part, (own, far) in parts.items():
        assert far >= 0.5 * own, (part, far, own)


def _grads_state_dict(grads):
    """golf_tpu gradients under the port's parameter names (the bridge's
    conversions); the LSTM's zero ``bias_ih`` is not a gradient."""
    return {k: v for k, v in flax_to_state_dict({"params": grads}).items()
            if "bias_ih" not in k}


class _Holder(nn.Module):
    """Holds one module under the attribute name the bridge gives its
    scope."""

    def __init__(self, name, module):
        super().__init__()
        setattr(self, name, module)


# ---------------------------------------------------------------------------
# the bf16 BiLSTM and ConvPyramid
# ---------------------------------------------------------------------------

def _j_bilstm(dtype):
    return j_rnn.BiLSTM(16, num_layers=2, dtype=dtype)


def test_bilstm_bf16_matches_golf_tpu():
    """golf_tpu's ``BiLSTM(dtype=bf16)`` (the fused LSTM with its
    hand-written BPTT) and the port's bf16 BiLSTM: outputs and the
    gradients of every weight and of the input."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 30, 20)).astype(np.float32)
    w = rng.standard_normal((2, 30, 32)).astype(np.float32)
    params = _randomize(_j_bilstm(None).init(jax.random.key(0), x)["params"],
                        seed=1, scale=0.3)

    def j_run(dtype):
        def loss(p, xx):
            y = _j_bilstm(dtype).apply({"params": p}, xx)
            return jnp.sum(y.astype(jnp.float32) * w), y
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, x)
        return y, _grads_state_dict({"BiLSTM_0": gp}), gx

    y32, gp32, gx32 = j_run(None)
    y16, gp16, gx16 = j_run(jnp.bfloat16)
    holder = _Holder("lstm", t_rnn.BiLSTM(20, 16, 2, dtype=torch.bfloat16))
    load_flax_variables(holder, {"params": {"BiLSTM_0": jax.tree_util.tree_map(
        np.asarray, params)}})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = holder.lstm(xt)
    (y * torch.from_numpy(w)).sum().backward()
    assert y.dtype == torch.float32 and y.shape == (2, 30, 32)
    dists = {"y": _assert_bf16(y, y16, y32, "y", near=True),
             "dx": _assert_bf16(xt.grad, gx16, gx32, "dx", near=True)}
    for name, p in holder.named_parameters():
        if p.requires_grad:
            dists[name] = _assert_bf16(p.grad, gp16[name], gp32[name], name,
                                       near=True)
    _assert_ran_bf16(dists)


def _j_pyramid(dtype):
    return j_unet.ConvPyramid((8, 16), (4, 4), dtype=dtype)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_conv_pyramid_bf16_matches_golf_tpu(train):
    """``ConvPyramid(dtype=bf16)``: bf16 convolutions on the fp32
    parameters, flax's bf16 batch norm (fp32 statistics, bf16 output);
    output, every gradient and (train) the fp32 running statistics."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 129, 20, 1)).astype(np.float32)
    w = rng.standard_normal((2, 8, 20, 16)).astype(np.float32)
    variables = _j_pyramid(None).init(jax.random.key(0), x, train=False)
    params = _randomize(variables["params"], seed=3, scale=0.3)
    stats = jax.tree_util.tree_map(
        lambda a: a + 0.1, variables["batch_stats"])

    def j_run(dtype):
        def loss(p, xx):
            y, upd = _j_pyramid(dtype).apply(
                {"params": p, "batch_stats": stats}, xx, train=train,
                mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * w), (y, upd)
        (_, (y, upd)), gp = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params, x)
        return y, upd["batch_stats"], _grads_state_dict(
            {"ConvPyramid_0": gp})

    y32, st32, gp32 = j_run(None)
    y16, st16, gp16 = j_run(jnp.bfloat16)
    holder = _Holder("pyramid", t_unet.ConvPyramid(1, (8, 16), (4, 4),
                                                   dtype=torch.bfloat16))
    load_flax_variables(holder, jax.tree_util.tree_map(
        np.asarray, {"params": {"ConvPyramid_0": params},
                     "batch_stats": {"ConvPyramid_0": stats}}))
    holder.train(train)
    y = holder.pyramid(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert y.dtype == torch.bfloat16
    y = y.permute(0, 2, 3, 1)
    (y.float() * torch.from_numpy(w)).sum().backward()
    dists = {"y": _assert_bf16(y, y16, y32, "y", near=True)}
    for name, p in holder.named_parameters():
        if train and name.startswith("pyramid.convs.") and \
                name.endswith(".bias"):
            # in front of a train-mode batch norm: zero in exact
            # arithmetic; golf_tpu's bf16 cotangent rounds to bf16 before
            # the sum, so both sides are rounding noise
            continue
        dists[name] = _assert_bf16(p.grad, gp16[name], gp32[name], name,
                                   near=True)
    _assert_ran_bf16(dists)
    if train:
        for i, norm in enumerate(holder.pyramid.norms):
            ref = st16[f"BatchNorm_{i}"]
            assert norm.running_mean.dtype == torch.float32
            assert _rel(norm.running_mean, ref["mean"]) < 1e-2
            assert _rel(norm.running_var, ref["var"]) < 1e-2


# ---------------------------------------------------------------------------
# env features, the LRU, LRUBlock
# ---------------------------------------------------------------------------

def test_env_features_matches_golf_tpu():
    """Envelope features and SNR on a random power spectrogram with voiced
    and unvoiced frames (f0 0 takes the fallback pitch); the gathers'
    indices come from round-half-to-even in both."""
    rng = np.random.default_rng(4)
    spec = (rng.standard_normal((2, 257, 40)) ** 2).astype(np.float32)
    f0 = rng.uniform(80, 400, (2, 40)).astype(np.float32)
    f0[:, ::7] = 0.0
    # exact halves: the pickups of k f0 / 46.875 at f0 = 46.875 * 2.5
    f0[0, 3] = 46.875 * 2.5
    feats, snr = j_unet.env_features(jnp.asarray(spec), jnp.asarray(f0),
                                     24000, 512, 64)
    got, got_snr = t_unet.env_features(torch.from_numpy(spec),
                                       torch.from_numpy(f0), 24000, 512, 64)
    assert got.shape == (2, 3, 257, 40) and got_snr.shape == (2, 1, 257, 40)
    assert _rel(got.permute(0, 2, 3, 1), feats) <= FP32_TOL
    assert _rel(got_snr.permute(0, 2, 3, 1), snr) <= FP32_TOL


def test_lru_scan_matches_associative_scan():
    """The log-depth scan against golf_tpu's ``associative_scan`` on the
    same complex64 inputs, with and without a carry-in state: within 1e-5
    of max|h| (the two group the products differently)."""
    rng = np.random.default_rng(5)
    mag = rng.uniform(0.5, 0.99, 12)
    lam = (mag * np.exp(1j * rng.uniform(0, np.pi, 12))).astype(np.complex64)
    bu = (rng.standard_normal((2, 200, 12))
          + 1j * rng.standard_normal((2, 200, 12))).astype(np.complex64)
    zi = (rng.standard_normal((2, 12))
          + 1j * rng.standard_normal((2, 12))).astype(np.complex64)
    for z in (None, zi):
        ref = np.asarray(j_lru._lru_scan(
            jnp.asarray(lam), jnp.asarray(bu),
            None if z is None else jnp.asarray(z)))
        got = t_lru.lru_scan(torch.from_numpy(lam), torch.from_numpy(bu),
                             None if z is None else torch.from_numpy(z))
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err <= FP32_TOL, err


@pytest.mark.parametrize("features", [(12, 12), (10, 12)],
                         ids=["square_with_D", "no_D"])
def test_lru_matches_golf_tpu(features):
    """``LRU`` with a carry-in state: the real output and the real and
    imaginary parts of the last state, and the gradients of every (real)
    parameter and of the input through a real loss. The D skip exists only
    when in == out."""
    n_in, n_out = features
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 40, n_in)).astype(np.float32)
    w = rng.standard_normal((2, 40, n_out)).astype(np.float32)
    zi = (rng.standard_normal((2, n_out))
          + 1j * rng.standard_normal((2, n_out))).astype(np.complex64)
    mod = j_lru.LRU(n_in, n_out)
    params = mod.init(jax.random.key(1), x, zi)["params"]

    def loss(p, xx):
        y, last = mod.apply({"params": p}, xx, jnp.asarray(zi))
        return (jnp.sum(y * w) + jnp.sum(last.real)
                - 0.5 * jnp.sum(last.imag)), (y, last)
    (_, (y_ref, last_ref)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)

    port = t_lru.LRU(n_in, n_out)
    assert (port.D is None) == (n_in != n_out)
    with torch.no_grad():
        for name, prm in port.named_parameters():
            prm.copy_(torch.from_numpy(np.array(params[name])))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, last = port(xt, torch.from_numpy(zi))
    ((y * torch.from_numpy(w)).sum() + last.real.sum()
     - 0.5 * last.imag.sum()).backward()
    assert _rel(y, y_ref) <= FP32_TOL
    assert _rel(torch.view_as_real(last), np.stack(
        [np.real(last_ref), np.imag(last_ref)], -1)) <= FP32_TOL
    assert _rel(xt.grad, gx) <= GRAD_TOL
    for name, prm in port.named_parameters():
        assert _rel(prm.grad, gp[name]) <= GRAD_TOL, name


def test_lru_block_matches_golf_tpu():
    """``LRUBlock`` (two layers, zi predicted from the last frame, the
    tanh GELU, no residual) through the bridge: output and gradients."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 30, 20)).astype(np.float32)
    w = rng.standard_normal((2, 30, 16)).astype(np.float32)
    mod = j_unet.LRUBlock(20, 16, num_layers=2)
    params = mod.init(jax.random.key(2), x)["params"]
    params = jax.tree_util.tree_map(
        lambda a, b: a + b, params, _randomize(params, seed=8, scale=0.05))

    def loss(p, xx):
        y = mod.apply({"params": p}, xx)
        return jnp.sum(y * w), y
    (_, y_ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    holder = _Holder("lru_block", t_unet.LRUBlock(20, 16, num_layers=2))
    load_flax_variables(holder, {"params": {"LRUBlock_0": jax.tree_util.
                                            tree_map(np.asarray, params)}})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = holder.lru_block(xt)
    (y * torch.from_numpy(w)).sum().backward()
    assert _rel(y, y_ref) <= FP32_TOL
    assert _rel(xt.grad, gx) <= GRAD_TOL
    ref = _grads_state_dict({"LRUBlock_0": gp})
    for name, prm in holder.named_parameters():
        assert _rel(prm.grad, ref[name]) <= GRAD_TOL, name


def test_bridge_maps_lru_block():
    """Every leaf of golf_tpu's ``LRUBlock_0`` lands on the port's
    parameter of the same role: ``Dense_k`` on ``dense{k}``, the block's
    ``LayerNorm_i`` on ``norms.i`` (the encoder's own ``LayerNorm_0`` on
    ``norm``), the zi predictors and the LRU leaves under their names; the
    strict load takes them all."""
    enc = j_build_encoder("models.enc.VocoderParameterEncoderInterface",
                          {**ENC_ARGS, **OPTIONS["lru"]}, *LAYOUT)
    x, f0 = _inputs(b=2, t=12000)
    vs = _init(enc, x, f0)
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, vs))
    p_lru = vs["params"]["backbone"]["LRUBlock_0"]
    assert np.array_equal(sd["backbone.lru_block.norms.1.weight"].numpy(),
                          np.asarray(p_lru["LayerNorm_1"]["scale"]))
    assert np.array_equal(sd["backbone.lru_block.dense3.weight"].numpy(),
                          np.asarray(p_lru["Dense_3"]["kernel"]).T)
    assert np.array_equal(sd["backbone.lru_block.lru_1.B_im"].numpy(),
                          np.asarray(p_lru["lru_1"]["B_im"]))
    assert np.array_equal(sd["backbone.lru_block.zi_pred_re_0"].numpy(),
                          np.asarray(p_lru["zi_pred_re_0"]))
    assert np.array_equal(sd["backbone.norm.bias"].numpy(), np.asarray(
        vs["params"]["backbone"]["LayerNorm_0"]["bias"]))
    port = t_build_encoder("models.enc.VocoderParameterEncoderInterface",
                           {**ENC_ARGS, **OPTIONS["lru"]}, *LAYOUT)
    assert set(sd) == set(port.state_dict()) - {
        k for k in port.state_dict() if k.endswith("num_batches_tracked")}
    load_flax_variables(port, jax.tree_util.tree_map(np.asarray, vs))


# ---------------------------------------------------------------------------
# the whole encoder under each option
# ---------------------------------------------------------------------------

def _leaves(raw):
    out = {}
    for k, v in raw.items():
        for i, s in enumerate(v if isinstance(v, tuple) else (v,)):
            out[f"{k}[{i}]"] = s.data
    return out


def _weight(key, shape):
    """The seeded weights of the real loss sum_k <out_k, w_k>."""
    seed = sorted(("voicing_logits[0]", "alpha_params[0]", "beta_params[0]",
                   "beta_params[1]")).index(key)
    return np.random.default_rng(9 + seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def inputs():
    x, f0 = _inputs(b=2, t=12000)
    f0[:, 4000:5000] = 0.0                   # an unvoiced stretch
    return x, f0


def _j_encoder_run(kw, vs, x, f0, train):
    enc = j_build_encoder("models.enc.VocoderParameterEncoderInterface",
                          {**ENC_ARGS, **kw}, *LAYOUT)

    def loss(params):
        v = {**vs, "params": params}
        if train:
            out, _ = enc.apply(v, JSig(x, 1), JSig(f0, 1), train=True,
                               mutable=["batch_stats", "stats"])
        else:
            out = enc.apply(v, JSig(x, 1), JSig(f0, 1), train=False)
        leaves = _leaves(out)
        return sum(jnp.sum(v * _weight(k, v.shape))
                   for k, v in leaves.items()), leaves
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        vs["params"])
    return out, _grads_state_dict(grads)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_unet_encoder_option_matches_golf_tpu(inputs, option, train):
    """The whole encoder (2 conv layers, 2 recurrent layers of 16, the
    voicing head) under each option, train mode (batch statistics, the
    running min/max updated) and eval: every output leaf and every
    parameter's gradient through a seeded real loss. fp32 options at 1e-5
    and 1e-3; under bf16 within twice golf_tpu's own bf16-to-fp32 distance
    (golf_tpu's fp32 run of the same weights is the reference for that
    distance)."""
    x, f0 = inputs
    kw = OPTIONS[option]
    j_enc = j_build_encoder("models.enc.VocoderParameterEncoderInterface",
                            {**ENC_ARGS, **kw}, *LAYOUT)
    vs = _init(j_enc, x, f0)
    ref, ref_g = _j_encoder_run(kw, vs, x, f0, train)
    port = t_build_encoder("models.enc.VocoderParameterEncoderInterface",
                           {**ENC_ARGS, **kw}, *LAYOUT)
    load_flax_variables(port, jax.tree_util.tree_map(np.asarray, vs))
    port.train(train)
    out = _leaves(port(TSig(torch.from_numpy(x), 1),
                       TSig(torch.from_numpy(f0), 1), train=train))
    sum((v * torch.from_numpy(_weight(k, tuple(v.shape)))).sum()
        for k, v in out.items()).backward()
    grads = {n: p.grad for n, p in port.named_parameters()
             if p.requires_grad}
    assert set(grads) == set(ref_g)
    for k in out:
        assert out[k].dtype == torch.float32 and out[k].shape == ref[k].shape
    if "compute_dtype" not in kw:
        for k in out:
            assert _rel(out[k], ref[k]) <= FP32_TOL, k
        for n in grads:
            scale = ref_g[n]
            if train and n.startswith("backbone.pyramid.convs.") and \
                    n.endswith(".bias"):
                # in front of a train-mode batch norm: zero in exact
                # arithmetic, held against the conv weight gradient's scale
                scale = ref_g[n[:-len("bias")] + "weight"]
            err = _np(grads[n] - torch.from_numpy(_np(ref_g[n])))
            assert np.abs(err).max() <= GRAD_TOL * np.abs(_np(scale)).max(), n
        return
    kw32 = {k: v for k, v in kw.items() if k != "compute_dtype"}
    ref32, ref32_g = _j_encoder_run(kw32, vs, x, f0, train)
    dists = {k: _assert_bf16(out[k], ref[k], ref32[k], k) for k in out}
    for n in grads:
        if train and n.startswith("backbone.pyramid.convs.") and \
                n.endswith(".bias"):
            # in front of a train-mode batch norm: rounding noise on both
            # sides (test_conv_pyramid_bf16_matches_golf_tpu)
            continue
        dists[n] = _assert_bf16(grads[n], ref_g[n], ref32_g[n], n)
    _assert_ran_bf16(dists)


def test_options_build_through_the_registry():
    """Every option builds from a config node on the CPU without
    NotImplementedError."""
    for kw in OPTIONS.values():
        enc = t_build_encoder("models.enc.VocoderParameterEncoderInterface",
                              {**ENC_ARGS, **kw}, *LAYOUT)
        assert enc.backbone.use_lru == kw.get("use_lru", False)
        assert enc.backbone.pyramid.convs[0].in_channels == (
            4 if kw.get("include_env_features") else 1)
