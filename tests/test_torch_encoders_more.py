"""Four more encoder backbones of the port against golf_tpu's, on the CPU:
``X2Control`` (models/mel.py), ``F0EnergyEncoder`` (models/enc.py),
``UNetEncoderV2`` and ``TransformerEncoderBackbone`` (models/unet.py),
each built through ``build_encoder`` (the AE's encoder interface with the
voicing head) at narrow widths (n_fft 256 or 512, hop 240, hidden 16, two
recurrent layers, B = 2 x 0.5 s with an unvoiced stretch), the weights
carried over by the bridge; plus ``sinusoidal``, ``_strided_max``, the
transformer's chunked attention and the registry's ``TransformerEncoder``
alias.

Tolerances: outputs within 1e-5 of max|y| and every parameter's gradient
within 1e-3 of its max-abs, in eval mode and in a train-mode step (dropout
0: batch statistics, the running min/max updated, which must then equal
golf_tpu's within 1e-5 relative; the batch norms' running statistics too);
a conv's bias in front of a train-mode batch norm and the attention's key
bias (the softmax over keys is blind to it) have a zero gradient in exact
arithmetic, and are held against their weight's gradient scale. ``sinusoidal``
bit for bit, ``_strided_max`` exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models import unet as j_unet
from golf_tpu.tasks.ae import build_encoder as j_build_encoder
from golf_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from golf_tpu_torch.config.registry import import_object
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.models import unet as t_unet
from golf_tpu_torch.tasks.ae import build_encoder as t_build_encoder
from tests.test_enc_stream import _inputs

torch.set_num_threads(1)

OUT_TOL = 1e-5
GRAD_TOL = 1e-3
STATS_TOL = 1e-5
IFACE = "models.enc.VocoderParameterEncoderInterface"
LAYOUT = (((6,), (4, 3)), ("alpha_params", "beta_params"))
COMMON = {"f0_min": 60.0, "f0_max": 1000.0, "learn_voicing": True,
          "learn_f0": False, "hop_length": 240, "num_layers": 2,
          "dropout": 0.0}
BACKBONES = {
    "X2Control": {"backbone_type": "models.mel.X2Control", "n_fft": 256,
                  "hidden_channels": 16},
    "F0EnergyEncoder": {"backbone_type": "models.enc.F0EnergyEncoder",
                        "sr": 24000, "n_fft": 512, "win_length": 480,
                        "num_bands": 20, "lstm_hidden_size": 16},
    "UNetEncoderV2": {"backbone_type": "models.unet.UNetEncoderV2",
                      "sr": 24000, "embed_size": 4, "n_fft": 512,
                      "channels": [8, 16], "strides": [4, 4],
                      "lstm_hidden_size": 16},
    "TransformerEncoder": {"backbone_type": "models.unet.TransformerEncoder",
                           "n_fft": 256, "emb_channels": 8, "nhead": 2,
                           "num_attn_layers": 2, "maxpool_stride": 16,
                           "lstm_hidden_size": 16},
}
STATS = {"F0EnergyEncoder": "log_energy"}


def _args(name):
    return {**COMMON, **BACKBONES[name]}


def _np(a):
    return np.asarray(a.detach().numpy() if torch.is_tensor(a) else a,
                      np.float64)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def inputs():
    x, f0 = _inputs(b=2, t=12000)
    f0[:, 4000:5000] = 0.0                   # an unvoiced stretch
    return x, f0


def _variables(enc, name, x, f0):
    """golf_tpu's init, every parameter seeded (the head is zero at init),
    the running min/max set, the batch norms' statistics moved off their
    initial values."""
    vs = dict(jax.jit(lambda xs, f0s: enc.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        JSig(xs, 1), JSig(f0s, 1), train=False))(x, f0))
    r = np.random.default_rng(42)
    vs["params"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * 0.1), vs["params"])
    prefix = STATS.get(name, "log_spec")
    lo, hi = (-20.0, 3.0) if prefix == "log_spec" else (-25.0, 4.0)
    vs["stats"] = {"backbone": {f"{prefix}_min": jnp.asarray(lo),
                                f"{prefix}_max": jnp.asarray(hi)}}
    if "batch_stats" in vs:
        vs["batch_stats"] = jax.tree_util.tree_map(
            lambda a: a + jnp.asarray(r.uniform(0.1, 0.3, a.shape)
                                      .astype(np.float32)),
            vs["batch_stats"])
    return vs


def _leaves(raw):
    out = {}
    for k, v in raw.items():
        for i, s in enumerate(v if isinstance(v, tuple) else (v,)):
            out[f"{k}[{i}]"] = s.data
    return out


def _weight(key, shape):
    seed = sorted(("voicing_logits[0]", "alpha_params[0]", "beta_params[0]",
                   "beta_params[1]")).index(key)
    return np.random.default_rng(9 + seed).standard_normal(shape).astype(
        np.float32)


def _j_run(enc, vs, x, f0, train):
    def loss(params):
        v = {**vs, "params": params}
        if train:
            out, upd = enc.apply(v, JSig(x, 1), JSig(f0, 1), train=True,
                                 mutable=["batch_stats", "stats"])
        else:
            out, upd = enc.apply(v, JSig(x, 1), JSig(f0, 1),
                                 train=False), {}
        leaves = _leaves(out)
        return sum(jnp.sum(v * _weight(k, v.shape))
                   for k, v in leaves.items()), (leaves, upd)
    (_, (out, upd)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(vs["params"])
    return out, upd, {k: v for k, v in flax_to_state_dict(
        {"params": grads}).items() if "bias_ih" not in k}


def _port(name, vs):
    port = t_build_encoder(IFACE, _args(name), *LAYOUT)
    load_flax_variables(port, jax.tree_util.tree_map(np.asarray, vs))
    return port


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(BACKBONES))
def test_backbone_matches_golf_tpu(inputs, name, train):
    """Every output leaf and every parameter's gradient through a seeded
    real loss; in train mode the updated running min/max and batch-norm
    statistics."""
    x, f0 = inputs
    j_enc = j_build_encoder(IFACE, _args(name), *LAYOUT)
    vs = _variables(j_enc, name, x, f0)
    ref, upd, ref_g = _j_run(j_enc, vs, x, f0, train)
    port = _port(name, vs)
    port.train(train)
    out = _leaves(port(TSig(torch.from_numpy(x), 1),
                       TSig(torch.from_numpy(f0), 1), train=train))
    sum((v * torch.from_numpy(_weight(k, tuple(v.shape)))).sum()
        for k, v in out.items()).backward()
    grads = {n: p.grad for n, p in port.named_parameters()
             if p.requires_grad}
    assert set(grads) == set(ref_g)
    for k in out:
        assert _rel(out[k], ref[k]) <= OUT_TOL, k
    for n, g in grads.items():
        scale = ref_g[n]
        in_front_of_bn = train and n.endswith(".bias") and (
            "pyramid.convs." in n or n == "backbone.convs.0.bias")
        if in_front_of_bn or n.endswith(".key.bias"):
            scale = ref_g[n[:-len("bias")] + "weight"]
        err = np.abs(_np(g) - _np(ref_g[n])).max()
        assert err <= GRAD_TOL * np.abs(_np(scale)).max(), (n, err)
    if train:
        sd = port.state_dict()
        for key, value in flax_to_state_dict(jax.tree_util.tree_map(
                np.asarray, {k: upd[k] for k in upd})).items():
            assert _rel(sd[key], value) <= STATS_TOL, key


def test_x2control_needs_f0_and_checks_its_mode(inputs):
    x, f0 = inputs
    port = t_build_encoder(IFACE, _args("X2Control"), *LAYOUT)
    port.eval()
    with pytest.raises(ValueError, match="mode"):
        port(TSig(torch.from_numpy(x), 1), TSig(torch.from_numpy(f0), 1),
             train=True)
    with pytest.raises(AttributeError):
        port(TSig(torch.from_numpy(x), 1), None)


@pytest.mark.parametrize("name", list(BACKBONES))
def test_bridge_loads_each_backbone_strictly(inputs, name):
    """golf_tpu's variables of each backbone cover the port's state_dict
    exactly (the batch norms' step counters aside), and each leaf lands on
    the parameter of its role."""
    x, f0 = inputs
    j_enc = j_build_encoder(IFACE, _args(name), *LAYOUT)
    vs = _variables(j_enc, name, x, f0)
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, vs))
    port = t_build_encoder(IFACE, _args(name), *LAYOUT)
    own = {k for k in port.state_dict()
           if not k.endswith("num_batches_tracked")}
    assert set(sd) == own
    bb = vs["params"]["backbone"]
    if name == "UNetEncoderV2":
        assert np.array_equal(sd["backbone.embed.weight"].numpy(),
                              np.asarray(bb["Embed_0"]["embedding"]))
    if name == "TransformerEncoder":
        attn = bb["MultiHeadDotProductAttention_1"]
        q = np.asarray(attn["query"]["kernel"])          # (c, heads, d)
        assert np.array_equal(sd["backbone.layers.1.query.weight"].numpy(),
                              q.reshape(q.shape[0], -1).T)
        o = np.asarray(attn["out"]["kernel"])            # (heads, d, c)
        assert np.array_equal(sd["backbone.layers.1.out.weight"].numpy(),
                              o.reshape(-1, o.shape[-1]).T)
        assert np.array_equal(sd["backbone.layers.1.norm2.weight"].numpy(),
                              np.asarray(bb["LayerNorm_3"]["scale"]))
        assert np.array_equal(sd["backbone.final_norm.bias"].numpy(),
                              np.asarray(bb["LayerNorm_4"]["bias"]))
        assert np.array_equal(sd["backbone.norm.bias"].numpy(),
                              np.asarray(bb["LayerNorm_5"]["bias"]))
        assert np.array_equal(sd["backbone.layers.0.ff2.weight"].numpy(),
                              np.asarray(bb["Dense_1"]["kernel"]).T)
    load_flax_variables(port, jax.tree_util.tree_map(np.asarray, vs))


def test_transformer_alias_and_class():
    assert import_object("models.unet.TransformerEncoder") is \
        t_unet.TransformerEncoderBackbone
    assert import_object("golf_tpu.models.unet.TransformerEncoder") is \
        t_unet.TransformerEncoderBackbone


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_transformer_chunks_match_one_pass(inputs, monkeypatch, train):
    """The attention over chunks of sequences (each recomputed in the
    backward when a gradient is needed) equals one pass over all of them:
    outputs within 1e-6 of max-abs, gradients within 1e-5 (a weight's
    gradient sums over the sequences chunk by chunk)."""
    x, f0 = inputs
    j_enc = j_build_encoder(IFACE, _args("TransformerEncoder"), *LAYOUT)
    vs = _variables(j_enc, "TransformerEncoder", x, f0)
    results = []
    for chunk in (t_unet.ATTN_CHUNK, 7):
        monkeypatch.setattr(t_unet, "ATTN_CHUNK", chunk)
        port = _port("TransformerEncoder", vs)
        port.train(train)
        out = _leaves(port(TSig(torch.from_numpy(x), 1),
                           TSig(torch.from_numpy(f0), 1), train=train))
        sum((v * torch.from_numpy(_weight(k, tuple(v.shape)))).sum()
            for k, v in out.items()).backward()
        results.append((out, {n: p.grad.clone() for n, p in
                              port.named_parameters() if p.requires_grad}))
    (o1, g1), (o2, g2) = results
    for k in o1:
        assert _rel(o2[k], o1[k]) <= 1e-6, k
    for n in g1:
        # the key bias's gradient is zero in exact arithmetic
        scale = g1[n[:-len("bias")] + "weight"] if n.endswith(".key.bias") \
            else g1[n]
        assert np.abs(_np(g2[n] - g1[n])).max() <= \
            1e-5 * np.abs(_np(scale)).max(), n


def test_transformer_dropout_shares_one_mask(inputs):
    """In train mode with dropout, one (L, L) mask a layer, scaled by
    1 / keep, shared by every sequence and head (flax's
    ``broadcast_dropout``); none in eval mode."""
    port = t_build_encoder(IFACE, {**_args("TransformerEncoder"),
                                   "dropout": 0.25}, *LAYOUT).backbone
    port.train()
    torch.manual_seed(0)
    keeps = port.dropout_masks(11, "cpu")
    assert len(keeps) == 2
    for k in keeps:
        assert k.shape == (11, 11)
        assert set(torch.unique(k).tolist()) <= {0.0, np.float32(1 / 0.75)}
    port.eval()
    assert port.dropout_masks(11, "cpu") == [None, None]


def test_sinusoidal_bit_for_bit():
    for shape in ((129, 8), (257, 32), (512, 512)):
        got = t_unet.sinusoidal(shape=shape)
        assert got.dtype == np.float32
        assert np.array_equal(got, j_unet.sinusoidal(shape=shape))
    assert np.array_equal(t_unet.sinusoidal(2.0, 100.0, (7, 6)),
                          j_unet.sinusoidal(2.0, 100.0, (7, 6)))


@pytest.mark.parametrize("axis,s", [(1, 4), (2, 64), (-1, 3), (2, 1)])
def test_strided_max_matches_golf_tpu(axis, s):
    x = np.random.default_rng(0).standard_normal((2, 9, 257, 5)).astype(
        np.float32)
    ref = np.asarray(j_unet._strided_max(jnp.asarray(x), s, axis))
    got = t_unet._strided_max(torch.from_numpy(x), s, axis).numpy()
    assert np.array_equal(got, ref)
