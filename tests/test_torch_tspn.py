"""The port's set-prediction modules and one-way LSTM against golf_tpu's,
on the CPU, the weights carried over by the bridge's functions
(``lstm_state_dict``, ``topn_state_dict``, ``tspn_state_dict``):

* ``rnn.LSTM`` at 1 and 2 layers (dropout 0.5 between them, eval mode):
  outputs within 1e-5 of max|y|, every gradient within 1e-3 of its max-abs;
* ``TopNGenerator``: the same embeddings picked (exactly) and their
  gradient within 1e-6 of its max-abs;
* ``TTSPNEncoder`` in eval mode, and in train mode with dropout 0.25 on
  the masks golf_tpu drew from its module's ``make_rng`` (captured where
  flax draws them): outputs within 1e-5 of max|y|, gradients within 1e-3
  (an attention key bias's gradient is zero in exact arithmetic and is
  held against its weight's gradient scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.models import rnn as j_rnn
from golf_tpu.models import tspn as j_tspn
from golf_tpu_torch.bridge import (load_flax_variables, lstm_state_dict,
                                   topn_state_dict, tspn_state_dict)
from golf_tpu_torch.config.registry import import_object
from golf_tpu_torch.models import rnn as t_rnn
from golf_tpu_torch.models import tspn as t_tspn

torch.set_num_threads(1)

OUT_TOL = 1e-5
GRAD_TOL = 1e-3


def _seeded(vs, seed, scale=0.3):
    r = np.random.default_rng(seed)
    return {**vs, "params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * scale), vs["params"])}


def _close(got, ref, tol, scale=None):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(np.asarray(ref if scale is None else scale)).max()
    return np.abs(got - ref).max() <= tol * scale


def _check_grads(port, j_grads, convert, zero_grad_ok=()):
    ref = convert({"params": jax.tree_util.tree_map(np.asarray, j_grads)})
    checked = 0
    for name, prm in port.named_parameters():
        if not prm.requires_grad:
            continue
        scale = ref[name.replace("bias", "weight")] \
            if name.endswith(zero_grad_ok) else ref[name]
        assert _close(prm.grad, ref[name], GRAD_TOL, scale), name
        checked += 1
    assert checked == len([p for p in port.parameters() if p.requires_grad])


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_matches_golf_tpu(layers):
    r = np.random.default_rng(layers)
    x = r.standard_normal((2, 9, 5)).astype(np.float32)
    w = r.standard_normal((2, 9, 6)).astype(np.float32)
    j_model = j_rnn.LSTM(6, num_layers=layers, dropout=0.5)
    vs = _seeded(dict(j_model.init(jax.random.key(0), jnp.asarray(x))), 7)

    def loss(params):
        y = j_model.apply({"params": params}, jnp.asarray(x), train=False)
        return jnp.sum(y * w), y

    (_, y_j), g_j = jax.value_and_grad(loss, has_aux=True)(vs["params"])
    port = t_rnn.LSTM(5, 6, num_layers=layers, dropout=0.5)
    load_flax_variables(port, jax.tree_util.tree_map(np.asarray, vs),
                        convert=lstm_state_dict)
    port.eval()
    y_t = port(torch.from_numpy(x))
    assert _close(y_t, y_j, OUT_TOL)
    (y_t * torch.from_numpy(w)).sum().backward()
    _check_grads(port, g_j, lstm_state_dict)
    # flax's one bias is on the h side: the port's input bias stays zero
    assert all(not p.requires_grad and not p.any()
               for n, p in port.lstm.named_parameters()
               if n.startswith("bias_ih"))


def test_topn_generator_matches_golf_tpu():
    r = np.random.default_rng(3)
    feature = r.standard_normal((3, 7, 6)).astype(np.float32)
    w = r.standard_normal((3, 4, 8)).astype(np.float32)
    j_model = j_tspn.TopNGenerator(num_embeddings=32, embed_size=8, top_n=4)
    vs = dict(j_model.init(jax.random.key(0), jnp.asarray(feature)))
    vs = {"params": {**vs["params"],
                     "Dense_0": _seeded({"params": vs["params"]["Dense_0"]},
                                        5)["params"]}}

    def loss(params):
        y = j_model.apply({"params": params}, jnp.asarray(feature))
        return jnp.sum(y * w), y

    (_, y_j), g_j = jax.value_and_grad(loss, has_aux=True)(vs["params"])
    port = import_object("models.tspn.TopNGenerator")(32, 8, 4,
                                                      in_features=6)
    load_flax_variables(port, jax.tree_util.tree_map(np.asarray, vs),
                        convert=topn_state_dict)
    y_t = port(torch.from_numpy(feature))
    assert np.array_equal(y_t.detach().numpy(), np.asarray(y_j))
    (y_t * torch.from_numpy(w)).sum().backward()
    ref = np.asarray(g_j["embeddings"])
    assert _close(port.embeddings.grad, ref, 1e-6)
    # the lookup's indices carry no gradient to the projection
    assert not np.asarray(g_j["Dense_0"]["kernel"]).any()
    assert port.proj.weight.grad is None or not port.proj.weight.grad.any()


D, HEADS, LAYERS, DROP, OUT = 16, 2, 2, 0.25, 3


@pytest.fixture(scope="module")
def tspn_inputs():
    r = np.random.default_rng(11)
    return (r.standard_normal((2, 5, D)).astype(np.float32),
            r.standard_normal((2, 7, D)).astype(np.float32),
            r.standard_normal((2, 5, OUT)).astype(np.float32))


def _tspn_pair(tokens, memory):
    j_model = j_tspn.TTSPNEncoder(D, HEADS, LAYERS, DROP, OUT)
    vs = _seeded(dict(j_model.init(jax.random.key(0), jnp.asarray(tokens),
                                   jnp.asarray(memory))), 13)
    port = t_tspn.TTSPNEncoder(D, HEADS, LAYERS, DROP, OUT)
    load_flax_variables(port, jax.tree_util.tree_map(np.asarray, vs),
                        convert=tspn_state_dict)
    return j_model, vs, port


def _flax_masks(monkeypatch, j_model, vs, tokens, memory, key):
    """The dropout masks flax draws in a train-mode call, as the port's
    (tokens, frames) multipliers, in layer order."""
    drawn = []
    bernoulli = jax.random.bernoulli

    def record(k, p, shape):
        out = bernoulli(k, p, shape)
        drawn.append((np.asarray(out), p))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", record)
    j_model.apply(vs, jnp.asarray(tokens), jnp.asarray(memory), train=True,
                  rngs={"dropout": key})
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    assert len(drawn) == LAYERS
    keeps = []
    for mask, p in drawn:
        assert mask.shape == (1, 1, tokens.shape[1], memory.shape[1])
        keeps.append(torch.from_numpy(
            mask[0, 0].astype(np.float32) / np.float32(p)))
    return keeps


@pytest.mark.parametrize("train", [False, True])
def test_tspn_encoder_matches_golf_tpu(tspn_inputs, monkeypatch, train):
    tokens, memory, w = tspn_inputs
    j_model, vs, port = _tspn_pair(tokens, memory)
    key = jax.random.key(21)
    keeps = _flax_masks(monkeypatch, j_model, vs, tokens, memory, key) \
        if train else None
    if train:
        # the masks dropped something, and differ between the layers
        assert 0 < sum(float((k == 0).sum()) for k in keeps) < 2 * 35
        assert not torch.equal(keeps[0], keeps[1])

    def loss(params):
        y = j_model.apply({**vs, "params": params}, jnp.asarray(tokens),
                          jnp.asarray(memory), train=train,
                          rngs={"dropout": key})
        return jnp.sum(y * w), y

    (_, y_j), g_j = jax.value_and_grad(loss, has_aux=True)(vs["params"])
    port.train(train)
    y_t = port(torch.from_numpy(tokens), torch.from_numpy(memory),
               train=train, keeps=keeps)
    assert _close(y_t, y_j, OUT_TOL)
    (y_t * torch.from_numpy(w)).sum().backward()
    _check_grads(port, g_j, tspn_state_dict, zero_grad_ok=(".key.bias",))


def test_tspn_dropout_masks_shared_over_batch_and_heads():
    port = t_tspn.TTSPNEncoder(D, HEADS, LAYERS, DROP, OUT)
    port.train()
    torch.manual_seed(0)
    keeps = port.dropout_masks(5, 7, "cpu")
    assert len(keeps) == LAYERS
    for k in keeps:
        assert k.shape == (5, 7)
        assert set(torch.unique(k).tolist()) <= {0.0,
                                                 np.float32(1 / (1 - DROP))}
    port.eval()
    assert port.dropout_masks(5, 7, "cpu") == [None] * LAYERS
    with pytest.raises(ValueError, match="train"):
        port(torch.zeros(1, 5, D), torch.zeros(1, 7, D), train=True)
