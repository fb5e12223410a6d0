"""The port's exact-causal streaming encoder
(``golf_tpu_torch.serve.StreamingEncoder``) against golf_tpu's and against
the port's offline encoder, on the CPU. The encoder is the one of
``tests/test_enc_stream.py`` (n_fft 512, hop 240, channels 8/16, strides
4/4, BiLSTM of 24, voicing head), every parameter seeded, carried over by
the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.serve.enc_stream import backward_decay as j_backward_decay
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.serve import StreamingEncoder, backward_decay
from golf_tpu_torch.tasks.ae import build_encoder as t_build_encoder
from tests.test_enc_stream import (_init, _inputs, _leaves, _make_encoder,
                                   _stream_raw)

torch.set_num_threads(1)


def _port_encoder(num_layers, vs):
    enc = t_build_encoder(
        "models.enc.VocoderParameterEncoderInterface",
        {"f0_min": 60.0, "f0_max": 1000.0,
         "backbone_type": "models.unet.UNetEncoder",
         "n_fft": 512, "hop_length": 240, "channels": [8, 16],
         "strides": [4, 4], "lstm_hidden_size": 24,
         "num_layers": num_layers, "dropout": 0.0,
         "learn_voicing": True, "learn_f0": False},
        ((6,), (4, 3)), ("alpha_params", "beta_params"))
    load_flax_variables(enc, jax.tree_util.tree_map(np.asarray, vs))
    return enc.eval()


def _port_stream_raw(enc, x, f0, lookahead, chunk=2400):
    """Every push's and the flush's rows concatenated, as ``_leaves`` names
    them; and the flush's row count."""
    se = StreamingEncoder(enc, lookahead=lookahead, batch=x.shape[0])
    outs = []
    for s in range(0, x.shape[1], chunk):
        r = se.push(x[:, s:s + chunk], f0[:, s:s + chunk])
        if r is not None:
            outs.append(r)
    r = se.flush()
    outs.append(r)
    n_flushed = next(iter(_tleaves(r).values())).shape[1]
    parts = [_tleaves(o) for o in outs]
    return ({k: np.concatenate([p[k] for p in parts], axis=1)
             for k in parts[0]}, n_flushed)


def _tleaves(raw):
    out = {}
    for k, v in raw.items():
        if isinstance(v, tuple):
            for i, s in enumerate(v):
                out[f"{k}[{i}]"] = s.data.numpy()
        else:
            out[k] = v.data.numpy()
    return out


@pytest.fixture(scope="module", params=[1, 2], ids=lambda n: f"layers{n}")
def encoders(request):
    n = request.param
    enc = _make_encoder(num_layers=n)
    x, f0 = _inputs()
    vs = _init(enc, x, f0)
    return enc, vs, _port_encoder(n, vs), x, f0


@pytest.mark.parametrize("lookahead", [6, 24])
def test_stream_encoder_matches_golf_tpu(encoders, lookahead):
    """Push by push, the same rows as golf_tpu's StreamingEncoder (whose
    mid-stream rows carry the same backward truncation): every leaf within
    1e-4 of its max-abs (float32 on both sides; XLA and PyTorch sum the
    convolutions and the LSTM's products in other orders)."""
    j_enc, vs, t_enc, x, f0 = encoders
    ref, n_ref = _stream_raw(j_enc, vs, x, f0, lookahead=lookahead)
    ref = _leaves(ref)
    got, n_got = _port_stream_raw(t_enc, x, f0, lookahead)
    assert n_got == n_ref and set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        err = np.abs(got[k] - ref[k]).max() / (np.abs(ref[k]).max() + 1e-9)
        assert err < 1e-4, (k, err)


def test_stream_encoder_matches_port_offline(encoders):
    """Against the port's offline encoder on the whole utterance: the rows
    of the flush within 1e-4 of each leaf's max-abs (exact up to the
    windows' other extents), every row within 2e-2 (the backward
    truncation at a look-ahead of 24), golf_tpu's bounds
    (``tests/test_enc_stream.py``)."""
    _, _, t_enc, x, f0 = encoders
    with torch.no_grad():
        ref = _tleaves(t_enc(TSig(torch.from_numpy(x), 1),
                             TSig(torch.from_numpy(f0), 1)))
    got, n_flushed = _port_stream_raw(t_enc, x, f0, 24)
    n = next(iter(ref.values())).shape[1]
    assert n_flushed > 0 and set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        scale = np.abs(ref[k]).max() + 1e-9
        tail = np.abs(got[k][:, n - n_flushed:]
                      - ref[k][:, n - n_flushed:]).max() / scale
        assert tail < 1e-4, (k, tail)
        assert np.abs(got[k] - ref[k]).max() / scale < 2e-2, k


def test_backward_decay_matches_golf_tpu():
    """Layer 0's truncation error at look-aheads 4, 16 and 32 on the same
    rows: within 1e-3 of golf_tpu's values, relative, or 1e-7 absolute
    (the value at 32, about 3e-7, is itself float32 rounding)."""
    j_enc = _make_encoder(num_layers=1)
    x, f0 = _inputs(b=1, t=12000)
    vs = _init(j_enc, x, f0)
    h = np.random.default_rng(3).standard_normal((1, 48, 257)) \
        .astype(np.float32)
    ref = j_backward_decay(j_enc, vs, jnp.asarray(h), lookaheads=(4, 16, 32))
    got = backward_decay(_port_encoder(1, vs), torch.from_numpy(h),
                         lookaheads=(4, 16, 32))
    assert set(got) == set(ref)
    for n in ref:
        assert abs(got[n] - ref[n]) <= 1e-3 * ref[n] + 1e-7, (n, got, ref)
    assert got[4] >= got[32]


def test_stream_encoder_needs_eval_mode():
    j_enc = _make_encoder(num_layers=1)
    x, f0 = _inputs(b=1, t=4800)
    enc = _port_encoder(1, _init(j_enc, x, f0)).train()
    with pytest.raises(ValueError, match="eval mode"):
        StreamingEncoder(enc)
