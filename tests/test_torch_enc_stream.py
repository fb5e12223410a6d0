"""The port's exact-causal streaming encoder
(``golf_tpu_torch.serve.StreamingEncoder``) against golf_tpu's and against
the port's offline encoder, on the CPU. The encoder is the one of
``tests/test_enc_stream.py`` (n_fft 512, hop 240, channels 8/16, strides
4/4, BiLSTM of 24, voicing head), every parameter seeded, carried over by
the bridge; also under each of its options (the LRU block, env features,
the bf16 compute dtype)."""

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


def _port_encoder(num_layers, vs, **backbone_kwargs):
    enc = t_build_encoder(
        "models.enc.VocoderParameterEncoderInterface",
        {"f0_min": 60.0, "f0_max": 1000.0,
         "backbone_type": "models.unet.UNetEncoder",
         "n_fft": 512, "hop_length": 240, "channels": [8, 16],
         "strides": [4, 4], "lstm_hidden_size": 24,
         "num_layers": num_layers, "dropout": 0.0,
         "learn_voicing": True, "learn_f0": False, **backbone_kwargs},
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
                out[f"{k}[{i}]"] = s.data.float().numpy()
        else:
            out[k] = v.data.float().numpy()
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


# ---------------------------------------------------------------------------
# the encoder's options
# ---------------------------------------------------------------------------

OPTIONS = {
    "lru": {"use_lru": True},
    "env": {"sample_rate": 24000, "include_env_features": True,
            "num_harmonics": 64},
    "bf16": {"compute_dtype": "bfloat16"},
}
# the LRU's first emission waits this many frames (golf_tpu's chunked LRU
# test); the BiLSTM's look-ahead is the served one
LOOKAHEAD = {"lru": 8, "env": 24, "bf16": 24}


@pytest.fixture(scope="module", params=list(OPTIONS))
def option_encoders(request):
    kw = OPTIONS[request.param]
    j_enc = _make_encoder(num_layers=2, **kw)
    x, f0 = _inputs(b=2, t=24000)
    vs = _init(j_enc, x, f0)
    return request.param, j_enc, vs, _port_encoder(2, vs, **kw), x, f0


def test_stream_encoder_option_matches_golf_tpu(option_encoders):
    """Under each option, push by push and the flush, the port's stream
    against golf_tpu's StreamingEncoder on the same weights: the fp32
    options within 1e-4 of each leaf's max-abs, as above; bf16 (both
    streams step flax's bf16 cell: gates in bf16) within twice golf_tpu's
    own distance between its bf16 and fp32 streams plus one bf16 step
    (2^-8 of max-abs), and, summed over the leaves, at least half
    golf_tpu's own distance from golf_tpu's fp32 stream (a stream that
    stepped in fp32 would sit at fp32 parity)."""
    name, j_enc, vs, t_enc, x, f0 = option_encoders
    lookahead = LOOKAHEAD[name]
    ref, n_ref = _stream_raw(j_enc, vs, x, f0, lookahead=lookahead)
    ref = _leaves(ref)
    got, n_got = _port_stream_raw(t_enc, x, f0, lookahead)
    assert n_got == n_ref and set(got) == set(ref)
    if name == "bf16":
        j32 = _make_encoder(num_layers=2)
        ref32 = _leaves(_stream_raw(j32, vs, x, f0, lookahead=lookahead)[0])
    own_sum, far_sum = 0.0, 0.0
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        scale = np.abs(ref[k]).max() + 1e-9
        err = np.abs(got[k] - ref[k]).max() / scale
        if name == "bf16":
            own = np.abs(ref[k] - ref32[k]).max() / scale
            assert err <= 2 * own + 2 ** -8, (k, err, own)
            own_sum += own
            far_sum += np.abs(got[k] - ref32[k]).max() / scale
        else:
            assert err < 1e-4, (k, err)
    # the port's stream really steps in bf16: summed over the leaves, as
    # far from golf_tpu's fp32 stream as half golf_tpu's own distance
    assert far_sum >= 0.5 * own_sum, (far_sum, own_sum)


def test_stream_encoder_option_matches_port_offline(option_encoders):
    """Against the port's offline encoder on the whole utterance. Env
    features: the flushed rows within 1e-4 of each leaf's max-abs, every
    row within 2e-2 (the BiLSTM's backward truncation). LRU: the state is
    carried exactly, so only the first emission's predicted carry-in
    differs: every row within 2e-2 and the second half within 1e-3
    (golf_tpu's bounds, ``tests/test_enc_stream.py``). bf16: the stream's
    gates are bf16 where the offline encoder's are fp32 (golf_tpu's design),
    so the flushed rows are held within 2e-2."""
    name, _, _, t_enc, x, f0 = option_encoders
    with torch.no_grad():
        ref = _tleaves(t_enc(TSig(torch.from_numpy(x), 1),
                             TSig(torch.from_numpy(f0), 1)))
    got, n_flushed = _port_stream_raw(t_enc, x, f0, LOOKAHEAD[name])
    n = next(iter(ref.values())).shape[1]
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        scale = np.abs(ref[k]).max() + 1e-9
        rows = np.abs(got[k] - ref[k]).max(
            axis=tuple(i for i in range(ref[k].ndim) if i != 1)) / scale
        assert rows.max() < 2e-2, (k, rows.max())
        if name == "lru":
            assert rows[n // 2:].max() < 1e-3, (k, rows[n // 2:].max())
        elif name == "env":
            assert n_flushed > 0 and rows[n - n_flushed:].max() < 1e-4, k


def test_stream_encoder_lru_one_push_equals_offline():
    """The LRU backbone with the whole utterance in one push (a look-ahead
    longer than it, so the flush emits every row): the carry-in is then
    predicted from the utterance's last frame, as offline, and every row
    equals the port's offline encoder within 1e-5 of max-abs."""
    kw = OPTIONS["lru"]
    j_enc = _make_encoder(num_layers=2, **kw)
    x, f0 = _inputs(b=1, t=24000)
    t_enc = _port_encoder(2, _init(j_enc, x, f0), **kw)
    with torch.no_grad():
        ref = _tleaves(t_enc(TSig(torch.from_numpy(x), 1),
                             TSig(torch.from_numpy(f0), 1)))
    got, n_flushed = _port_stream_raw(t_enc, x, f0, 10 ** 6,
                                      chunk=x.shape[1])
    assert n_flushed == next(iter(ref.values())).shape[1]
    for k in ref:
        err = np.abs(got[k] - ref[k]).max() / (np.abs(ref[k]).max() + 1e-9)
        assert err < 1e-5, (k, err)

