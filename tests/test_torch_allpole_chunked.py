"""The time-varying kernel's algorithm in plain PyTorch
(``allpole_chunked_plain``: float64 chunk maps, float64 carry, float64
re-run) against golf_tpu, on the CPU.

* forward against ``golf_tpu.ops.allpole.allpole_scan`` and the adjoint
  entry's indexing (``adjoint=True``) against ``jax.vjp`` of
  ``golf_tpu.ops.allpole.allpole``, at the model's scale (0.2), over ragged
  lengths, T shorter than a chunk, T = 1 and orders 5, 22, 40;
* on resonant filters (``resonant_inputs``, capped at 0.95 and uncapped)
  its error against a float64 scan is no larger than golf_tpu's float32
  scan's.

Inputs are numpy-seeded and shared by both sides. The CUDA kernel is held
against this mirror on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.ops.allpole import allpole as j_allpole
from golf_tpu.ops.allpole import allpole_scan as j_allpole_scan
from golf_tpu.ops.dsp import rc2lpc as j_rc2lpc
from golf_tpu_torch.ops import allpole as tap

torch.set_num_threads(1)

ORDERS = [5, 22, 40]
# (B, T, chunk): ragged T with several chunks, T < chunk, T = 1, and the
# kernel's own chunk length on a ragged T
SHAPES = [(2, 300, 64), (3, 100, 256), (2, 1, 256), (2, 600, tap.CHUNK)]
RESONANT = [(0.95, 0), (0.95, 1), (None, 0), (None, 2)]


def _inputs(b, t, p, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t)).astype(np.float32)
    a = np.array(j_rc2lpc(jnp.tanh(jnp.asarray(
        0.2 * rng.standard_normal((b, t, p)).astype(np.float32)))))
    return x, a


@jax.jit
def _j_dx(x, a, g):
    """dx of golf_tpu's custom VJP (jitted: eagerly it takes ~20 s)."""
    return jax.vjp(j_allpole, x, a)[1](g)[0]


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("p", ORDERS)
@pytest.mark.parametrize("b,t,chunk", SHAPES)
def test_chunked_matches_golf_tpu_scan(b, t, chunk, p):
    x, a = _inputs(b, t, p, seed=t + p)
    ref = np.asarray(j_allpole_scan(jnp.asarray(x), jnp.asarray(a)))
    y = tap.allpole_chunked_plain(torch.from_numpy(x), torch.from_numpy(a),
                                  chunk)
    assert y.shape == (b, t) and y.dtype == torch.float32
    # float64 chunked form vs golf_tpu's float32 scan: 1e-5 of max|y|
    assert _rel(y, ref) < 1e-5


@pytest.mark.parametrize("p", ORDERS)
@pytest.mark.parametrize("b,t,chunk", SHAPES)
def test_chunked_adjoint_matches_golf_tpu_vjp(b, t, chunk, p):
    x, a = _inputs(b, t, p, seed=2 * t + p)
    g = np.random.default_rng(t).standard_normal((b, t)).astype(np.float32)
    dx = tap.allpole_chunked_plain(torch.from_numpy(g), torch.from_numpy(a),
                                   chunk, adjoint=True)
    if t == 1:
        # one step has no tap: dx is g (golf_tpu's column shift needs T > 1)
        assert torch.equal(dx, torch.from_numpy(g))
        return
    dx_ref = np.asarray(_j_dx(jnp.asarray(x), jnp.asarray(a),
                              jnp.asarray(g)))
    # the transposed filter read in place vs golf_tpu's flipped,
    # column-shifted run: 1e-5 of max|dx|
    assert _rel(dx, dx_ref) < 1e-5


@pytest.mark.parametrize("cap,seed", RESONANT)
def test_chunked_resonant_error_within_float32_scan(cap, seed):
    x, a = tap.resonant_inputs(seed, cap=cap)
    ref = tap.allpole_scan(x.double(), a.double())
    err32 = _rel(j_allpole_scan(jnp.asarray(x.numpy()),
                                jnp.asarray(a.numpy())), ref)
    # the seeds are ones chip_smoke.py's resonant phase would take: a
    # finite float64 output and a float32 scan off by at least 1e-5
    assert torch.isfinite(ref).all() and err32 >= 1e-5
    err = _rel(tap.allpole_chunked_plain(x, a), ref)
    assert err <= err32, (err, err32)


# the shapes whose chunk length chunk_for picks on the main path: a push
# (4|1, 2400) and a time shard's window (64|32|16, 24 000); each case runs
# that length at B = 2 on one ragged T (three 512-chunks and a tail: one
# compile of golf_tpu's scan for every case)
CHUNK_FOR_SHAPES = [(4, 2400), (1, 2400), (64, 24000), (32, 24000),
                    (16, 24000)]


def _torch_inputs(b, t, p, seed):
    """``_inputs`` with the port's rc2lpc (no JAX dispatch)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32))
    a = tap.rc2lpc(torch.tanh(torch.from_numpy(
        0.2 * rng.standard_normal((b, t, p)).astype(np.float32))))
    return x, a.contiguous()


@pytest.mark.parametrize("shape", CHUNK_FOR_SHAPES)
def test_chunk_for_length_matches_golf_tpu_scan_from_zi(shape):
    chunk = tap.chunk_for(*shape)
    assert chunk in (tap.CHUNK,) + tap.SHORT_CHUNKS
    b, t, p = 2, 3 * tap.CHUNK + 17, 22
    x, a = (u.numpy() for u in _torch_inputs(b, t, p, seed=chunk))
    zi = (0.5 * np.random.default_rng(chunk).standard_normal((b, p))
          ).astype(np.float32)
    ref = np.asarray(j_allpole_scan(jnp.asarray(x), jnp.asarray(a),
                                    jnp.asarray(zi)))
    y = tap.allpole_chunked_plain(torch.from_numpy(x), torch.from_numpy(a),
                                  chunk, zi=torch.from_numpy(zi))
    # float64 chunked form from zi vs golf_tpu's float32 scan from zi
    assert _rel(y, ref) < 1e-5


def test_chunk_for_fills_the_card_and_keeps_512_at_scale():
    """512 at the training, serving and B = 64 | 32 shard shapes; a
    shorter chunk where 512 leaves the 132 SMs' one-warp CTAs too few."""
    for b, t in ((64, 47760), (4, 143761), (64, 24000), (32, 24000)):
        assert tap.chunk_for(b, t) == tap.CHUNK
    for b, t in ((16, 24000), (4, 2400), (1, 2400)):
        chunk = tap.chunk_for(b, t)
        assert chunk < tap.CHUNK
        assert b * -(-t // chunk) >= tap.FILL_CTAS or \
            chunk == tap.SHORT_CHUNKS[-1]


def test_rerun_chunks_pairs_where_the_paired_grid_fills_the_card():
    """Two chunks a CTA of phase 3 at p = 22 where B ceil(T / L) reaches
    twice ``FILL_CTAS`` (the training shape, a (64, 24 000) shard), one
    elsewhere and at every other order."""
    for b, t in ((64, 47760), (64, 24000)):
        assert tap.rerun_chunks(b, t, 22) == 2
        assert tap.rerun_chunks(b, t, 16) == 1
    for b, t in ((4, 143761), (1, 144000), (32, 24000), (16, 24000),
                 (4, 2400), (1, 2400)):
        assert tap.rerun_chunks(b, t, 22) == 1


@pytest.mark.parametrize("b,t,p,chunk", [(2, 300, 22, 64), (3, 1000, 5, 128),
                                         (2, 129, 40, 64), (2, 50, 22, 64)])
def test_rerun_from_summary_maps_equals_the_zi_entry(b, t, p, chunk):
    """The re-run from the summary mirror's maps (every chunk's, the last
    one run over its steps below T only) equals ``allpole_chunked_plain``
    from zi bit for bit: the re-run reads the first chunks - 1 maps, which
    the forward entry forms alike."""
    x, a = _torch_inputs(b, t, p, seed=b * t + p)
    zi = torch.from_numpy(np.random.default_rng(p).standard_normal(
        (b, p)).astype(np.float32))
    _, _, maps = tap.allpole_summary_chunked_plain(x, a, chunk)
    assert maps.shape == (b, -(-t // chunk), p + 1, p)
    assert maps.dtype == torch.float64
    y = tap.allpole_rerun_plain(x, a, zi, maps, chunk)
    assert torch.equal(y, tap.allpole_chunked_plain(x, a, chunk, zi=zi))
