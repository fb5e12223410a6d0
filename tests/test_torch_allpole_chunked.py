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
