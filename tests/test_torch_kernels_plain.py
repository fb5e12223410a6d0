"""The port's plain kernel versions against golf_tpu, on the CPU.

Lookup: ``lookup_blocks_plain`` vs ``_lookup_blocks_jnp`` and the Pallas
kernel in interpret mode. All-pole: ``allpole_const_plain`` /
``allpole_plain`` vs the Pallas kernels in interpret mode and
``allpole_scan``. Inputs are numpy-seeded and shared by both sides. The
CUDA kernels themselves are compared with these plain versions by
``test_torch_cuda.py`` (on the card) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.models.synth import _lookup_blocks_jnp
from golf_tpu.ops.allpole import allpole_scan as jax_allpole_scan
from golf_tpu.ops.allpole_pallas import allpole_const_pallas, allpole_pallas
from golf_tpu.ops.dsp import rc2lpc as jax_rc2lpc
from golf_tpu.ops.lookup_pallas import bilinear_lookup_pallas
from golf_tpu_torch.ops import allpole as tap
from golf_tpu_torch.ops.lookup import (lookup_blocks, lookup_blocks_cuda,
                                       lookup_blocks_plain)

torch.set_num_threads(1)

LOOKUP_SHAPES = [
    (2, 5, 256, 2048),
    (1, 3, 2400, 2048),
    (1, 8, 130, 256),
    (3, 16, 128, 512),
]


def _lookup_inputs(b, blocks, hop, s, seed=0):
    r = np.random.default_rng(seed)
    ph = r.random((b, blocks, hop), np.float32)
    ph[:, :, :4] = np.float32(1.0 - 1e-4)      # exercise the wrap column
    tabs = r.standard_normal((b, blocks + 1, s)).astype(np.float32)
    return ph, tabs


@pytest.mark.parametrize("b,blocks,hop,s", LOOKUP_SHAPES + [(2, 4, 240, 1000)])
def test_lookup_plain_matches_jnp(b, blocks, hop, s):
    # same expressions in the same order: equal up to one fp32 rounding of
    # the (1 - w) terms, far below the 1e-6 stated here
    ph, tabs = _lookup_inputs(b, blocks, hop, s)
    ref = np.asarray(_lookup_blocks_jnp(jnp.asarray(ph), jnp.asarray(tabs),
                                        hop))
    out = lookup_blocks_plain(torch.from_numpy(ph), torch.from_numpy(tabs),
                              hop).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("b,blocks,hop,s", LOOKUP_SHAPES)
def test_lookup_plain_matches_pallas_interpret(b, blocks, hop, s):
    # the Pallas kernel multiplies by 1/hop where the port divides: 3e-6,
    # the tolerance of golf_tpu's own kernel test
    ph, tabs = _lookup_inputs(b, blocks, hop, s, seed=1)
    ref = np.asarray(bilinear_lookup_pallas(jnp.asarray(ph),
                                            jnp.asarray(tabs), hop, True))
    out = lookup_blocks(torch.from_numpy(ph), torch.from_numpy(tabs),
                        hop).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-6, rtol=0)


def _lpc(rng, shape, scale):
    return np.array(jax_rc2lpc(jnp.tanh(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32) * scale))))


@pytest.mark.parametrize("b,t,p,tb", [(3, 500, 5, 128), (1, 130, 22, 64),
                                      (130, 64, 3, 32)])
def test_allpole_plain_matches_pallas_and_scan(b, t, p, tb):
    rng = np.random.default_rng(b * 100 + p)
    x = rng.standard_normal((b, t)).astype(np.float32)
    a = _lpc(rng, (b, t, p), 0.2)
    y_scan = np.asarray(jax_allpole_scan(jnp.asarray(x), jnp.asarray(a)))
    y_pallas = np.asarray(allpole_pallas(jnp.asarray(x), jnp.asarray(a),
                                         time_block=tb, interpret=True))
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    scale = np.abs(y_scan).max()
    # the plain version (blocked two-pass for t > 64) vs the sequential
    # forms: 1e-5 of max|y| (golf_tpu's Pallas-vs-scan tolerance)
    y = tap.allpole(xt, at).numpy()
    assert np.abs(y - y_scan).max() / scale < 1e-5
    assert np.abs(y - y_pallas).max() / scale < 1e-5
    # the port's own scan vs golf_tpu's: same recurrence, 1e-6
    y_port_scan = tap.allpole_scan(xt, at).numpy()
    assert np.abs(y_port_scan - y_scan).max() / scale < 1e-6


@pytest.mark.parametrize("n,t,p", [(200, 300, 7), (64, 480, 22)])
def test_allpole_const_plain_matches_pallas_and_scan(n, t, p):
    rng = np.random.default_rng(5 + p)
    a = _lpc(rng, (n, p), 0.2)
    x = rng.standard_normal((n, t)).astype(np.float32)
    a_tv = jnp.broadcast_to(jnp.asarray(a)[:, None, :], (n, t, p))
    y_scan = np.asarray(jax_allpole_scan(jnp.asarray(x), a_tv))
    y_pallas = np.asarray(allpole_const_pallas(
        jnp.asarray(x), jnp.asarray(a), time_block=64, batch_block=128,
        interpret=True))
    y = tap.allpole_const(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    scale = np.abs(y_scan).max()
    assert np.abs(y - y_scan).max() / scale < 1e-5
    assert np.abs(y - y_pallas).max() / scale < 1e-5


def test_allpole_blocked_matches_golf_tpu_blocked():
    """The port's blocked forms follow golf_tpu's, including where the
    two-pass form loses accuracy on a high-gain filter."""
    from golf_tpu.ops.allpole import _allpole_blocked, _allpole_const_blocked
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 300)).astype(np.float32)
    a = _lpc(rng, (2, 300, 6), 0.3)
    zi = np.zeros((2, 6), np.float32)
    ref = np.asarray(_allpole_blocked(jnp.asarray(x), jnp.asarray(a),
                                      jnp.asarray(zi), 16))
    out = tap._allpole_blocked(torch.from_numpy(x), torch.from_numpy(a),
                               torch.from_numpy(zi), 16).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    ac = _lpc(rng, (3, 6), 0.3)
    xc = rng.standard_normal((3, 300)).astype(np.float32)
    ref = np.asarray(_allpole_const_blocked(jnp.asarray(xc),
                                            jnp.asarray(ac), 16))
    out = tap._allpole_const_blocked(torch.from_numpy(xc),
                                     torch.from_numpy(ac), 16).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tap.allpole_cuda(x, torch.zeros(2, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tap.allpole_const_cuda(x, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        lookup_blocks_cuda(torch.zeros(1, 2, 4), torch.zeros(1, 3, 8), 4)
