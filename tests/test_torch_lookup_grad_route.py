"""Which forward the differentiable lookup runs, on the CPU.

``ops.lookup.lookup_blocks`` runs B3a (the forward with the corner
differences) only when the phase needs a gradient; when only the tables
do (the phase of the true f0, as on the Interspeech24 path) it runs B1 and
the backward forms the table cotangent alone. Held with a counting
``LookupOps`` over the plain versions, against the residual route bit for
bit and against ``jax.vjp`` of golf_tpu's ``_lookup_blocks_jnp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.models.synth import _lookup_blocks_jnp
from golf_tpu_torch.ops import lookup as tlk

torch.set_num_threads(1)

# (B, blocks, hop, S)
SHAPES = [(2, 5, 256, 2048), (1, 3, 2400, 2048), (3, 4, 999, 512)]


def _inputs(b, blocks, hop, s, seed):
    r = np.random.default_rng(seed)
    ph = r.random((b, blocks, hop), np.float32)
    ph[:, :, :4] = np.float32(1.0 - 1e-4)      # the wrap column
    tabs = r.standard_normal((b, blocks + 1, s)).astype(np.float32)
    g = r.standard_normal((b, blocks, hop)).astype(np.float32)
    return ph, tabs, g


def _counting_ops(calls):
    return tlk.LookupOps(
        *(lambda *a, _f=f, _n=n: (calls.append(_n), _f(*a))[1]
          for f, n in zip(tlk.PLAIN_OPS, ("fwd", "res", "dtab"))))


def _jax_vjp(ph, tabs, g, hop):
    def run(g_, p, t):
        out, vjp = jax.vjp(lambda p_, t_: _lookup_blocks_jnp(p_, t_, hop),
                           p, t)
        return out, vjp(g_)
    out, (dph, dtab) = jax.jit(run)(jnp.asarray(g), jnp.asarray(ph),
                                    jnp.asarray(tabs))
    return np.asarray(out), np.asarray(dph), np.asarray(dtab)


def _rel(out, ref):
    return np.abs(np.asarray(out) - np.asarray(ref)).max() / \
        np.abs(np.asarray(ref)).max()


def _route(ph, tabs, g, hop, phase_grad):
    calls = []
    ph_t = torch.from_numpy(ph).requires_grad_(phase_grad)
    tab_t = torch.from_numpy(tabs).requires_grad_()
    out = tlk.lookup_blocks(ph_t, tab_t, hop, _counting_ops(calls))
    inputs = (ph_t, tab_t) if phase_grad else (tab_t,)
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    return calls, out.detach(), grads


@pytest.mark.parametrize("b,blocks,hop,s", SHAPES)
def test_tables_only_gradient_runs_b1_not_b3a(b, blocks, hop, s):
    ph, tabs, g = _inputs(b, blocks, hop, s, seed=10)
    calls, out, (dtab,) = _route(ph, tabs, g, hop, phase_grad=False)
    assert calls == ["fwd", "dtab"]
    # the residual route on the same inputs: the same output and table
    # cotangent, bit for bit (B1 and B3a share their expressions)
    calls_res, out_res, (_, dtab_res) = _route(ph, tabs, g, hop,
                                               phase_grad=True)
    assert calls_res == ["res", "dtab"]
    assert torch.equal(out, out_res)
    assert torch.equal(dtab, dtab_res)


@pytest.mark.parametrize("b,blocks,hop,s", SHAPES)
def test_tables_only_gradient_matches_jax_vjp(b, blocks, hop, s):
    ph, tabs, g = _inputs(b, blocks, hop, s, seed=11)
    out_j, _, dtab_j = _jax_vjp(ph, tabs, g, hop)
    _, out, (dtab,) = _route(ph, tabs, g, hop, phase_grad=False)
    # 1e-5 of max-abs: rw by division vs golf_tpu's, the table cotangent's
    # sums in another order
    assert _rel(out, out_j) < 1e-5
    assert _rel(dtab, dtab_j) < 1e-5


@pytest.mark.parametrize("b,blocks,hop,s", SHAPES)
def test_phase_gradient_runs_b3a_once(b, blocks, hop, s):
    ph, tabs, g = _inputs(b, blocks, hop, s, seed=12)
    out_j, dph_j, dtab_j = _jax_vjp(ph, tabs, g, hop)
    calls, out, (dph, dtab) = _route(ph, tabs, g, hop, phase_grad=True)
    assert calls.count("res") == 1 and "fwd" not in calls
    assert _rel(out, out_j) < 1e-5
    assert _rel(dph, dph_j) < 1e-5
    assert _rel(dtab, dtab_j) < 1e-5


def test_no_gradient_runs_b1_without_the_function():
    ph, tabs, _ = _inputs(1, 3, 64, 128, seed=13)
    calls = []
    tab_t = torch.from_numpy(tabs).requires_grad_()
    with torch.no_grad():
        out = tlk.lookup_blocks(torch.from_numpy(ph), tab_t, 64,
                                _counting_ops(calls))
    assert calls == ["fwd"] and out.grad_fn is None
