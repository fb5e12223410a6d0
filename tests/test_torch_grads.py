"""The port's adjoints against golf_tpu, on the CPU.

* B3a's and B3b's plain versions (``lookup_res_plain``,
  ``lookup_dtab_plain``) against golf_tpu's Pallas kernels in interpret
  mode and against ``jax.vjp`` of ``_lookup_blocks_jnp``;
* the four ``torch.autograd.Function``s (lookup, allpole, allpole_const,
  wrapped_cumsum) against ``jax.vjp`` of golf_tpu's functions with custom
  VJPs, and against autograd through the plain forward in float64.

Inputs are numpy-seeded and shared by both sides. The CUDA kernels are held
against these plain versions by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.models.synth import _lookup_blocks_jnp
from golf_tpu.ops.allpole import allpole as j_allpole
from golf_tpu.ops.allpole import allpole_const as j_allpole_const
from golf_tpu.ops.dsp import rc2lpc as j_rc2lpc
from golf_tpu.ops.dsp import wrapped_cumsum as j_wrapped_cumsum
from golf_tpu.ops.lookup_pallas import (bilinear_lookup_pallas_dtab,
                                        bilinear_lookup_pallas_res)
from golf_tpu_torch.ops import allpole as tap
from golf_tpu_torch.ops import lookup as tlk
from golf_tpu_torch.ops.dsp import wrapped_cumsum

torch.set_num_threads(1)

# test_torch_kernels_plain.py's lookup shapes: (B, blocks, hop, S)
LOOKUP_SHAPES = [
    (2, 5, 256, 2048),
    (1, 3, 2400, 2048),
    (1, 8, 130, 256),
    (3, 16, 128, 512),
]


def _lookup_inputs(b, blocks, hop, s, seed, extra_rows=0):
    r = np.random.default_rng(seed)
    ph = r.random((b, blocks, hop), np.float32)
    ph[:, :, :4] = np.float32(1.0 - 1e-4)      # exercise the wrap column
    tabs = r.standard_normal((b, blocks + 1 + extra_rows, s)).astype(
        np.float32)
    g = r.standard_normal((b, blocks, hop)).astype(np.float32)
    return ph, tabs, g


def _jax_vjp(fn, g, *args):
    """(fn(*args), vjp(g)), jitted: eager custom VJPs compile piece by
    piece, ten times slower."""
    def run(g_, *a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(g_)
    out, grads = jax.jit(run)(jnp.asarray(g), *map(jnp.asarray, args))
    return (out, *grads)


def _rel(out, ref):
    return np.abs(np.asarray(out) - np.asarray(ref)).max() / \
        np.abs(np.asarray(ref)).max()


@pytest.mark.parametrize("b,blocks,hop,s", LOOKUP_SHAPES)
def test_lookup_res_plain_matches_pallas_interpret(b, blocks, hop, s):
    ph, tabs, _ = _lookup_inputs(b, blocks, hop, s, seed=2)
    ref = bilinear_lookup_pallas_res(jnp.asarray(ph), jnp.asarray(tabs),
                                     hop, True)
    out = tlk.lookup_res_plain(torch.from_numpy(ph), torch.from_numpy(tabs),
                               hop)
    # out: the Pallas kernel multiplies by 1/hop where the port divides,
    # 3e-6 as in test_torch_kernels_plain.py; the residuals are differences
    # of the same gathered values (the one-hot dots select them exactly)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               atol=3e-6, rtol=0)
    for o, r_ in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r_), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("b,blocks,hop,s", LOOKUP_SHAPES)
def test_lookup_dtab_plain_matches_pallas_interpret(b, blocks, hop, s):
    ph, tabs, g = _lookup_inputs(b, blocks, hop, s, seed=3, extra_rows=2)
    ref = np.asarray(bilinear_lookup_pallas_dtab(
        jnp.asarray(ph), jnp.asarray(g), hop, jnp.asarray(tabs), True))
    out = tlk.lookup_dtab_plain(torch.from_numpy(ph), torch.from_numpy(g),
                                hop, tabs.shape[1], s).numpy()
    assert out.shape == tabs.shape
    # sums in another order (scatter_add vs one-hot dots) and rw by
    # division vs 1/hop: 1e-5 of the largest entry
    assert _rel(out, ref) < 1e-5
    assert not out[:, blocks + 1:].any()       # rows past blocks+1 get 0


@pytest.mark.parametrize("b,blocks,hop,s", LOOKUP_SHAPES)
def test_lookup_function_matches_jax_vjp(b, blocks, hop, s):
    ph, tabs, g = _lookup_inputs(b, blocks, hop, s, seed=4)
    out_j, dph_j, dtab_j = _jax_vjp(
        lambda p, t: _lookup_blocks_jnp(p, t, hop), g, ph, tabs)
    ph_t = torch.from_numpy(ph).requires_grad_()
    tab_t = torch.from_numpy(tabs).requires_grad_()
    out = tlk.lookup_blocks(ph_t, tab_t, hop)
    dph, dtab = torch.autograd.grad(out, (ph_t, tab_t), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-6, rtol=0)
    # the phase cotangent is g*S*(...): 1e-5 of its largest entry; the
    # table cotangent sums hop*4/S terms a column in another order: 1e-5
    assert _rel(dph, dph_j) < 1e-5
    assert _rel(dtab, dtab_j) < 1e-5


def test_lookup_function_runs_the_residual_forward():
    """With a phase gradient the forward is B3a's function and the
    backward B3b's and dph_from_res; without any gradient the forward is
    B1's (a tables-only gradient: tests/test_torch_lookup_grad_route.py)."""
    ph, tabs, g = _lookup_inputs(1, 3, 64, 128, seed=5)
    calls = []
    ops = tlk.LookupOps(
        *(lambda *a, _f=f, _n=n: (calls.append(_n), _f(*a))[1]
          for f, n in zip(tlk.PLAIN_OPS, ("fwd", "res", "dtab"))))
    tab_t = torch.from_numpy(tabs).requires_grad_()
    ph_t = torch.from_numpy(ph).requires_grad_()
    out = tlk.lookup_blocks(ph_t, tab_t, 64, ops)
    out.backward(torch.from_numpy(g))
    assert calls == ["res", "dtab"] and ph_t.grad is not None
    with torch.no_grad():
        tlk.lookup_blocks(torch.from_numpy(ph), tab_t, 64, ops)
    assert calls[-1] == "fwd"


def _lpc(rng, shape, scale):
    return np.array(j_rc2lpc(jnp.tanh(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32) * scale))))


@pytest.mark.parametrize("b,t,p", [(2, 500, 5), (3, 130, 22), (2, 40, 3)])
def test_allpole_function_matches_jax_vjp(b, t, p):
    rng = np.random.default_rng(b * 100 + p)
    x = rng.standard_normal((b, t)).astype(np.float32)
    a = _lpc(rng, (b, t, p), 0.2)
    g = rng.standard_normal((b, t)).astype(np.float32)
    y_j, dx_j, da_j = _jax_vjp(j_allpole, g, x, a)
    xt = torch.from_numpy(x).requires_grad_()
    at = torch.from_numpy(a).requires_grad_()
    y = tap.allpole(xt, at)
    dx, da = torch.autograd.grad(y, (xt, at), torch.from_numpy(g))
    # the same blocked two-pass form on both sides (the scan for t <= 64):
    # 1e-5 of the largest entry
    assert _rel(y.detach(), y_j) < 1e-5
    assert _rel(dx, dx_j) < 1e-5
    assert _rel(da, da_j) < 1e-5


@pytest.mark.parametrize("n,t,p", [(40, 300, 7), (16, 960, 22), (5, 50, 4)])
def test_allpole_const_function_matches_jax_vjp(n, t, p):
    rng = np.random.default_rng(n + p)
    x = rng.standard_normal((n, t)).astype(np.float32)
    a = _lpc(rng, (n, p), 0.2)
    g = rng.standard_normal((n, t)).astype(np.float32)
    y_j, dx_j, da_j = _jax_vjp(j_allpole_const, g, x, a)
    xt = torch.from_numpy(x).requires_grad_()
    at = torch.from_numpy(a).requires_grad_()
    y = tap.allpole_const(xt, at)
    dx, da = torch.autograd.grad(y, (xt, at), torch.from_numpy(g))
    # da sums T products per coefficient: 1e-5 of the largest entry
    assert _rel(y.detach(), y_j) < 1e-5
    assert _rel(dx, dx_j) < 1e-5
    assert _rel(da, da_j) < 1e-5


@pytest.mark.parametrize("const", [False, True])
def test_allpole_adjoints_match_autograd_through_the_scan(const):
    """The hand-written adjoints against autograd through the sequential
    scan, in float64: they differ only by rounding."""
    rng = np.random.default_rng(7)
    b, t, p = 3, 200, 6
    x = torch.from_numpy(rng.standard_normal((b, t))).requires_grad_()
    shape = (b, p) if const else (b, t, p)
    a = torch.from_numpy(0.15 * rng.standard_normal(shape)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((b, t)))
    fn = tap.allpole_const if const else tap.allpole
    got = torch.autograd.grad(fn(x, a), (x, a), g)
    a_tv = a[:, None, :].expand(b, t, p) if const else a
    ref = torch.autograd.grad(tap.allpole_scan(x, a_tv), (x, a), g)
    for u, v in zip(got, ref):
        assert (u - v).abs().max() / v.abs().max() < 1e-10


def test_wrapped_cumsum_function_matches_jax_vjp():
    rng = np.random.default_rng(9)
    x = (rng.random((2, 1000)) * 0.05).astype(np.float32)
    g = rng.standard_normal((2, 1000)).astype(np.float32)
    y_j, dx_j = _jax_vjp(lambda v: j_wrapped_cumsum(v, 240), g, x)
    xt = torch.from_numpy(x).requires_grad_()
    y = wrapped_cumsum(xt, 240)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-5, rtol=0)
    # the reversed cumsum of the same g in another order: 1e-5 relative
    assert _rel(dx, dx_j) < 1e-5
