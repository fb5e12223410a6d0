"""The constant-coefficient all-pole filter's adjoint and float64 mirrors
against golf_tpu, on the CPU.

* ``allpole_const_adjoint_plain`` (the CPU route's adjoint: golf_tpu's
  flipped run and shifted dots) against ``jax.vjp`` of
  ``golf_tpu.ops.allpole.allpole_const``; where golf_tpu's VJP raises
  (2 <= T < p: its slice ``y[:, :t - j - 1]`` wraps), against ``jax.vjp``
  through golf_tpu's sequential scan;
* the float64 mirrors of the CUDA kernels (``allpole_const_scan64``,
  ``allpole_const_adjoint_scan64``) against golf_tpu's forward and VJP and
  against autograd through ``allpole_scan`` in float64;
* the default CPU route is ``CONST_PLAIN_OPS``, bit for bit;
* on resonant constant filters (``resonant_const_inputs``) the mirrors
  stay within 1e-6 of a float64 scan.

Inputs are numpy-seeded and shared by both sides. The CUDA kernels are held
against these mirrors on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.ops.allpole import allpole_const as j_allpole_const
from golf_tpu.ops.allpole import allpole_scan as j_allpole_scan
from golf_tpu.ops.dsp import rc2lpc as j_rc2lpc
from golf_tpu_torch.ops import allpole as tap

torch.set_num_threads(1)

# (N, T, p): GOLF-ff's window and order, ragged sizes, T < p, T = 1
SHAPES = [(40, 300, 7), (16, 960, 22), (5, 50, 4), (3, 10, 22), (2, 1, 3)]


def _inputs(n, t, p, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t)).astype(np.float32)
    a = np.array(j_rc2lpc(jnp.tanh(jnp.asarray(
        0.2 * rng.standard_normal((n, p)).astype(np.float32)))))
    g = rng.standard_normal((n, t)).astype(np.float32)
    return x, a, g


def _golf_tpu_vjp_raises(t, p):
    """golf_tpu's VJP slices y[:, :t - j - 1]: for t <= j <= 2t - 2 the
    slice wraps and the shapes do not broadcast."""
    return 2 <= t < p


def _reference(x, a, g):
    """(y, dx, da) of golf_tpu: ``jax.vjp`` of its ``allpole_const``, or,
    where that raises, of its sequential scan with a broadcast over time."""
    t, p = x.shape[1], a.shape[1]
    if _golf_tpu_vjp_raises(t, p):
        def fn(x_, a_):
            return j_allpole_scan(x_, jnp.broadcast_to(a_[:, None, :],
                                                       (x.shape[0], t, p)))
    else:
        fn = j_allpole_const

    def run(g_, x_, a_):
        out, vjp = jax.vjp(fn, x_, a_)
        return (out, *vjp(g_))
    return [np.asarray(v) for v in jax.jit(run)(
        jnp.asarray(g), jnp.asarray(x), jnp.asarray(a))]


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    return float(np.abs(out - ref).max() / scale) if scale else \
        float(np.abs(out).max())


@pytest.mark.parametrize("n,t,p", SHAPES)
def test_adjoint_plain_matches_golf_tpu_vjp(n, t, p):
    x, a, g = _inputs(n, t, p, seed=n + t + p)
    _, dx_j, da_j = _reference(x, a, g)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    y = tap.allpole_const_plain(xt, at)
    dx, da = tap.allpole_const_adjoint_plain(torch.from_numpy(g), y, at)
    # the same blocked form (the scan for short rows) on both sides; da
    # sums T products a tap: 1e-5 of each one's max-abs
    assert dx.shape == (n, t) and da.shape == (n, p)
    assert _rel(dx, dx_j) < 1e-5
    assert _rel(da, da_j) < 1e-5
    dx_only, none = tap.allpole_const_adjoint_plain(torch.from_numpy(g), y,
                                                    at, False)
    assert none is None and torch.equal(dx_only, dx)


def test_golf_tpu_const_vjp_raises_where_the_port_repairs_it():
    """golf_tpu's VJP fails for 2 <= T < p; the port's composite stops the
    slice at 0 and gives the scan's gradient (checked above)."""
    x, a, g = _inputs(3, 10, 22, seed=0)
    with pytest.raises(TypeError):
        jax.vjp(j_allpole_const, jnp.asarray(x), jnp.asarray(a))[1](
            jnp.asarray(g))


@pytest.mark.parametrize("n,t,p", SHAPES)
def test_float64_mirrors_match_golf_tpu(n, t, p):
    x, a, g = _inputs(n, t, p, seed=2 * (n + t + p))
    y_j, dx_j, da_j = _reference(x, a, g)
    xt, at, gt = (torch.from_numpy(v) for v in (x, a, g))
    y = tap.allpole_const_scan64(xt, at)
    dx, da = tap.allpole_const_adjoint_scan64(gt, y, at)
    assert y.dtype == dx.dtype == da.dtype == torch.float32
    # float64 recurrence vs golf_tpu's float32 forms at the model's scale
    # (logits 0.2): 1e-5 of each one's max-abs
    assert _rel(y, y_j) < 1e-5
    assert _rel(dx, dx_j) < 1e-5
    assert _rel(da, da_j) < 1e-5


@pytest.mark.parametrize("n,t,p", [(3, 200, 6), (4, 60, 22), (2, 5, 9)])
def test_float64_mirrors_match_autograd_through_the_scan(n, t, p):
    rng = np.random.default_rng(t + p)
    x = torch.from_numpy(rng.standard_normal((n, t))).requires_grad_()
    a = torch.from_numpy(0.15 * rng.standard_normal((n, p))
                         ).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((n, t)))
    y_ref = tap.allpole_scan(x, a[:, None, :].expand(n, t, p))
    dx_ref, da_ref = torch.autograd.grad(y_ref, (x, a), g)
    with torch.no_grad():
        y = tap.allpole_const_scan64(x, a)
        dx, da = tap.allpole_const_adjoint_scan64(g, y, a)
    # float64 throughout: they differ only by rounding
    for out, ref in ((y, y_ref), (dx, dx_ref), (da, da_ref)):
        assert out.dtype == torch.float64
        assert ((out - ref).abs().max() / ref.abs().max()).item() < 1e-10


@pytest.mark.parametrize("n,t,p", [(16, 960, 22), (3, 10, 22)])
def test_cpu_route_is_the_plain_ops_bit_for_bit(n, t, p):
    x, a, g = _inputs(n, t, p, seed=5)
    results = []
    for ops in (None, tap.CONST_PLAIN_OPS):
        xt = torch.from_numpy(x).requires_grad_()
        at = torch.from_numpy(a).requires_grad_()
        y = tap.allpole_const(xt, at, ops)
        y.backward(torch.from_numpy(g))
        results.append((y.detach(), xt.grad, at.grad))
    for u, v in zip(*results):
        assert torch.equal(u, v)


@pytest.mark.parametrize("cap", [0.95, None])
@pytest.mark.parametrize("seed", [0, 1])
def test_float64_mirrors_on_resonant_filters(cap, seed):
    x, a = tap.resonant_const_inputs(seed, cap=cap)
    n, t = x.shape
    g = torch.from_numpy(np.random.default_rng(seed + 10).standard_normal(
        (n, t)).astype(np.float32))
    a_tv = a[:, None, :].expand(n, t, a.shape[1]).double()
    ref = tap.allpole_scan(x.double(), a_tv)
    dx_ref = torch.flip(tap.allpole_scan(torch.flip(g, (1,)).double(), a_tv),
                        (1,))
    y = tap.allpole_const_scan64(x, a)
    dx, da = tap.allpole_const_adjoint_scan64(g, y, a)
    assert torch.isfinite(ref).all() and torch.isfinite(dx_ref).all()
    assert torch.isfinite(y).all() and torch.isfinite(dx).all() and \
        torch.isfinite(da).all()
    # the same float64 recurrence, fp32 out: 1e-6 of max-abs
    assert _rel(y, ref) < 1e-6
    assert _rel(dx, dx_ref) < 1e-6
