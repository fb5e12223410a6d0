"""Frame-wise LPC synthesis and the constant IIR filters of the port against
golf_tpu on the CPU: ``ops.allpole.lfilter`` and ``lpc_synthesis``,
``models.lpc`` (``LPCSynth``, ``BatchLPCSynth``, ``BatchSecondOrderLPCSynth``)
and the allpass filters ``LTIComplexConjAllpassFilter`` and
``LTIRealCoeffAllpassFilter`` (alone, through the bridge, and as the
``room_filter`` of a GOLF decoder built from the registry). Inputs from a
numpy seed.

Tolerances: outputs within 1e-5 of max|y|, gradients within 1e-3 of each
gradient's max-abs (float32 on both sides; the plain all-pole forms are
golf_tpu's blocked form, summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.config.registry import instantiate as j_instantiate
from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models import lpc as j_lpc
from golf_tpu.ops import allpole as j_allpole
from golf_tpu.ops.dsp import params2biquads as j_params2biquads
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.config.registry import instantiate as t_instantiate
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.models import lpc as t_lpc
from golf_tpu_torch.ops import allpole as t_allpole
from golf_tpu_torch.ops.dsp import params2biquads as t_params2biquads

torch.set_num_threads(1)

FP32_TOL = 1e-5
GRAD_TOL = 1e-3


def _rel(got, ref):
    got, ref = (v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                for v in (got, ref))
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _grads(fn, arrays, w):
    """The port's fn on the arrays and the gradients of <fn(...), w>."""
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = fn(*ins)
    (y * torch.from_numpy(w)).sum().backward()
    return y, [v.grad for v in ins]


def _j_grads(fn, arrays, w):
    (_, y), g = jax.value_and_grad(
        lambda *a: (jnp.sum(fn(*a) * w), fn(*a)),
        argnums=tuple(range(len(arrays))), has_aux=True)(
            *(jnp.asarray(a) for a in arrays))
    return y, g


def _stable_a(seed, k):
    """[1, a1..a_{2k}]: k stable sections multiplied, poles of moderate
    magnitude (on resonant filters golf_tpu's float32 blocked all-pole form
    strays by percents; those are tests/test_torch_allpole_const.py's)."""
    p = np.tanh(_rand(seed, (2, k), 0.5)) * 0.6
    sections = np.asarray(j_params2biquads(jnp.asarray(p[0]),
                                           jnp.asarray(p[1])))
    a = np.array([1.0])
    for s in sections:
        a = np.convolve(a, s)
    return a.astype(np.float32)


@pytest.mark.parametrize("case", ["allpass16", "fir_iir"])
def test_lfilter_matches_golf_tpu(case):
    """``lfilter`` on (2, 3000): an allpass of order 16 (b = a reversed, as
    the allpass filters make it) and an IIR with a0 != 1 and a shorter
    numerator; output and the gradients of x, a and b."""
    x = _rand(0, (2, 3000))
    a = _stable_a(1, 8)
    b = a[::-1].copy()
    if case == "fir_iir":
        a = (a[:7] * 1.7).astype(np.float32)
        b = _rand(2, (4,))
    w = _rand(3, (2, 3000))
    y_ref, g_ref = _j_grads(j_allpole.lfilter, (x, a, b), w)
    y, g = _grads(t_allpole.lfilter, (x, a, b), w)
    assert _rel(y, y_ref) <= FP32_TOL
    for name, got, ref in zip(("x", "a", "b"), g, g_ref):
        assert _rel(got, ref) <= GRAD_TOL, name


def test_lpc_synthesis_matches_golf_tpu():
    x = _rand(4, (6, 500))
    gains = np.abs(_rand(5, (6,))) + 0.5
    a = np.stack([_stable_a(10 + i, 4)[1:] for i in range(6)])
    w = _rand(6, (6, 500))
    y_ref, g_ref = _j_grads(j_allpole.lpc_synthesis, (x, gains, a), w)
    y, g = _grads(t_allpole.lpc_synthesis, (x, gains, a), w)
    assert _rel(y, y_ref) <= FP32_TOL
    for name, got, ref in zip(("x", "gains", "a"), g, g_ref):
        assert _rel(got, ref) <= GRAD_TOL, name


HOP, FRAMES = 120, 26


def _lpc_inputs(seed, batch):
    ex = _rand(seed, (batch, HOP * FRAMES))
    gain = np.abs(_rand(seed + 1, (batch, FRAMES))) + 0.5
    a = np.stack([np.stack([_stable_a(100 * seed + 10 * b + f % 7, 4)[1:]
                            for f in range(FRAMES)]) for b in range(batch)])
    return ex, gain, a


@pytest.mark.parametrize("window_size", [None, 360],
                         ids=["default_window", "window360"])
def test_lpc_synth_matches_golf_tpu(window_size):
    """``LPCSynth`` (one sequence, the gain in column 0) and
    ``BatchLPCSynth``: output and the gradients of the excitation, gains
    and coefficients."""
    ex, gain, a = _lpc_inputs(20, 2)
    lpc = np.concatenate([gain[0][:, None], a[0]], axis=-1)
    j_one = j_lpc.LPCSynth(HOP, window_size)
    t_one = t_lpc.LPCSynth(HOP, window_size)
    y_ref = np.asarray(j_one(jnp.asarray(ex[0]), jnp.asarray(lpc)))
    y = t_one(torch.from_numpy(ex[0]), torch.from_numpy(lpc))
    assert y.shape == y_ref.shape and _rel(y, y_ref) <= FP32_TOL

    j_b = j_lpc.BatchLPCSynth(HOP, window_size)
    t_b = t_lpc.BatchLPCSynth(HOP, window_size)
    w = _rand(21, tuple(np.asarray(j_b(*(jnp.asarray(v)
                                         for v in (ex, gain, a)))).shape))
    y_ref, g_ref = _j_grads(j_b, (ex, gain, a), w)
    y, g = _grads(t_b, (ex, gain, a), w)
    assert _rel(y, y_ref) <= FP32_TOL
    for name, got, ref in zip(("ex", "gain", "a"), g, g_ref):
        assert _rel(got, ref) <= GRAD_TOL, name


def test_batch_second_order_lpc_synth_matches_golf_tpu():
    """The cascade of B2 at p = 2: four sections a frame, a0 != 1 (the
    sections are normalised), output and the gradients of the excitation,
    gains and sections."""
    ex, gain, _ = _lpc_inputs(30, 2)
    p = np.tanh(_rand(31, (2, 2, FRAMES, 4), 0.5)) * 0.6
    bi = np.asarray(j_params2biquads(jnp.asarray(p[0]), jnp.asarray(p[1])))
    bi = (bi * (1.0 + np.abs(_rand(32, (2, FRAMES, 4, 1))))).astype(
        np.float32)
    j_mod = j_lpc.BatchSecondOrderLPCSynth(HOP)
    t_mod = t_lpc.BatchSecondOrderLPCSynth(HOP)
    w = _rand(33, tuple(np.asarray(j_mod(*(jnp.asarray(v)
                                           for v in (ex, gain, bi)))).shape))
    y_ref, g_ref = _j_grads(j_mod, (ex, gain, bi), w)
    y, g = _grads(t_mod, (ex, gain, bi), w)
    assert _rel(y, y_ref) <= FP32_TOL
    for name, got, ref in zip(("ex", "gain", "biquads"), g, g_ref):
        assert _rel(got, ref) <= GRAD_TOL, name


ALLPASS = ("LTIComplexConjAllpassFilter", "LTIRealCoeffAllpassFilter")


@pytest.mark.parametrize("cls", ALLPASS)
def test_allpass_filter_matches_golf_tpu(cls):
    """Each allpass with 8 roots, golf_tpu's parameters (seeded) carried by
    the bridge: output, and the gradients of its two logit vectors and of
    the excitation; parameter names and shapes as golf_tpu's."""
    node = {"class_path": f"models.filters.{cls}",
            "init_args": {"num_roots": 8, "max_abs_value": 0.99}}
    j_mod = j_instantiate(node)
    t_mod = t_instantiate(node)
    x = _rand(40, (2, 3000))
    w = _rand(41, (2, 3000))
    params = j_mod.init(jax.random.key(0), JSig(jnp.asarray(x), 1))["params"]
    # logits of scale 0.3: poles of moderate magnitude (see _stable_a)
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(_rand(42, v.shape, 0.3)), params)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        n: tuple(p.shape) for n, p in t_mod.named_parameters()}

    def j_loss(p, xx):
        y = j_mod.apply({"params": p}, JSig(xx, 1)).data
        return jnp.sum(y * w), y
    (_, y_ref), (gp, gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    load_flax_variables(t_mod, {"params": jax.tree_util.tree_map(
        np.asarray, params)})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = t_mod(TSig(xt, 1)).data
    (y * torch.from_numpy(w)).sum().backward()
    assert _rel(y, y_ref) <= FP32_TOL
    assert _rel(xt.grad, gx) <= GRAD_TOL
    for name, prm in t_mod.named_parameters():
        assert _rel(prm.grad, gp[name]) <= GRAD_TOL, name
    # an allpass keeps the energy of a long enough input
    energy = (y ** 2).sum() / (xt ** 2).sum()
    assert abs(energy.item() - 1.0) < 5e-2


@pytest.mark.parametrize("cls", ALLPASS)
def test_allpass_room_filter_builds_and_runs(cls):
    """golf.yaml's decoder with the allpass as its ``room_filter``, built
    through the registry on the CPU: predict runs and is finite. The init
    is seeded with the configs' ``seed_everything`` (2434), as the CLI
    seeds it: left to the torch RNG state of the tests before it, the
    real-coefficient allpass drew, in 3 of 60 seeds (5, 42, 43), poles for
    which golf_tpu's float32 blocked all-pole form, which the CPU route
    keeps, is not finite (ROADMAP §C)."""
    from golf_tpu_torch.config.registry import load_config
    dec = load_config(["cfg/ae/decoder/golf.yaml"])["decoder"]
    dec["init_args"]["room_filter"] = {
        "class_path": f"models.filters.{cls}", "init_args": {}}
    torch.manual_seed(2434)
    synth = t_instantiate(dec)
    assert type(synth.room_filter).__name__ == cls
    y = synth.room_filter(TSig(torch.from_numpy(_rand(50, (2, 2400))), 1))
    assert torch.isfinite(y.data).all() and y.shape == (2, 2400)
