"""GOLF's LPC parameterisations in the port against golf_tpu on the CPU:
the polynomial and biquad functions of ``ops/dsp.py`` (``poly_product_pair``,
``_poly_product_pair_direct``, ``coeff_product``, ``complex2biquads``,
``params2biquads``, ``biquads2lpc``, ``get_logits2biquads``, ``lsp2lpc`` at
even and odd order, ``_conv_last``), ``_logits2lpc`` under all five
parameterisations through ``LTVMinimumPhaseFilter`` (GOLF-ff) and
``LTVMinimumPhaseFilterPrecise`` (GOLF-ss), forward and gradients,
``GOLFStream`` with ``coef``, and ``conv_method`` (kept and not read, as in
golf_tpu). Inputs from a numpy seed.

Tolerances: the functions within 1e-6 of max|out| (the same sums in the
same order, float32), ``lsp2lpc`` within 1e-4 (see its test); the
filters' outputs within 1e-5 of max|y| and their gradients within 1e-3 of
each gradient's max-abs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.config.registry import instantiate as j_instantiate
from golf_tpu.core.sig import Sig as JSig
from golf_tpu.ops import dsp as j_dsp
from golf_tpu.serve import GOLFStream as JStream
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.config.registry import instantiate as t_instantiate
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.models import filters as t_filters
from golf_tpu_torch.ops import dsp as t_dsp
from golf_tpu_torch.serve import GOLFStream
from tests.test_torch_stream import (CHUNK, HOP, N_CHUNKS, _HOPS,
                                     _port_decoder, _run_stream)

torch.set_num_threads(1)

FN_TOL = 1e-6
LSP_TOL = 1e-4
FP32_TOL = 1e-5
GRAD_TOL = 1e-3
PARAMS = ("rc2lpc", "coef", "conj", "real", "lsp2lpc")


def _rel(got, ref):
    got, ref = (v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                for v in (got, ref))
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(fn_name, *arrays):
    """golf_tpu's and the port's ``ops.dsp.<fn_name>`` on the same
    arrays."""
    ref = getattr(j_dsp, fn_name)(*(jnp.asarray(a) for a in arrays))
    got = getattr(t_dsp, fn_name)(*(torch.from_numpy(a) for a in arrays))
    return got, ref


# ---------------------------------------------------------------------------
# ops/dsp.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn_name", ["poly_product_pair",
                                     "_poly_product_pair_direct",
                                     "_conv_last"])
def test_polynomial_pair_products_match_golf_tpu(fn_name):
    """The FFT and direct full convolutions of two coefficient arrays, and
    ``_conv_last`` with a broadcast second operand."""
    a = _rand(0, (3, 4, 7))
    b = _rand(1, (3, 4, 5) if fn_name != "_conv_last" else (1, 4, 3))
    got, ref = _both(fn_name, a, b)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= FN_TOL


@pytest.mark.parametrize("n", [1, 3, 11])
def test_coeff_product_matches_golf_tpu(n):
    """The divide-and-conquer product of n biquads (N, B, 3) -> (B, 2N+1)."""
    got, ref = _both("coeff_product", _rand(2, (n, 5, 3)))
    assert got.shape == (5, 2 * n + 1)
    assert _rel(got, ref) <= FN_TOL


def test_biquad_sections_match_golf_tpu():
    """``complex2biquads`` (conjugate pairs), ``params2biquads`` and
    ``biquads2lpc`` on (2, 9, 11, 3) sections."""
    rng = np.random.default_rng(3)
    roots = (rng.uniform(0.1, 0.95, 8)
             * np.exp(1j * rng.uniform(0, np.pi, 8))).astype(np.complex64)
    got, ref = _both("complex2biquads", roots)
    assert _rel(got, ref) <= FN_TOL
    p1, p2 = np.tanh(_rand(4, (2, 9, 11))), np.tanh(_rand(5, (2, 9, 11)))
    got, ref = _both("params2biquads", p1, p2)
    assert _rel(got, ref) <= FN_TOL
    got, ref = _both("biquads2lpc", np.asarray(ref))
    assert got.shape == (2, 9, 22)
    assert _rel(got, ref) <= FN_TOL


@pytest.mark.parametrize("rep", ["coef", "conj", "real"])
def test_logits2biquads_matches_golf_tpu(rep):
    logits = _rand(6, (2, 9, 11, 2))
    ref = j_dsp.get_logits2biquads(rep, 0.97)(jnp.asarray(logits))
    got = t_dsp.get_logits2biquads(rep, 0.97)(torch.from_numpy(logits))
    assert _rel(got, ref) <= FN_TOL


@pytest.mark.parametrize("order", [22, 21, 3, 2], ids=lambda o: f"p{o}")
def test_lsp2lpc_matches_golf_tpu(order):
    """Even and odd orders (P and Q built differently) on ascending
    frequencies in (0, pi), as ``_logits2lpc`` makes them. The products
    match bit for bit, but the two libraries' float32 cosines differ by an
    ulp and the polynomial of roots on the unit circle amplifies it: both
    packages stray ~3e-5 of max|a| from a float64 run at order 22. Held to
    1e-4 of golf_tpu's, and to twice golf_tpu's distance from float64."""
    logits = _rand(7, (2, 9, order + 1))
    w = np.cumsum(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True),
                  -1)
    w = (np.roll(w, 1, -1) * np.pi).astype(np.float32)
    got, ref = _both("lsp2lpc", w)
    exact = t_dsp.lsp2lpc(torch.from_numpy(w).double())
    assert got.shape == (2, 9, order + 1)
    assert _rel(got, ref) <= LSP_TOL
    assert _rel(got.double(), exact) <= 2 * _rel(
        torch.from_numpy(np.asarray(ref, np.float64)), exact) + FN_TOL


# ---------------------------------------------------------------------------
# _logits2lpc through the GOLF end filters
# ---------------------------------------------------------------------------

B, T = 2, 4800


def _order(rep):
    """22, GOLF's order; 21 under lsp2lpc: golf_tpu's ``lsp2lpc`` swaps the
    (1 - z^-1) and (1 + z^-1) factors at even order, so every even-order
    filter it makes is unstable (``test_lsp2lpc_even_order_is_golf_tpus``);
    at odd order it is right."""
    return 21 if rep == "lsp2lpc" else 22


def _filter_node(kind, rep):
    cls = {"ff": "LTVMinimumPhaseFilter",
           "ss": "LTVMinimumPhaseFilterPrecise"}[kind]
    args = {"lpc_order": _order(rep), "lpc_parameterisation": rep,
            "max_abs_value": 0.95}
    if kind == "ff":
        args.update(window="hanning", window_length=960)
    return {"class_path": f"models.filters.{cls}", "init_args": args}


def _t_filter_run(t_mod, ex, log_gain, logits, w, dtype):
    """The port's ctrl and filter in ``dtype``: (a, y, the gradients of
    the excitation, the log gain and the logits)."""
    ins = [torch.from_numpy(v).to(dtype).requires_grad_(True)
           for v in (ex, log_gain, logits)]
    gain, a = t_mod.to(dtype).ctrl(TSig(ins[1], HOP), TSig(ins[2], HOP))
    y = t_mod(TSig(ins[0], 1), gain, a).data
    (y * torch.from_numpy(w).to(dtype)[:, :y.shape[1]]).sum().backward()
    return [a.data, y] + [v.grad for v in ins]


@pytest.mark.parametrize("kind", ["ff", "ss"])
@pytest.mark.parametrize("rep", PARAMS)
def test_end_filter_parameterisation_matches_golf_tpu(kind, rep):
    """ctrl (exp of the log gain, ``_logits2lpc``) then the filter, on the
    same slowly varying logits and excitation: the coefficients, the output,
    and the gradients of the excitation, the log gain and the logits
    through a seeded real loss. Under lsp2lpc both packages' float32
    coefficients stray ~7e-3 of max|a| from a float64 run (A is the small
    difference of P and Q, whose coefficients are large): there the port
    is held to twice golf_tpu's distance from the port's float64 run, plus
    the fp32 tolerances."""
    node = _filter_node(kind, rep)
    j_mod = j_instantiate(node)
    t_mod = t_instantiate(node)
    n = t_mod.split_sizes[1]
    assert n == j_mod.split_sizes[1] == _order(rep) + (rep == "lsp2lpc")
    frames = T // HOP + 1
    ex = _rand(8, (B, T))
    log_gain = _rand(9, (B, frames), 0.2)
    # slowly varying small logits: poles well inside the unit circle, where
    # golf_tpu's float32 blocked all-pole forms are accurate (resonant
    # filters are tests/test_torch_allpole_const.py's)
    logits = _rand(10, (B, 1, n), 0.1) + np.cumsum(
        _rand(21, (B, frames, n), 0.01), axis=1)
    w = _rand(11, (B, T))

    def j_loss(ex_, lg, lo):
        gain, a = j_mod.apply({}, JSig(lg, HOP), JSig(lo, HOP),
                              method="ctrl")
        y = j_mod.apply({}, JSig(ex_, 1), gain, a).data
        return jnp.sum(y * w[:, :y.shape[1]]), (a.data, y)
    # eagerly: XLA:CPU compiles the all-pole filters' gradient slowly
    (_, refs), g_ref = jax.value_and_grad(
        j_loss, argnums=(0, 1, 2), has_aux=True)(ex, log_gain, logits)
    refs = list(refs) + list(g_ref)
    got = _t_filter_run(t_mod, ex, log_gain, logits, w, torch.float32)
    assert got[0].shape == (B, frames, _order(rep))
    assert got[1].shape == refs[1].shape
    names = ("a", "y", "d_ex", "d_log_gain", "d_logits")
    tols = (FP32_TOL, FP32_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)
    if rep != "lsp2lpc":
        for name, g, r, tol in zip(names, got, refs, tols):
            assert _rel(g, r) <= tol, name
        return
    exact = _t_filter_run(t_mod, ex, log_gain, logits, w, torch.float64)
    for name, g, r, e, tol in zip(names, got, refs, exact, tols):
        own = _rel(torch.from_numpy(np.asarray(r, np.float64)), e)
        assert _rel(g.double(), e) <= 2 * own + tol, (name, own)


def test_lsp2lpc_even_order_is_golf_tpus():
    """golf_tpu's ``lsp2lpc`` at even order puts (1 - z^-1) on the
    odd-indexed frequencies' polynomial and (1 + z^-1) on the others, the
    swap of the standard pair: evenly spaced LSFs, whose filter is A = 1,
    give [1, 0, 2, 0, 2, ...] with roots outside the unit circle. The port
    keeps it, for parity; at odd order both give A = 1 (to 1e-2: the float32
    cosines' ulps, amplified)."""
    for p, expect_flat in ((22, False), (21, True)):
        w = np.concatenate([[np.pi], np.arange(1, p + 1) * np.pi / (p + 1)])
        w = w.astype(np.float32)
        got, ref = _both("lsp2lpc", w)
        want = np.zeros(p + 1)
        want[0] = 1.0
        if not expect_flat:
            want[2::2] = 2.0
        for a in (got.numpy(), np.asarray(ref)):
            assert np.abs(a - want).max() < 1e-2, (p, a)
        roots = np.abs(np.roots(got.numpy().astype(np.float64))).max()
        assert (roots < 1) == expect_flat, (p, roots)


def _j_coef_decoder():
    """golf_tpu's decoder of ``tests/test_stream.py`` with a ``coef`` end
    filter, and the port's on the same weights (the room filter's kernel
    drawn from a seed)."""
    from golf_tpu.models import filters as jf
    from golf_tpu.models.sf import SourceFilterSynth as JSynth
    from golf_tpu.models.synth import \
        DownsampledIndexedGlottalFlowTable as JTable
    from tests.test_stream import InjectedNoise
    j_dec = JSynth(
        harm_oscillator=JTable(
            hop_rate=10, in_channels=16, oversampling=4, equal_energy=True,
            table_type="derivative", normalize_method="constant_power",
            align_peak=True, trainable=False, min_R_d=0.3, max_R_d=2.7,
            lf_v2=True, points=128, table_size=16),
        noise_generator=InjectedNoise(),
        noise_filter=jf.LTVZeroPhaseFIRFilter(window="hanning", n_mag=33),
        end_filter=jf.LTVMinimumPhaseFilterPrecise(
            lpc_order=8, lpc_parameterisation="coef", max_abs_value=0.95),
        room_filter=jf.LTIAcousticFilter(length=32, conv_method="fft"),
        subtract_harmonics=False)
    t_dec = _port_decoder(t_filters.LTVMinimumPhaseFilterPrecise(
        lpc_order=8, lpc_parameterisation="coef", max_abs_value=0.95))
    return j_dec, t_dec


def test_golf_stream_with_coef_matches_offline():
    """GOLF-ss with ``coef`` streams: golf_tpu's applied ctrl of its coef
    end filter through golf_tpu's ``GOLFStream`` and the port's, push by
    push and the flush, on the same weights, ctrl and noise (1e-4 of
    max|y|, as ``tests/test_torch_stream.py`` holds the rc2lpc stream);
    then the port's stream against the port's offline decoder on that ctrl
    (5e-4 of max|y|, golf_tpu's stream bound)."""
    j_dec, t_dec = _j_coef_decoder()
    t = N_CHUNKS * CHUNK
    frames = t // HOP
    # the end filter's logits drift slowly from frame to frame: GOLF-ss
    # interpolates the direct-form coefficients sample by sample, and
    # between two far-apart stable frames that can leave the unit circle
    # (on both packages alike)
    lpc_logits = (_rand(16, (B, 1, 8), 0.3)
                  + _rand(18, (B, frames, 8), 0.01)).astype(np.float32)
    raw = {"harm_oscillator_params": (JSig(jnp.asarray(
               _rand(13, (B, frames, 16), 0.1)), HOP),),
           "noise_generator_params": (),
           "noise_filter_params": (JSig(jnp.asarray(
               _rand(14, (B, frames, 33), 0.1) - 3.0), HOP),),
           "end_filter_params": (
               JSig(jnp.asarray(_rand(15, (B, frames), 0.1)), HOP),
               JSig(jnp.asarray(lpc_logits), HOP)),
           "room_filter_params": ()}
    f0 = 150.0 + 60.0 * np.sin(np.linspace(0, 9.0, t))[None] * np.ones((B, 1))
    phase = (f0 / 24000.0).astype(np.float32)
    noise = _rand(17, (B, t), 0.03)
    variables = j_dec.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        JSig(jnp.asarray(phase), 1), method=lambda m, p_: m(
            p_, **{**m.apply_ctrl(raw),
                   "noise_generator_params": (JSig(jnp.asarray(noise), 1),)}))
    params = dict(variables["params"])
    params["room_filter"] = {"kernel": jnp.asarray(_rand(12, (31,), 0.05))}
    variables = {**variables, "params": params}
    load_flax_variables(t_dec, jax.tree_util.tree_map(np.asarray, variables))
    applied = j_dec.apply(variables, raw,
                          method=lambda m, r_: m.apply_ctrl(r_))
    ctrl = {k: tuple(np.array(s.data) for s in applied[k]) for k in _HOPS}
    ref = _run_stream(JStream(j_dec, variables, chunk=CHUNK), ctrl, phase,
                      noise, JSig, jnp.asarray, np.asarray)
    got = _run_stream(GOLFStream(t_dec, chunk=CHUNK), ctrl, phase, noise,
                      TSig, torch.from_numpy, lambda v: v.numpy())
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-4
    with torch.no_grad():
        off = t_dec(TSig(torch.from_numpy(phase), 1),
                    **{k: tuple(TSig(torch.from_numpy(v), _HOPS[k])
                                for v in leaves)
                       for k, leaves in ctrl.items()},
                    noise=torch.from_numpy(noise)).data.numpy()
    assert np.isfinite(off).all() and np.abs(off).max() < 1e3
    err = np.abs(got[:, :off.shape[1]] - off).max() / np.abs(off).max()
    assert err < 5e-4, err


# ---------------------------------------------------------------------------
# conv_method: kept and not read
# ---------------------------------------------------------------------------

_FIR = {"LTVMinimumPhaseFIRFilter": {"window": "hanning", "n_mag": 65},
        "LTVZeroPhaseFIRFilter": {"window": "hanning", "n_mag": 65},
        "LTIAcousticFilter": {"length": 32}}


@pytest.mark.parametrize("cls", list(_FIR))
def test_conv_method_direct_runs_the_fft_path(cls):
    """Each of the three filters built from a config node with
    ``conv_method: direct`` (golf_tpu declares the field and never reads
    it): the output equals golf_tpu's, within 1e-5 of max|y|."""
    node = {"class_path": f"models.filters.{cls}",
            "init_args": {**_FIR[cls], "conv_method": "direct"}}
    j_mod = j_instantiate(node)
    t_mod = t_instantiate(node)
    assert t_mod.conv_method == "direct"
    ex = _rand(18, (B, T))
    if cls == "LTIAcousticFilter":
        kernel = _rand(19, (31,), 0.1)
        ref = j_mod.apply({"params": {"kernel": kernel}},
                          JSig(jnp.asarray(ex), 1)).data
        load_flax_variables(t_mod, {"params": {"kernel": kernel}})
        got = t_mod(TSig(torch.from_numpy(ex), 1)).data
    else:
        log_mag = _rand(20, (B, T // HOP, 65), 0.3) - 1.0
        ref = j_mod.apply({}, JSig(jnp.asarray(ex), 1),
                          JSig(jnp.asarray(log_mag), HOP)).data
        got = t_mod(TSig(torch.from_numpy(ex), 1),
                    TSig(torch.from_numpy(log_mag), HOP)).data
    assert got.shape == ref.shape
    assert _rel(got, ref) <= FP32_TOL


def test_parameterisations_build_through_the_registry():
    """Every parameterisation builds from a config node (split sizes as
    golf_tpu's: order + 1 logits under lsp2lpc); an unknown one is
    refused."""
    for kind in ("ff", "ss"):
        for rep in PARAMS:
            node = _filter_node(kind, rep)
            assert t_instantiate(node).split_sizes == \
                j_instantiate(node).split_sizes
    with pytest.raises(ValueError, match="lpc_parameterisation"):
        t_filters.LTVMinimumPhaseFilterPrecise(lpc_order=4,
                                               lpc_parameterisation="bogus")
