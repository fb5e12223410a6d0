"""The decoder modules of the port that no shipped config names, against
golf_tpu's on the CPU: the PQMF bank and analysis, ``LTVPQMF``, the noise
sources ``UniformNoise``, ``SignFlipNoise`` and ``NoiseBand`` (golf_tpu's
random field drawn from its own key and given to the port), the noise-band
design, and the wavetables ``WeightedGlottalFlowTable``,
``DownsampledWeightedGlottalFlowTable`` and
``WrappedPhaseDownsampledIndexedGlottalFlowTable`` with their gradients
through the lookup's plain twins (B3a's residual forward when the phase
needs a gradient, B3b's table cotangent). Small sizes (B = 2, a few
thousand samples, 16 bands, 8 tables of 256 points); inputs from numpy
seeds, weights through the bridge.

Tolerances: host numpy designs bit for bit; the noise fields' transforms
within 1e-6 of max|y| (the same float32 operations in the same order);
every other forward within 1e-5 of max|y| (convolutions and matmuls sum in
another order on the two sides), but a wavetable's that integrates its
phase within 1e-4, as ``tests/test_torch_decoder.py`` holds the decoders:
the two mod-1 scans group their block totals differently, a few ulp of a
cycle, which the table's slope times its width amplifies (measured
1.8e-5); every gradient within 1e-3 of its max-abs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models import filters as jf
from golf_tpu.models import noise as jn
from golf_tpu.models import synth as js
from golf_tpu.ops import cepstrum as jc
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.models import filters as tf
from golf_tpu_torch.models import noise as tn
from golf_tpu_torch.models import synth as ts
from golf_tpu_torch.ops import cepstrum as tc
from golf_tpu_torch.ops import lookup as tlk

torch.set_num_threads(1)

FIELD_TOL = 1e-6
OUT_TOL = 1e-5
PHASE_TOL = 1e-4
GRAD_TOL = 1e-3
HOP = 240
B = 2
TABLE = {"table_size": 8, "points": 256, "lf_v2": True}


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _noise_key(module, key):
    """The key golf_tpu's module draws its field from (its first
    ``make_rng('noise')`` under ``rngs={'noise': key}``)."""
    return module.apply({}, method=lambda m: m.make_rng("noise"),
                        rngs={"noise": key})


# ---------------------------------------------------------------------------
# PQMF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bands,order,alpha",
                         [(16, 127, 100.0), (4, 62, 80.0), (8, 63, 0.0)])
def test_pqmf_filters_bit_for_bit(bands, order, alpha):
    ref = jc.pqmf_filters(bands, order, alpha)
    got = tc.pqmf_filters(bands, order, alpha)
    assert got.dtype == np.float32 and np.array_equal(got, ref)


@pytest.mark.parametrize("taps", [128, 63], ids=["even", "odd"])
def test_pqmf_analysis_matches_golf_tpu(taps):
    """The "same"-padded true convolution of each band, and the gradient
    with respect to x."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 3000)).astype(np.float32)
    g = rng.standard_normal((B, 16, 3000)).astype(np.float32)
    bank = jc.pqmf_filters(16, taps - 1, 100.0)
    ref, vjp = jax.vjp(lambda v: jc.pqmf_analysis(v, jnp.asarray(bank)),
                       jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    out = tc.pqmf_analysis(xt, _t(bank))
    (out * _t(g)).sum().backward()
    assert _rel(out, ref) <= OUT_TOL
    assert _rel(xt.grad, dx_ref) <= GRAD_TOL


@pytest.mark.parametrize("alpha", [0.0, 60.0], ids=["default", "alpha60"])
@pytest.mark.parametrize("t", [4801, 4500], ids=["gains_shorter",
                                                 "signal_shorter"])
def test_ltvpqmf_matches_golf_tpu(alpha, t):
    """Per-band exp-gains at the frame hop, summed: output, and gradients
    with respect to the excitation and the log-gains."""
    rng = np.random.default_rng(1)
    frames = 21
    ex = rng.standard_normal((B, t)).astype(np.float32)
    lg = (0.3 * rng.standard_normal((B, frames, 16))).astype(np.float32)
    jmod = jf.LTVPQMF(n_mag=16, filter_order=127, alpha=alpha)

    def run(e, l):
        return jmod.apply({}, JSig(e, 1), JSig(l, HOP)).data

    ref, vjp = jax.vjp(run, jnp.asarray(ex), jnp.asarray(lg))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    dex_ref, dlg_ref = vjp(jnp.asarray(g))
    tmod = tf.LTVPQMF(n_mag=16, filter_order=127, alpha=alpha)
    assert tmod.split_sizes == (16,)
    et, lt = _t(ex).requires_grad_(True), _t(lg).requires_grad_(True)
    (gain,) = tmod.ctrl(TSig(lt, HOP))
    out = tmod(TSig(et, 1), gain)
    assert out.hop == 1
    (out.data * _t(g)).sum().backward()
    assert _rel(out.data, ref) <= OUT_TOL
    assert _rel(et.grad, dex_ref) <= GRAD_TOL
    assert _rel(lt.grad, dlg_ref) <= GRAD_TOL


# ---------------------------------------------------------------------------
# noise sources
# ---------------------------------------------------------------------------

def test_uniform_noise_takes_golf_tpus_field():
    ref_sig = JSig(jnp.zeros((B, 1000)), 1)
    key = jax.random.key(5)
    ref = jn.UniformNoise().apply({}, ref_sig, rngs={"noise": key}).data
    u = jax.random.uniform(_noise_key(jn.UniformNoise(), key), (B, 1000))
    out = tn.UniformNoise()(TSig(torch.zeros(B, 1000), 1), noise=_t(u))
    assert _rel(out.data, ref) <= FIELD_TOL


def test_sign_flip_noise_takes_golf_tpus_field():
    """One sign a sequence times +1, -1, ...; an exact 0 in the field
    gives a zero row, as ``jnp.sign``."""
    key = jax.random.key(6)
    ref = jn.SignFlipNoise().apply({}, JSig(jnp.zeros((3, 501)), 1),
                                   rngs={"noise": key}).data
    u = jax.random.uniform(_noise_key(jn.SignFlipNoise(), key), (3,),
                           jnp.float32, -1.0, 1.0)
    out = tn.SignFlipNoise()(TSig(torch.zeros(3, 501), 1), noise=_t(u))
    assert _rel(out.data, ref) <= FIELD_TOL
    assert np.array_equal(np.abs(out.data.numpy()), np.ones((3, 501)))
    zero = tn.SignFlipNoise()(TSig(torch.zeros(2, 10), 1),
                              noise=torch.tensor([0.0, -0.3])).data
    assert torch.equal(zero[0], torch.zeros(10))
    assert torch.equal(zero[1], -torch.tensor([1.0, -1.0] * 5))


@pytest.mark.parametrize("cls", ["UniformNoise", "SignFlipNoise",
                                 "NoiseBand"])
def test_noise_draws_from_the_generator(cls):
    """The port's own draws: the same generator seed gives the same field,
    another seed another; uniform noise has unit variance, sign-flip noise
    is +-1; a field of the wrong shape is refused."""
    mod = getattr(tn, cls)(**({"n_filters": 16, "fs": 24000}
                              if cls == "NoiseBand" else {}))
    ref = TSig(torch.zeros(4, 4800), 1)
    args = (TSig(torch.zeros(4, 21, 16), HOP),) if cls == "NoiseBand" else ()

    def draw(seed):
        return mod(ref, *args,
                   generator=torch.Generator().manual_seed(seed)).data

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    if cls == "UniformNoise":
        assert abs(a.var().item() - 1.0) < 0.05
        assert a.abs().max() <= math.sqrt(3)
    if cls == "SignFlipNoise":
        assert torch.equal(a.abs(), torch.ones_like(a))
    with pytest.raises(ValueError):
        mod(ref, *args, noise=torch.zeros(3, 7))


@pytest.mark.parametrize("n,fs,normalize", [(16, 24000, True),
                                            (40, 16000, False),
                                            (128, 24000, True)])
def test_design_noise_bands_bit_for_bit(n, fs, normalize):
    ref = jn._design_noise_bands(n, fs, 50.0, normalize)
    got = tn._design_noise_bands(n, fs, 50.0, normalize)
    for r, g in zip(ref, got):
        assert g.dtype == np.float32 and np.array_equal(g, r)


@pytest.mark.parametrize("t", [4800, 4000, 6000],
                         ids=["whole", "signal_shorter", "gains_shorter"])
def test_noise_band_matches_golf_tpu(t):
    """golf_tpu's offsets (its ``randint`` from its key) given to the port:
    the mixed bands and the gradient with respect to the log-gains. The
    port contracts each frame's two gain rows with the field and blends
    them over the hop; golf_tpu upsamples the gains, multiplies and sums:
    the same sum in another order."""
    rng = np.random.default_rng(2)
    frames = 21
    lg = (0.5 * rng.standard_normal((B, frames, 16))).astype(np.float32)
    jmod = jn.NoiseBand(n_filters=16, fs=24000)
    key = jax.random.key(7)

    def run(l):
        return jmod.apply({}, JSig(jnp.zeros((B, t)), 1), JSig(l, HOP),
                          rngs={"noise": key}).data

    ref, vjp = jax.vjp(run, jnp.asarray(lg))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    (dlg_ref,) = vjp(jnp.asarray(g))
    bands, _ = jn._design_noise_bands(16, 24000, 50.0, True)
    offsets = jax.random.randint(_noise_key(jmod, key), (B, 16), 0,
                                 bands.shape[1])
    tmod = tn.NoiseBand(n_filters=16, fs=24000)
    assert tmod.split_sizes == (16,)
    lt = _t(lg).requires_grad_(True)
    out = tmod(TSig(torch.zeros(B, t), 1), *tmod.ctrl(TSig(lt, HOP)),
               noise=torch.from_numpy(np.array(offsets)))
    assert out.hop == 1
    (out.data * _t(g)).sum().backward()
    assert _rel(out.data, ref) <= OUT_TOL
    assert _rel(lt.grad, dlg_ref) <= GRAD_TOL


# ---------------------------------------------------------------------------
# the wavetables
# ---------------------------------------------------------------------------

def _phase(t, seed):
    f0 = 150.0 + 60.0 * np.sin(np.linspace(0, 7.0 + seed, t))
    return (np.ones((B, 1)) * f0[None] / 24000.0).astype(np.float32)


def _load(module, variables):
    load_flax_variables(module, jax.tree_util.tree_map(np.asarray,
                                                       variables))
    return module


def _check_routes(route_log, phase_grad):
    """The residual forward (B3a's plain twin) ran exactly when the phase
    needed a gradient, B1's otherwise; B3b's always."""
    assert route_log["res"] == phase_grad
    assert route_log["fwd"] == (not phase_grad)
    assert route_log["dtab"]


@pytest.fixture
def route_log(monkeypatch):
    """Which of the lookup's plain functions ran."""
    log = {"fwd": False, "res": False, "dtab": False}

    def spy(name, fn):
        def wrapped(*a):
            log[name] = True
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tlk, "PLAIN_OPS", tlk.LookupOps(
        spy("fwd", tlk.lookup_blocks_plain), spy("res", tlk.lookup_res_plain),
        spy("dtab", tlk.lookup_dtab_plain)))
    return log


@pytest.mark.parametrize("phase_grad", [False, True],
                         ids=["true_f0", "phase_grad"])
def test_weighted_table_matches_golf_tpu(route_log, phase_grad):
    """``WeightedGlottalFlowTable``: softmax weights over the 8 tables at
    the frame hop, ``weight @ table``, the wrapped cumsum and the lookup;
    output and the gradients of the logits (and of the phase)."""
    t, frames = 4800, 21
    rng = np.random.default_rng(3)
    phase = _phase(t, 0)
    logits = rng.standard_normal((B, frames, 8)).astype(np.float32)
    jmod = js.WeightedGlottalFlowTable(**TABLE)
    variables = jmod.init(jax.random.key(0), JSig(phase, 1),
                          JSig(jax.nn.softmax(logits, 2), HOP))

    def run(ph, lo):
        def body(m):
            (w,) = m.ctrl(JSig(lo, HOP))
            return m(JSig(ph, 1), w).data
        return jmod.apply(variables, method=body)

    ref, vjp = jax.vjp(run, jnp.asarray(phase), jnp.asarray(logits))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    dph_ref, dlo_ref = vjp(jnp.asarray(g))
    tmod = _load(ts.WeightedGlottalFlowTable(**TABLE), variables)
    assert tmod.split_sizes == (8,)
    pt = _t(phase).requires_grad_(phase_grad)
    lt = _t(logits).requires_grad_(True)
    out = tmod(TSig(pt, 1), *tmod.ctrl(TSig(lt, HOP)))
    (out.data * _t(g)).sum().backward()
    assert _rel(out.data, ref) <= PHASE_TOL
    assert _rel(lt.grad, dlo_ref) <= GRAD_TOL
    if phase_grad:
        assert _rel(pt.grad, dph_ref) <= GRAD_TOL
    _check_routes(route_log, phase_grad)


def test_downsampled_weighted_table_matches_golf_tpu(route_log):
    """``DownsampledWeightedGlottalFlowTable``: the ``Downsampler`` with
    ``table_size`` outputs at a ten times coarser hop, a softmax, then the
    weighted lookup; output and the gradients of the hidden frames and of
    every ``Downsampler`` weight."""
    t, frames = 4800, 21
    rng = np.random.default_rng(4)
    phase = _phase(t, 1)
    h = rng.standard_normal((B, frames, 16)).astype(np.float32)
    args = {**TABLE, "hop_rate": 10, "in_channels": 16}
    jmod = js.DownsampledWeightedGlottalFlowTable(**args)

    def body(m, ph, hh):
        (w,) = m.ctrl(JSig(hh, HOP))
        return m(JSig(ph, 1), w).data

    variables = jmod.init(jax.random.key(1), phase, h, method=body)
    variables = {**variables, "params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(
            np.float32) * 0.3), variables["params"])}

    def run(params, hh):
        return jmod.apply({**variables, "params": params}, phase, hh,
                          method=body)

    ref, vjp = jax.vjp(run, variables["params"], jnp.asarray(h))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    dp_ref, dh_ref = vjp(jnp.asarray(g))
    tmod = _load(ts.DownsampledWeightedGlottalFlowTable(**args), variables)
    assert tmod.split_sizes == (16,)
    ht = _t(h).requires_grad_(True)
    (w,) = tmod.ctrl(TSig(ht, HOP))
    assert w.hop == 10 * HOP and w.shape == (B, 3, 8)
    out = tmod(TSig(_t(phase), 1), w)
    (out.data * _t(g)).sum().backward()
    assert _rel(out.data, ref) <= PHASE_TOL
    assert _rel(ht.grad, dh_ref) <= GRAD_TOL
    for k in (0, 1):
        ref_k = dp_ref["model"][f"Dense_{k}"]
        dense = getattr(tmod.model, f"dense{k}")
        assert _rel(dense.weight.grad, np.asarray(ref_k["kernel"]).T) \
            <= GRAD_TOL
        assert _rel(dense.bias.grad, ref_k["bias"]) <= GRAD_TOL
    _check_routes(route_log, False)


def test_wrapped_phase_table_matches_golf_tpu(route_log):
    """``WrappedPhaseDownsampledIndexedGlottalFlowTable`` on a wrapped
    phase at hop 1 (no cumsum, no oversampling): output and the gradients
    of the wrapped phase and of the hidden frames."""
    t, frames = 4800, 21
    rng = np.random.default_rng(5)
    wrapped = np.mod(np.cumsum(_phase(t, 2), axis=1), 1.0).astype(np.float32)
    h = rng.standard_normal((B, frames, 16)).astype(np.float32)
    args = {**TABLE, "hop_rate": 10, "in_channels": 16}
    jmod = js.WrappedPhaseDownsampledIndexedGlottalFlowTable(**args)

    def body(m, ph, hh):
        (w,) = m.ctrl(JSig(hh, HOP))
        return m(JSig(ph, 1), w).data

    variables = jmod.init(jax.random.key(2), wrapped, h, method=body)
    variables = {**variables, "params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(
            np.float32) * 0.3), variables["params"])}
    ref, vjp = jax.vjp(lambda ph, hh: jmod.apply(variables, ph, hh,
                                                 method=body),
                       jnp.asarray(wrapped), jnp.asarray(h))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    dph_ref, dh_ref = vjp(jnp.asarray(g))
    tmod = _load(ts.WrappedPhaseDownsampledIndexedGlottalFlowTable(**args),
                 variables)
    pt, ht = _t(wrapped).requires_grad_(True), _t(h).requires_grad_(True)
    out = tmod(TSig(pt, 1), *tmod.ctrl(TSig(ht, HOP)))
    (out.data * _t(g)).sum().backward()
    assert _rel(out.data, ref) <= OUT_TOL
    assert _rel(pt.grad, dph_ref) <= GRAD_TOL
    assert _rel(ht.grad, dh_ref) <= GRAD_TOL
    _check_routes(route_log, True)


@pytest.mark.parametrize("cls,kw", [
    ("WeightedGlottalFlowTable", {}),
    ("DownsampledWeightedGlottalFlowTable", {"in_channels": 16}),
    ("WrappedPhaseDownsampledIndexedGlottalFlowTable", {"in_channels": 16}),
    ("LTVPQMF", {}), ("NoiseBand", {"n_filters": 16, "fs": 24000}),
    ("UniformNoise", {}), ("SignFlipNoise", {})])
def test_bridge_loads_each_module_strictly(cls, kw):
    """golf_tpu's variables of each new decoder module load into the port's
    state_dict with no missing and no unexpected key."""
    mod = next(m for m in (js, jf, jn) if hasattr(m, cls))
    port = next(m for m in (ts, tf, tn) if hasattr(m, cls))
    kw = {**(TABLE if "Table" in cls else {}), **kw}
    jmod = getattr(mod, cls)(**kw)
    t = 4800
    if cls.endswith("Table"):
        h = np.zeros((B, 21, 16 if "Downsampled" in cls else 8), np.float32)

        def body(m, ph, hh):
            return m(JSig(ph, 1), *m.ctrl(JSig(hh, HOP))).data
        variables = jmod.init(jax.random.key(0), _phase(t, 0), h,
                              method=body)
    elif cls == "LTVPQMF":
        variables = jmod.init(jax.random.key(0), JSig(jnp.zeros((B, t)), 1),
                              JSig(jnp.zeros((B, 21, 16)), HOP))
    elif cls == "NoiseBand":
        variables = jmod.init({"params": jax.random.key(0),
                               "noise": jax.random.key(1)},
                              JSig(jnp.zeros((B, t)), 1),
                              JSig(jnp.zeros((B, 21, 16)), HOP))
    else:
        variables = jmod.init({"params": jax.random.key(0),
                               "noise": jax.random.key(1)},
                              JSig(jnp.zeros((B, t)), 1))
    tmod = _load(getattr(port, cls)(**kw), variables)
    if "Table" in cls:
        assert torch.equal(tmod.table, _t(variables["batch_stats"]
                                          ["glottal_table"]))
