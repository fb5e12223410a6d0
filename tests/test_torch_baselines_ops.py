"""The modules of the Interspeech24 baseline decoders in the port against
golf_tpu, on the CPU, at small sizes (B = 2, 0.3 s at 24 kHz, hop 240,
n_fft 1024 as in the decoder YAMLs):

* ops: ``hilbert`` (even and odd lengths), the two-sided ``stft``,
  ``istft`` (one- and two-sided, with and without ``center`` and
  ``length``), ``mc2sp_log``, ``minimum_phase_response``,
  ``minimum_phase_fir``, ``fir_filt`` (up to 128 taps as shifted slices,
  more as a window view);
* oscillators: ``AdditivePulseTrain``, ``SawToothOscillator`` and
  ``PulseTrain``, with and without a phase offset (and an initial phase);
* filters: ``LTVCepFilter`` (min and zero phase), ``LTVMLSAFilter``
  (freq-domain and multi-stage), ``LTVMLSAFilter2``, ``LTVAPFilter``,
  ``DiffWorldSPFilter``, ``LTVMinimumPhaseFIRFilter`` and its ``Precise``
  twin, ``LTVAPZeroPhaseFIRFilter``, ``LTIRadiationFilter``.

Each case feeds both packages the same inputs from a numpy seed and holds
the forward within OUT_TOL of max|y| (the multi-stage MLSA within
TAYLOR_TOL) and the gradient of every input, under the same cotangent,
within GRAD_TOL of its max-abs (``jax.vjp`` against ``torch.autograd``).
Complex outputs are compared as their real and imaginary parts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models import filters as jfilters
from golf_tpu.models import synth as jsynth
from golf_tpu.ops import cepstrum as jcep
from golf_tpu.ops import dsp as jdsp
from golf_tpu.ops import stft as jstft
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.models import filters as tfilters
from golf_tpu_torch.models import synth as tsynth
from golf_tpu_torch.ops import cepstrum as tcep
from golf_tpu_torch.ops import dsp as tdsp
from golf_tpu_torch.ops import stft as tstft

torch.set_num_threads(1)

B, T, HOP, N_FFT = 2, 7200, 240, 1024
FRAMES = T // HOP + 1
OUT_TOL = 1e-5       # of max|y|: float32 on both sides, two FFT libraries
GRAD_TOL = 1e-3      # of each gradient's max-abs
# the multi-stage MLSA compounds 20 float32 Taylor stages, each an FFT
# convolution in another library's summation order: measured 2.1e-7 of
# max|y| here (freq-domain 3.1e-7), held to 1e-5 like every other forward
TAYLOR_TOL = 1e-5


def within(got, ref, tol, what=""):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0, what
    err = np.abs(got - ref).max() / scale
    assert err <= tol, (what, err)


def _real(y, lib):
    """Complex outputs as their stacked real and imaginary parts."""
    if lib is jnp:
        return jnp.stack([y.real, y.imag]) if jnp.iscomplexobj(y) else y
    return torch.stack([y.real, y.imag]) if y.is_complex() else y


def compare(j_fn, t_fn, inputs, out_tol=OUT_TOL, seed=0, what=""):
    """Forward and the gradient of every input under one random cotangent:
    ``j_fn`` on jnp arrays (jitted), ``t_fn`` on torch tensors."""
    j_out, vjp = jax.vjp(jax.jit(lambda *a: _real(j_fn(*a), jnp)),
                         *map(jnp.asarray, inputs))
    cot = np.random.default_rng(seed + 100).standard_normal(
        j_out.shape).astype(np.float32)
    grads_j = vjp(jnp.asarray(cot))
    ins = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    t_out = _real(t_fn(*ins), torch)
    within(t_out.detach(), j_out, out_tol, (what, "forward"))
    t_out.backward(torch.from_numpy(cot))
    for i, (t_in, g_j) in enumerate(zip(ins, grads_j)):
        if t_in.grad is None:
            # no differentiable path (the pulse train's offset only moves
            # its wraps): golf_tpu's gradient is zero too
            assert not np.asarray(g_j).any(), (what, i)
            continue
        assert torch.isfinite(t_in.grad).all(), (what, i)
        within(t_in.grad, g_j, GRAD_TOL, (what, "grad", i))


def rand(shape, seed, scale=1.0, shift=0.0):
    r = np.random.default_rng(seed)
    return (scale * r.standard_normal(shape) + shift).astype(np.float32)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1024, 1023])
def test_hilbert(n):
    x = rand((B, 5, n), n)
    compare(lambda a: jdsp.hilbert(a), lambda a: tdsp.hilbert(a), [x],
            what="hilbert")


@pytest.mark.parametrize("center", [True, False])
def test_stft_two_sided(center):
    x = rand((B, T), 1)
    compare(lambda a: jstft.stft(a, N_FFT, HOP, window="hanning",
                                 center=center, onesided=False),
            lambda a: tstft.stft(a, N_FFT, HOP, window="hanning",
                                 center=center, onesided=False),
            [x], what="stft")


def test_stft_one_sided_unchanged():
    """The one-sided result keeps the port's earlier expression (an rfft of
    the windowed frames) bit for bit."""
    x = torch.from_numpy(rand((B, T), 2))
    w = torch.as_tensor(tdsp.get_window_fn("hanning")(N_FFT),
                        dtype=torch.float32)
    ref = torch.fft.rfft(tstft.frame_signal(x, N_FFT, HOP) * w,
                         dim=-1).transpose(-1, -2)
    assert torch.equal(tstft.stft(x, N_FFT, HOP, window="hanning"), ref)


@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("length", [None, T - 100])
def test_istft(onesided, center, length):
    """The STFT of a signal times a real per-bin gain, back through the
    inverse STFT: forward and the gradients of the signal and the gain."""
    x = rand((B, T), 3)
    n_bins = N_FFT // 2 + 1 if onesided else N_FFT
    gain = np.abs(rand((B, n_bins, 1), 4, 0.5, 1.0))

    def run(stft, istft, a, g):
        spec = stft(a, N_FFT, HOP, window="hanning", center=center,
                    onesided=onesided)
        return istft(spec * g, N_FFT, HOP, window="hanning", center=center,
                     onesided=onesided, length=length)

    compare(lambda a, g: run(jstft.stft, jstft.istft, a, g),
            lambda a, g: run(tstft.stft, tstft.istft, a, g), [x, gain],
            what="istft")


def test_istft_inverts_stft():
    x = torch.from_numpy(rand((B, T), 5))
    for onesided in (True, False):
        spec = tstft.stft(x, N_FFT, HOP, window="hanning",
                          onesided=onesided)
        y = tstft.istft(spec, N_FFT, HOP, window="hanning",
                        onesided=onesided, length=T)
        assert (y - x).abs().max() < 1e-5


@pytest.mark.parametrize("lin_order", [None, 99])
def test_mc2sp_log(lin_order):
    mc = rand((B, 5, 25), 6, 0.3)
    compare(lambda a: jcep.mc2sp_log(a, N_FFT, 0.46, lin_order),
            lambda a: tcep.mc2sp_log(a, N_FFT, 0.46, lin_order), [mc],
            what="mc2sp_log")


def test_minimum_phase_response():
    log_mag = rand((B, 5, N_FFT // 2 + 1), 7, 0.5)
    compare(jcep.minimum_phase_response, tcep.minimum_phase_response,
            [log_mag], what="minimum_phase_response")


def test_minimum_phase_fir():
    log_mag = rand((B, 5, 129), 8, 0.5)
    compare(jdsp.minimum_phase_fir, tdsp.minimum_phase_fir, [log_mag],
            what="minimum_phase_fir")


@pytest.mark.parametrize("k", [33, 200])
def test_fir_filt(k):
    x = rand((B, 1200), 9)
    h = rand((B, 1200, k), 10, 0.2)
    compare(jdsp.fir_filt, tdsp.fir_filt, [x, h], what="fir_filt")


def test_radiation_time_filter_bit_for_bit():
    w = jdsp.get_window_fn("hanning")
    np.testing.assert_array_equal(
        tdsp.get_radiation_time_filter(16, tdsp.get_window_fn("hanning")),
        jdsp.get_radiation_time_filter(16, w))


# ---------------------------------------------------------------------------
# oscillators
# ---------------------------------------------------------------------------

def _phase(seed, t=6000):
    """Phase increments m / 4096 for m in [16, 256] at hop 1 (f0 from 94 to
    1500 Hz, so harmonics cross Nyquist): their float32 cumsums are exact
    in any order, so both sides integrate the same phase."""
    r = np.random.default_rng(seed)
    m = np.interp(np.arange(t), np.linspace(0, t, 9),
                  r.integers(16, 257, 9)).round()
    return np.ascontiguousarray(
        np.broadcast_to(m / 4096, (B, t)).astype(np.float32))


OSCILLATORS = {
    "AdditivePulseTrain": ({"num_harmonics": 155}, False),
    "SawToothOscillator": ({"num_harmonics": 40}, False),
    "PulseTrain": ({}, False),
    "AdditivePulseTrain+offsets": ({"num_harmonics": 155}, True),
    "SawToothOscillator+offsets": ({"num_harmonics": 40}, True),
    "PulseTrain+offset": ({}, True),
}


@pytest.mark.parametrize("case", sorted(OSCILLATORS))
def test_oscillator(case):
    """The gradients of the phase (and of the offsets) too. The offset is a
    multiple of 1/4096, so the pulse train's wraps land on the same
    samples on both sides."""
    kw, offsets = OSCILLATORS[case]
    name = case.split("+")[0]
    jm, tm = getattr(jsynth, name)(**kw), getattr(tsynth, name)(**kw)
    phase = _phase(len(case))
    r = np.random.default_rng(len(case))
    inputs = [phase]
    if offsets:
        inputs.append((r.integers(0, 4096, phase.shape) / 4096).astype(
            np.float32))
        if name != "PulseTrain":
            inputs.append(r.uniform(0, 1, (B, kw["num_harmonics"])).astype(
                np.float32))

    def j_fn(ph, *off):
        kwargs = {"phase_offset": JSig(off[0], 1)} if off else {}
        if len(off) > 1:
            kwargs["initial_phase"] = off[1]
        return jm.apply({}, JSig(ph, 1), **kwargs).data

    def t_fn(ph, *off):
        kwargs = {"phase_offset": TSig(off[0], 1)} if off else {}
        if len(off) > 1:
            kwargs["initial_phase"] = off[1]
        return tm(TSig(ph, 1), **kwargs).data

    compare(j_fn, t_fn, inputs, what=case)


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def _filter_case(jm, tm, ctrl, ex_seed=20, what="", out_tol=OUT_TOL,
                 with_ctrl=False):
    """ex (B, T) and the ctrl frames at hop 240 through both modules (and
    their ``ctrl`` first with ``with_ctrl``)."""
    ex = rand((B, T), ex_seed)

    def j_fn(e, c):
        def inner(m, e, c):
            p = m.ctrl(JSig(c, HOP))[0] if with_ctrl else JSig(c, HOP)
            return m(JSig(e, 1), p).data
        return jm.apply({}, e, c, method=inner)

    def t_fn(e, c):
        p = tm.ctrl(TSig(c, HOP))[0] if with_ctrl else TSig(c, HOP)
        return tm(TSig(e, 1), p).data

    compare(j_fn, t_fn, [ex, ctrl], out_tol=out_tol, what=what)


@pytest.mark.parametrize("phase", ["min", "zero"])
def test_ltv_cep_filter(phase):
    """Two-sided STFT filtering without ``length``: (frames - 1) * hop
    samples out."""
    kw = dict(n_fft=N_FFT, window="hanning", filter_order=240,
              hop_length=HOP, phase=phase)
    jm, tm = jfilters.LTVCepFilter(**kw), tfilters.LTVCepFilter(**kw)
    ceps = rand((B, FRAMES, 241), 21, 0.02)
    assert tm.split_sizes == jm.split_sizes == (241,)
    _filter_case(jm, tm, ceps, what=f"cep {phase}")
    out = tm(TSig(torch.zeros(B, T), 1), TSig(torch.from_numpy(ceps), HOP))
    assert out.shape == (B, (FRAMES - 1) * HOP)


MLSA = {
    "freq-domain": (dict(mode="freq-domain", frame_length=1024,
                         fft_length=1024), OUT_TOL),
    "multi-stage": (dict(mode="multi-stage", cep_order=99), TAYLOR_TOL),
}


@pytest.mark.parametrize("mode", sorted(MLSA))
def test_ltv_mlsa_filter(mode):
    extra, tol = MLSA[mode]
    kw = dict(filter_order=24, frame_period=HOP, alpha=0.46,
              window="hanning", phase="minimum", **extra)
    jm, tm = jfilters.LTVMLSAFilter(**kw), tfilters.LTVMLSAFilter(**kw)
    mc = rand((B, FRAMES, 25), 22, 0.1)
    mc[..., 0] += 0.5
    # x is cut to whole frames (7200 = 30 hops), the ctrl to 30 frames
    _filter_case(jm, tm, mc, what=f"mlsa {mode}", out_tol=tol)


@pytest.mark.parametrize("mode", ["freq-domain", "multi-stage"])
def test_ltv_mlsa_filter2(mode):
    """Always the spectral realization; with multi-stage it truncates the
    unwarped cepstrum at cep_order."""
    kw = dict(filter_order=24, frame_period=HOP, alpha=0.46, mode=mode,
              cep_order=99, window="hanning")
    jm, tm = jfilters.LTVMLSAFilter2(**kw), tfilters.LTVMLSAFilter2(**kw)
    _filter_case(jm, tm, rand((B, FRAMES, 25), 23, 0.1), what="mlsa2")


def test_ltv_ap_filter():
    kw = dict(filter_order=24, frame_period=HOP, alpha=0.46, n_mag=257)
    jm, tm = jfilters.LTVAPFilter(**kw), tfilters.LTVAPFilter(**kw)
    assert tm.split_sizes == jm.split_sizes == (257,)
    assert tm.phase == jm.phase == "zero"
    _filter_case(jm, tm, rand((B, FRAMES, 257), 24), what="ap",
                 with_ctrl=True)


def test_diff_world_sp_filter():
    """ctrl (exp) and the filter; the pseudo-inverse's DC and Nyquist
    columns are tiny but not zero, so every gradient is finite."""
    kw = dict(n_fft=N_FFT, n_mels=80, hop_length=HOP, sample_rate=24000,
              f_min=0.0, f_max=12000.0, center=True, window="hanning")
    jm, tm = (jfilters.DiffWorldSPFilter(**kw),
              tfilters.DiffWorldSPFilter(**kw))
    ref_fb = jm.apply({}, method=lambda m: m._fb)
    np.testing.assert_array_equal(tm.inv_fb.numpy(), np.asarray(ref_fb))
    assert "inv_fb" not in tm.state_dict()
    _filter_case(jm, tm, rand((B, FRAMES, 80), 25, 0.5, -2.0),
                 what="world", with_ctrl=True)


@pytest.mark.parametrize("name", ["LTVMinimumPhaseFIRFilter",
                                  "LTVMinimumPhaseFIRFilterPrecise"])
def test_minimum_phase_fir_filter(name):
    jm = getattr(jfilters, name)(window="hanning", n_mag=65)
    tm = getattr(tfilters, name)(window="hanning", n_mag=65)
    assert tm.split_sizes == jm.split_sizes == (65,)
    _filter_case(jm, tm, rand((B, FRAMES, 65), 26, 0.5, -1.0),
                 what=name)


def test_ap_zero_phase_fir_filter():
    """The aperiodicity ctrl, log(sigmoid(x) sqrt(n_fft)), then the
    frame-wise zero-phase FIR."""
    jm = jfilters.LTVAPZeroPhaseFIRFilter(window="hanning", n_mag=65)
    tm = tfilters.LTVAPZeroPhaseFIRFilter(window="hanning", n_mag=65)
    _filter_case(jm, tm, rand((B, FRAMES, 65), 28), what="ap fir",
                 with_ctrl=True)


def test_sample_based_alias():
    assert issubclass(tfilters.SampleBasedLTVMinimumPhaseFilter,
                      tfilters.LTVMinimumPhaseFilterPrecise)


def test_lti_radiation_filter():
    jm, tm = jfilters.LTIRadiationFilter(), tfilters.LTIRadiationFilter()
    assert "kernel" not in tm.state_dict()
    compare(lambda e: jm.apply({}, JSig(e, 1)).data,
            lambda e: tm(TSig(e, 1)).data, [rand((B, T), 27)],
            what="radiation")
