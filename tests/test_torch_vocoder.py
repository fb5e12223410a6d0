"""The ISMIR23 mel vocoder's modules in the port against golf_tpu, on the
CPU, at small widths (B = 2 x 0.5 s, 24 mels, 16 hidden channels, 2 LSTM
layers, 12 additive harmonics; golf-v1 keeps its 2048-point table and
LPC order 22):

* the mel filterbank (bit for bit), ``melspectrogram`` and
  ``ScaledLogMelSpectrogram`` (train and eval, with the buffers) within
  1e-5 relative;
* ``PassThrough``, ``HarmonicOscillator``, ``AdditiveSynthesizer`` and
  ``V1AdditiveSynthesizer``: the output within 1e-5 of max|y|, every
  input's gradient within 1e-3 of its max-abs;
* ``HarmonicPlusNoiseSynth`` with ``golf-v1.yaml`` and ``ddsp.yaml``,
  given the voicing: forward and every input's gradient, the same noise;
* ``Mel2Control`` with bridged weights in train and eval modes;
* ``utils.world_lite.dio`` bit for bit, and ``freq2cent``;
* the bridge: a golf_tpu vocoder's variables load strictly.

Inputs come from numpy seeds; weights cross through ``bridge``; noise is
captured from golf_tpu's run and passed in with ``noise=``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.config.registry import instantiate as j_instantiate
from golf_tpu.config.registry import load_config as j_load_config
from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models import mel as jmel
from golf_tpu.models import synth as jsynth
from golf_tpu.models.ctrl import PassThrough as JPassThrough
from golf_tpu.models.noise import StandardNormalNoise as JNoise
from golf_tpu.ops import dsp as jdsp
from golf_tpu.ops import stft as jstft
from golf_tpu.tasks.data import SyntheticVoiceDataset
from golf_tpu.tasks.vocoder import ScaledLogMelSpectrogram as JScaledLogMel
from golf_tpu.tasks.vocoder import build_ddsp_vocoder as j_build
from golf_tpu.utils import world_lite as jwl
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.config.registry import instantiate as t_instantiate
from golf_tpu_torch.config.registry import load_config as t_load_config
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.models import mel as tmel
from golf_tpu_torch.models import synth as tsynth
from golf_tpu_torch.models.ctrl import PassThrough as TPassThrough
from golf_tpu_torch.ops import dsp as tdsp
from golf_tpu_torch.ops import stft as tstft
from golf_tpu_torch.tasks.vocoder import ScaledLogMelSpectrogram
from golf_tpu_torch.tasks.vocoder import build_ddsp_vocoder as t_build
from golf_tpu_torch.utils import world_lite as twl

torch.set_num_threads(1)

SR = 24000
HOP = 240
N_MELS = 24
HIDDEN = 16
LAYERS = 2
N_HARM = 16
OUT_TOL = 1e-5       # of max|y|
# a whole decoder's output, of max|y|: golf_tpu's float32 wrapped cumsum
# strays up to ~4e-6 cycles from a float64 cumsum at the frame-rate phases
# here, the port's (each block accumulated in float64) ~1.3e-6; a sine
# bank's harmonic k carries k times that, and the LPC filter and the two FFT
# libraries add their own sum-order rounding
DECODER_TOL = 1e-4
GRAD_TOL = 1e-3      # of each gradient's max-abs


def decoder_cfg(loader, decoder):
    """``cfg/ae/decoder/<decoder>.yaml``'s decoder; ddsp with N_HARM
    harmonics."""
    dec = loader(f"cfg/ae/decoder/{decoder}.yaml")["decoder"]
    if decoder == "ddsp":
        dec["init_args"]["harm_oscillator"]["init_args"][
            "num_harmonics"] = N_HARM
    return dec


def model_cfg(loader, decoder):
    """``cfg/vocoder.yaml``'s model.init_args with ``decoder``, cut to
    N_MELS mels and a HIDDEN x LAYERS Mel2Control."""
    cfg = loader("cfg/vocoder.yaml")["model"]["init_args"]
    cfg["decoder"] = decoder_cfg(loader, decoder)
    cfg["encoder_init_args"].update(in_channels=N_MELS,
                                    hidden_channels=HIDDEN,
                                    num_layers=LAYERS)
    cfg["feature_trsfm"]["init_args"]["n_mels"] = N_MELS
    return cfg


def j_cfg(decoder):
    return model_cfg(j_load_config, decoder)


def t_cfg(decoder):
    return model_cfg(lambda p: t_load_config([p]), decoder)


def batch(n=2, seconds=0.5, seed=3):
    """Synthetic voices (f0 with unvoiced gaps) plus white noise at -30 dB
    of full scale, so that no mel bin is near silent (the log would
    amplify the two FFT libraries' rounding there)."""
    ds = SyntheticVoiceDataset(n, seconds, SR, seed=seed)
    items = [ds[i] for i in range(n)]
    x = np.stack([x for x, _ in items])
    x = x + 0.03 * np.random.default_rng(11).standard_normal(x.shape)
    return (x.astype(np.float32),
            np.stack([f for _, f in items]).astype(np.float32))


def seeded(tree, seed=5, scale=0.1):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * scale), tree)


# XLA:CPU without its expensive passes: golf_tpu's GOLF decoder gradients
# compile in seconds (tens of minutes at the default level, about a minute
# op by op eagerly), within ~4e-5 of the eager result
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn):
    """``jax.jit(fn)``, compiled with FAST_COMPILE once per argument
    structure and shapes."""
    jitted, compiled = jax.jit(fn), {}

    def run(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple(np.shape(a) for a in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options=FAST_COMPILE)
        return compiled[key](*args)
    return run


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def within(got, ref, tol, what=""):
    got = np.asarray(got)
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0, what
    err = np.abs(got - ref).max() / scale
    assert err <= tol, (what, err)


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mel_scale", ["htk", "slaney"])
@pytest.mark.parametrize("norm", [None, "slaney"])
def test_melscale_fbanks_bit_for_bit(mel_scale, norm):
    ref = jstft.melscale_fbanks(513, 0.0, 12000.0, 80, SR, norm=norm,
                                mel_scale=mel_scale)
    got = tstft.melscale_fbanks(513, 0.0, 12000.0, 80, SR, norm=norm,
                                mel_scale=mel_scale)
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    f = np.array([0.0, 440.0, 999.0, 1000.0, 8000.0])
    np.testing.assert_array_equal(tstft.hz_to_mel(f, mel_scale),
                                  jstft.hz_to_mel(f, mel_scale))
    m = np.array([0.0, 10.0, 15.0, 40.0, 2000.0])
    np.testing.assert_array_equal(tstft.mel_to_hz(m, mel_scale),
                                  jstft.mel_to_hz(m, mel_scale))


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_melspectrogram_matches_golf_tpu(power):
    x, _ = batch()
    ref = np.asarray(jstft.melspectrogram(
        jnp.asarray(x), SR, 1024, HOP, 80, window="hanning", power=power))
    got = tstft.melspectrogram(torch.from_numpy(x), SR, 1024, HOP, 80,
                               window="hanning", power=power).numpy()
    assert got.shape == ref.shape == (2, 80, 51)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * ref.max())


def test_scaled_log_mel_matches_golf_tpu_in_train_and_eval():
    """Train mode normalises by the updated min/max and stores them; eval
    mode reads the stored ones. Both within 1e-5 relative of golf_tpu's,
    the buffers too."""
    x, _ = batch()
    x2, _ = batch(seed=4)
    args = dict(sample_rate=SR, n_fft=1024, hop_length=HOP, n_mels=N_MELS,
                power=1.0, window="hanning")
    jm = JScaledLogMel(**args)
    variables = jm.init(jax.random.key(0), jnp.asarray(x), train=False)
    ref_train, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["stats"])
    ref_eval = jm.apply(mutated, jnp.asarray(x2), train=False)

    tm = ScaledLogMelSpectrogram(**args)
    got_train = tm(torch.from_numpy(x), train=True)
    for name in ("log_mel_min", "log_mel_max"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(mutated["stats"][name]),
                                   rtol=1e-5)
    got_eval = tm(torch.from_numpy(x2), train=False)
    for got, ref in ((got_train, ref_train), (got_eval, ref_eval)):
        assert got.hop == ref.hop == HOP
        assert got.shape == ref.shape == (2, 51, N_MELS)
        np.testing.assert_allclose(got.data.numpy(), np.asarray(ref.data),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Oscillators
# ---------------------------------------------------------------------------

def _osc_inputs(seed, t=6000, n=N_HARM):
    """Inputs at hop 1: phase increments m / 4096 for m in [16, 256] (f0
    from 94 to 1500 Hz; harmonics from the 8th cross Nyquist, so the mask
    is exercised), whose float32 cumsums are exact in any order, so that
    both sides integrate the same phase; raw ctrl logits, a log gain and N
    amplitude logits; a cotangent."""
    r = np.random.default_rng(seed)
    m = np.interp(np.arange(t), np.linspace(0, t, 9),
                  r.integers(16, 257, 9)).round()
    phase = np.broadcast_to(m / 4096, (2, t)).astype(np.float32)
    log_gain = (0.3 * r.standard_normal((2, t))).astype(np.float32)
    logits = r.standard_normal((2, t, n)).astype(np.float32)
    cot = r.standard_normal((2, t)).astype(np.float32)
    return phase, log_gain, logits, cot


OSCILLATORS = {
    "HarmonicOscillator": (jsynth.HarmonicOscillator,
                           tsynth.HarmonicOscillator, {}),
    "AdditiveSynthesizer": (jsynth.AdditiveSynthesizer,
                            tsynth.AdditiveSynthesizer,
                            {"num_harmonics": N_HARM}),
    "V1AdditiveSynthesizer": (jsynth.V1AdditiveSynthesizer,
                              tsynth.V1AdditiveSynthesizer,
                              {"num_harmonics": N_HARM}),
}


@pytest.mark.parametrize("name", sorted(OSCILLATORS))
def test_oscillator_matches_golf_tpu(name):
    """ctrl (where the module has one) and the sine bank at hop 1: the
    output within 1e-5 of max|y| and the gradients of the phase, the log
    gain and the amplitude logits (or the amplitudes) within 1e-3 of their
    max-abs."""
    j_cls, t_cls, kw = OSCILLATORS[name]
    phase, log_gain, logits, cot = _osc_inputs(seed=len(name))
    jm, tm = j_cls(**kw), t_cls(**kw)
    has_ctrl = name != "HarmonicOscillator"
    if not has_ctrl:
        logits = np.abs(logits) * np.float32(0.1)

    def j_fn(ph, lg, lo):
        def inner(m, ph, lg, lo):
            amps = m.ctrl(JSig(lg, 1), JSig(lo, 1))[0] if has_ctrl \
                else JSig(lo, 1)
            return m(JSig(ph, 1), amps).data
        return jm.apply({}, ph, lg, lo, method=inner)

    y_j, vjp = jax.vjp(j_fn, *map(jnp.asarray, (phase, log_gain, logits)))
    grads_j = vjp(jnp.asarray(cot[:, :y_j.shape[1]]))

    ins = [torch.from_numpy(a).requires_grad_() for a in
           (phase, log_gain, logits)]
    amps = tm.ctrl(TSig(ins[1], 1), TSig(ins[2], 1))[0] if has_ctrl \
        else TSig(ins[2], 1)
    y_t = tm(TSig(ins[0], 1), amps).data
    assert y_t.shape == y_j.shape
    within(y_t.detach(), y_j, OUT_TOL, name)
    y_t.backward(torch.from_numpy(cot[:, :y_t.shape[1]]))
    for i, (t_in, g_j) in enumerate(zip(ins, grads_j)):
        if not has_ctrl and i == 1:
            continue
        within(t_in.grad, g_j, GRAD_TOL, (name, i))


def test_pass_through_is_the_identity():
    x = np.random.default_rng(0).standard_normal((2, 100)).astype(np.float32)
    ref = JPassThrough().apply({}, JSig(jnp.asarray(x), 1), 3, k=4)
    got = TPassThrough()(TSig(torch.from_numpy(x), 1), 3, k=4)
    assert got.hop == ref.hop
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    assert TPassThrough().split_sizes == JPassThrough().split_sizes == ()


# ---------------------------------------------------------------------------
# HarmonicPlusNoiseSynth
# ---------------------------------------------------------------------------

def _hpn_apply(m, raw, phase, voicing):
    params = m.apply_ctrl(raw) | {"phase": phase, "voicing": voicing}
    return m(**params)


_RAW_SCALE = {"harm_oscillator_params": (0.5, 0.0),
              "noise_filter_params": (0.3, -2.0),
              "harm_filter_params": (0.2, 0.0)}


def _hpn_inputs(decoder, frames=51, seed=0):
    """Raw parameter groups of the decoder's layout at hop 240 (the LPC
    logits at scale 0.2, as ``test_torch_decoder.py`` takes them: far from
    resonance, where both sides' blocked float32 filters hold), a phase
    from f0 in [80, 500] Hz and a voicing in (0.05, 1)."""
    r = np.random.default_rng(seed)
    dec = t_instantiate(decoder_cfg(lambda p: t_load_config([p]), decoder))
    sizes, keys = dec.param_layout
    raw = {}
    for k, group in zip(keys, sizes):
        scale, shift = _RAW_SCALE.get(k, (0.5, 0.0))
        raw[k] = tuple((scale * r.standard_normal(
            (2, frames) if s == 1 else (2, frames, s)) + shift).astype(
                np.float32) for s in group)
    f0 = np.exp(r.uniform(np.log(80.0), np.log(500.0), (2, frames)))
    phase = (f0 / SR).astype(np.float32)
    voicing = r.uniform(0.05, 1.0, (2, frames)).astype(np.float32)
    return raw, phase, voicing


@pytest.mark.parametrize("decoder", ["golf-v1", "ddsp"])
def test_harmonic_plus_noise_matches_golf_tpu(decoder):
    """The decoder given the voicing (multiplied into the phase): the
    output within DECODER_TOL of max|y|, and the gradients of the phase, the
    voicing, every raw parameter group and every weight within 1e-3 of
    their max-abs, on the same weights and noise."""
    raw, phase, voicing = _hpn_inputs(decoder)
    jm = j_instantiate(decoder_cfg(j_load_config, decoder))
    to_j = lambda a: JSig(jnp.asarray(a), HOP)  # noqa: E731
    j_raw = {k: tuple(map(to_j, g)) for k, g in raw.items()}
    rngs = {"params": jax.random.key(0), "noise": jax.random.key(1)}
    variables = jax.jit(lambda rw, ph, v: jm.init(
        rngs, rw, ph, v, method=_hpn_apply))(j_raw, to_j(phase),
                                             to_j(voicing))
    variables = {**variables, "params": seeded(variables["params"], 7)}
    y_j, state = fast_jit(lambda vs, rw, ph, v: jm.apply(
        vs, rw, ph, v, rngs={"noise": jax.random.key(2)}, method=_hpn_apply,
        mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise)))(
            variables, j_raw, to_j(phase), to_j(voicing))
    noise = np.array(state["intermediates"]["noise_generator"]["__call__"]
                     [0].data)
    cot = np.random.default_rng(9).standard_normal(y_j.shape).astype(
        np.float32)

    def j_loss(params, raw_d, ph, v):
        y = jm.apply({**variables, "params": params},
                     {k: tuple(map(to_j, g)) for k, g in raw_d.items()},
                     to_j(ph), to_j(v), rngs={"noise": jax.random.key(2)},
                     method=_hpn_apply)
        return jnp.sum(y.data * cot)

    grads_j = fast_jit(jax.grad(j_loss, argnums=(0, 1, 2, 3)))(
        variables["params"], {k: tuple(map(jnp.asarray, g))
                              for k, g in raw.items()},
        jnp.asarray(phase), jnp.asarray(voicing))

    tm = t_instantiate(decoder_cfg(lambda p: t_load_config([p]), decoder))
    load_flax_variables(tm, np_tree(variables))
    t_raw = {k: tuple(torch.from_numpy(a).requires_grad_() for a in g)
             for k, g in raw.items()}
    ph = torch.from_numpy(phase).requires_grad_()
    v = torch.from_numpy(voicing).requires_grad_()
    params = tm.apply_ctrl({k: tuple(TSig(a, HOP) for a in g)
                            for k, g in t_raw.items()})
    y_t = tm(**params, phase=TSig(ph, HOP), voicing=TSig(v, HOP),
             noise=torch.from_numpy(noise))
    assert y_t.shape == y_j.shape
    within(y_t.data.detach(), y_j.data, DECODER_TOL, decoder)
    torch.sum(y_t.data * torch.from_numpy(cot)).backward()
    g_params, g_raw, g_ph, g_v = grads_j
    within(ph.grad, g_ph, GRAD_TOL, "phase")
    within(v.grad, g_v, GRAD_TOL, "voicing")
    for k in raw:
        for i, (t_in, g) in enumerate(zip(t_raw[k], g_raw[k])):
            within(t_in.grad, g, GRAD_TOL, (k, i))
    from golf_tpu_torch.bridge import flax_to_state_dict
    ref = flax_to_state_dict({"params": np_tree(g_params)})
    named = dict(tm.named_parameters())
    assert set(named) == set(ref)
    for k, p in named.items():
        within(p.grad, ref[k], GRAD_TOL, k)


# ---------------------------------------------------------------------------
# Mel2Control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_mel2control_matches_golf_tpu(train):
    """Bridged weights; the output within 1e-5 relative of golf_tpu's (an
    absolute floor of 1e-5 of max|y|: fp32 through two LSTM layers); the
    module's mode must agree with ``train``."""
    r = np.random.default_rng(1)
    mels = r.uniform(0, 1, (2, 51, N_MELS)).astype(np.float32)
    out_ch = 10
    jm = jmel.Mel2Control(in_channels=N_MELS, hidden_channels=HIDDEN,
                          num_layers=LAYERS)
    variables = jm.init(jax.random.key(0), JSig(jnp.asarray(mels), HOP),
                        train=False, out_channels=out_ch)
    variables = {"params": seeded(variables["params"], 3, 0.3)}
    ref = jm.apply(variables, JSig(jnp.asarray(mels), HOP), train=train,
                   out_channels=out_ch, rngs={"dropout": jax.random.key(1)})

    tm = tmel.Mel2Control(out_ch, in_channels=N_MELS, hidden_channels=HIDDEN,
                          num_layers=LAYERS)
    load_flax_variables(tm, np_tree(variables))
    tm.train(not train)
    with pytest.raises(ValueError, match="mode"):
        tm(TSig(torch.from_numpy(mels), HOP), train=train)
    tm.train(train)
    with torch.no_grad():
        got = tm(TSig(torch.from_numpy(mels), HOP), train=train)
    assert got.hop == ref.hop == HOP
    r_d = np.asarray(ref.data)
    np.testing.assert_allclose(got.data.numpy(), r_d, rtol=1e-5,
                               atol=1e-5 * np.abs(r_d).max())


# ---------------------------------------------------------------------------
# DIO, cents, bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_dio_bit_for_bit(seed):
    """The port's copy of golf_tpu's numpy DIO on a synthetic voice (with
    unvoiced gaps and noise), at the vocoder's 10 ms frames."""
    x, _ = SyntheticVoiceDataset(1, 1.0, SR, seed=seed)[0]
    ref_f0, ref_t = jwl.dio(x.astype(np.float64), SR, f0_floor=65.0,
                            frame_period=10.0)
    f0, t = twl.dio(x.astype(np.float64), SR, f0_floor=65.0,
                    frame_period=10.0)
    assert np.array_equal(f0, ref_f0) and np.array_equal(t, ref_t)
    assert (f0 > 0).any() and (f0 == 0).any()


def test_freq2cent_matches_golf_tpu():
    f = np.array([80.0, 220.0, 440.0, 1000.0])
    np.testing.assert_array_equal(tdsp.freq2cent(f), jdsp.freq2cent(f))


@pytest.mark.parametrize("decoder", ["golf-v1", "ddsp"])
def test_bridge_loads_a_vocoder_strictly(decoder):
    """Every variable of golf_tpu's DDSPVocoder (the 1-D conv kernels, the
    group norm, the LSTM cells, the layer norm, the head, the decoder's
    weights and table, the log-mel min/max) lands on a key of the port's
    state_dict, and every key is filled: no key missing or left over."""
    x, f0 = batch()
    task = j_build(j_cfg(decoder))
    variables = jax.jit(lambda x_, f_: task.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1),
         "dropout": jax.random.key(2)}, JSig(x_, 1), JSig(f_, 1), True,
        method=lambda m, *a: m.training_step(*a)))(x, f0)
    t_task = t_build(t_cfg(decoder), device="cpu")
    load_flax_variables(t_task, np_tree(dict(variables)))
    sd = t_task.state_dict()
    conv = np.asarray(variables["params"]["encoder"]["backbone"]["Conv_0"]
                      ["kernel"])
    np.testing.assert_array_equal(
        sd["encoder.backbone.convs.0.weight"].numpy(),
        conv.transpose(2, 1, 0))
    np.testing.assert_array_equal(
        sd["feature_trsfm.log_mel_min"].numpy(),
        np.asarray(variables["stats"]["feature_trsfm"]["log_mel_min"]))
