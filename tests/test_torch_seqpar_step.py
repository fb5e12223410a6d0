"""The port's time-sharded training step (``parallel.seqpar.
make_sharded_train_step``) against golf_tpu's single-device step, on the
CPU.

For a tiny GOLF-ss (oversampling 1 and 4) and GOLF-ff (the configuration of
``tests/test_seqpar.py``), B = 4 x 9600 samples: golf_tpu's jitted step
gives the loss, the gradients and its noise field; four spawned gloo ranks
run the port's sharded step at 2 x 2 (data x time), then ranks 0 and 1 at
1 x 2, on the global batch with that noise and golf_tpu's weights. Held
with golf_tpu's own limits for its sharded step (``tests/test_seqpar.py``):
loss within 2e-4 relative and 2e-5 absolute, each gradient scaled by its
largest entry within 5e-4 (the conv biases in front of a train-mode batch
norm, zero in exact arithmetic, against their conv weight's gradient, as
``test_torch_train.py`` holds them).
"""

import glob
import os

import numpy as np
import pytest
import torch

from tests.test_torch_parallel_dp import (ROOT, JaxReference, check_grads,
                                          grad_excess, many_sharded_worker,
                                          run_ranks, sharded_worker,
                                          tiny_cfg)

torch.set_num_threads(1)

CASES = {"ss1": dict(oversampling=1), "ss4": dict(oversampling=4),
         "ff": dict(oversampling=1, ff=True)}
LAYOUTS = [(2, 2), (1, 2)]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    ref = JaxReference(tiny_cfg(**CASES[request.param]), 4, 4 * 2400,
                       seed=2, key=5)
    out = run_ranks(4, tmp_path_factory.mktemp("store"), sharded_worker,
                    ref.cfg, ref.variables, ref.x, ref.f0, ref.noise,
                    LAYOUTS)
    return ref, dict(zip(LAYOUTS, out[0]))


@pytest.mark.parametrize("layout", LAYOUTS, ids=["2x2", "1x2"])
def test_sharded_step_matches_golf_tpu(case, layout):
    ref, got = case
    loss, grads = got[layout]
    assert abs(loss - ref.loss) <= 2e-4 * abs(ref.loss) + 2e-5
    check_grads(grads, ref.grads, 5e-4)


# ---------------------------------------------------------------------------
# the other decoders: the Interspeech24 baselines, golf-v1 and ddsp
# ---------------------------------------------------------------------------

PULSES = {"class_path": "models.synth.AdditivePulseTrain",
          "init_args": {"num_harmonics": 16}}
NOISE = {"class_path": "models.noise.StandardNormalNoise"}
NOISE_FILTER = {"class_path": "models.filters.LTVZeroPhaseFIRFilter",
                "init_args": {"window": "hanning", "n_mag": 33}}
ACOUSTIC = {"class_path": "models.filters.LTIAcousticFilter",
            "init_args": {"length": 32, "conv_method": "fft"}}
CEP = {"class_path": "models.filters.LTVCepFilter",
       "init_args": {"n_fft": 512, "window": "hanning", "filter_order": 60,
                     "hop_length": 240, "phase": "min"}}


def _sf(end_filter):
    cfg = tiny_cfg(1)
    cfg["decoder"]["init_args"]["harm_oscillator"] = PULSES
    cfg["decoder"]["init_args"]["end_filter"] = end_filter
    return cfg


def _hpn(osc, harm_filter):
    cfg = tiny_cfg(1)
    cfg["decoder"] = {"class_path": "models.hpn.HarmonicPlusNoiseSynth",
                      "init_args": {"harm_oscillator": osc,
                                    "noise_generator": NOISE,
                                    "noise_filter": NOISE_FILTER,
                                    "harm_filter": harm_filter,
                                    "end_filter": ACOUSTIC}}
    return cfg


def _voiced(cfg):
    cfg["encoder_init_args"]["learn_voicing"] = True
    return cfg


def variant_cfg(name):
    """The tiny configurations: ``mlsa`` and ``nhv`` as
    ``tests/test_seqpar.py``'s ``test_seqpar_stft_variant_training_step_
    matches`` builds them; ``world``, ``mlsa-taylor`` (``taylor_order`` 6,
    as its module test), golf-v1's and ddsp's topologies alike; a learned
    voicing on the GOLF-ss decoder above and on ``nhv``."""
    golf_osc = tiny_cfg(1)["decoder"]["init_args"]["harm_oscillator"]
    return {
        "mlsa": lambda: _sf({
            "class_path": "models.filters.LTVMLSAFilter",
            "init_args": {"mode": "freq-domain", "frame_length": 512,
                          "fft_length": 512, "window": "hanning",
                          "filter_order": 12, "frame_period": 240,
                          "alpha": 0.46, "phase": "minimum"}}),
        "mlsa-taylor": lambda: _sf({
            "class_path": "models.filters.LTVMLSAFilter",
            "init_args": {"mode": "multi-stage", "cep_order": 64,
                          "filter_order": 12, "frame_period": 240,
                          "alpha": 0.46, "phase": "minimum",
                          "taylor_order": 6}}),
        "world": lambda: _sf({
            "class_path": "models.filters.DiffWorldSPFilter",
            "init_args": {"n_fft": 512, "n_mels": 40, "hop_length": 240,
                          "sample_rate": 24000, "f_min": 0.0,
                          "f_max": 12000.0, "center": True,
                          "window": "hanning"}}),
        "nhv": lambda: _hpn(PULSES, CEP),
        "golf-v1": lambda: _hpn(golf_osc, {
            "class_path": "models.filters.LTVMinimumPhaseFilter",
            "init_args": {"window": "hanning", "window_length": 960,
                          "lpc_order": 8,
                          "lpc_parameterisation": "rc2lpc"}}),
        "ddsp": lambda: _hpn({"class_path": "models.synth.AdditiveSynthesizer",
                              "init_args": {"num_harmonics": 16}},
                             {"class_path": "models.ctrl.PassThrough"}),
        "golf-voicing": lambda: _voiced(tiny_cfg(1)),
        "hpn-voicing": lambda: _voiced(_hpn(PULSES, CEP)),
    }[name]()


VARIANTS = ("mlsa", "nhv", "world", "mlsa-taylor", "golf-v1", "ddsp",
            "golf-voicing", "hpn-voicing")
# golf_tpu's limits for its STFT-filter variants' step
# (``test_seqpar_stft_variant_training_step_matches``)
LOSS_RTOL, LOSS_ATOL, GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5, 5e-3, 2e-3


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    """golf_tpu's single-device step of every variant at B = 2 x 9600, then
    the port's sharded step of each at 1 x 2 on one spawn of 2 ranks."""
    refs = {name: JaxReference(variant_cfg(name), 2, 4 * 2400, seed=13,
                               key=21) for name in VARIANTS}
    jobs = [(r.cfg, r.variables, r.x, r.f0, r.noise) for r in refs.values()]
    out = run_ranks(2, tmp_path_factory.mktemp("store"), many_sharded_worker,
                    jobs, [(1, 2)])
    return refs, {name: got[0] for name, got in zip(refs, out[0])}


def within_limits(loss, grads, ref_loss, ref_grads):
    """(loss within limits, the gradients out of them by leaf)."""
    ok = abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss) + LOSS_ATOL
    return ok, {k: e for k, e in grad_excess(grads, ref_grads, GRAD_ATOL,
                                            GRAD_RTOL).items() if e > 0}


@pytest.mark.parametrize("name", VARIANTS)
def test_sharded_variant_matches_golf_tpu_single_device(variants, name):
    """The port's sharded step at 1 x 2 against golf_tpu's single-device
    step (its ``exact parity`` contract), with the limits above."""
    refs, got = variants
    loss, grads = got[name]
    loss_ok, bad = within_limits(loss, grads, refs[name].loss,
                                 refs[name].grads)
    assert loss_ok, (loss, refs[name].loss)
    assert not bad, bad


@pytest.mark.parametrize("name", ["ddsp", "golf-voicing", "hpn-voicing"])
def test_reference_fault_golf_tpu_sharded_step_breaks_parity(variants,
                                                             name):
    """A fault of the reference that the port does not share (ROADMAP.md
    §C): golf_tpu's own sharded step at 1 x 2 misses its single-device step
    by more than the limits above. In ddsp, ``AdditiveSynthesizer``
    multiplies the global frame-rate amplitudes by a Sig of the rank's
    window, and the hop broadcast takes the first window's amplitudes on
    every rank; with a learned voicing, the source-filter decoder localizes
    the voicing before its 0.5 threshold (the unsharded gate thresholds the
    frames, then upsamples), and the harmonic-plus-noise decoder multiplies
    the rank's phase by the global voicing unlocalized. The port's step
    meets the limits on the same variants (the test above)."""
    import jax
    from golf_tpu.parallel import seqpar as js
    from golf_tpu.parallel.mesh import make_mesh
    from golf_tpu_torch.bridge import flax_to_state_dict
    ref = variants[0][name]
    v = ref.variables
    step = js.make_sharded_train_fn(
        ref.task, make_mesh(data=1, time=2, devices=jax.devices()[:2]))
    loss_j, grads_j, _, _ = step(v["params"], v.get("stats", {}),
                                 v.get("batch_stats", {}), ref.x, ref.f0,
                                 ref.key)
    grads_j = {k: t.numpy() for k, t in flax_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, grads_j)}).items()}
    loss_ok, bad = within_limits(float(loss_j), grads_j, ref.loss, ref.grads)
    assert not loss_ok or bad, (float(loss_j), ref.loss)


DECODERS = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(ROOT, "cfg", "ae", "decoder", "*.yaml")))


@pytest.mark.parametrize("decoder", DECODERS)
def test_unsharded_decode_len_matches_eval_shape(decoder):
    """``unsharded_decode_len`` (the modules' ``out_len`` composed) equals
    the length ``jax.eval_shape`` gives golf_tpu's decoder, for every
    ``cfg/ae/decoder/*.yaml`` with the tiny encoder and a learned voicing,
    at T = 4800, 7320 and 9600, on the ctrl shapes golf_tpu's encoder
    makes."""
    import copy
    import jax
    import jax.numpy as jnp
    import yaml
    from golf_tpu.core.sig import Sig as JSig
    from golf_tpu.tasks.ae import build_voice_autoencoder as j_build
    from golf_tpu_torch.config.registry import resolve_interpolations
    from golf_tpu_torch.core.sig import Sig
    from golf_tpu_torch.parallel.seqpar import unsharded_decode_len
    from golf_tpu_torch.tasks.ae import build_voice_autoencoder
    cfg = _voiced(tiny_cfg(1))
    with open(os.path.join(ROOT, "cfg", "ae", "decoder",
                           decoder + ".yaml")) as f:
        cfg["decoder"] = resolve_interpolations(yaml.safe_load(f))["decoder"]
    j_task = j_build(copy.deepcopy(cfg))
    dec = build_voice_autoencoder(copy.deepcopy(cfg), device="cpu").decoder
    keys = {"noise": jax.random.key(1), "dropout": jax.random.key(2)}

    def shapes(x, f0):
        v = j_task.init({"params": jax.random.key(0), **keys}, JSig(x, 1),
                        JSig(f0, 1), True,
                        method=lambda m, *a: m.training_step(*a))
        (params, _, _), _ = j_task.apply(
            v, JSig(x, 1), JSig(f0, 1), True, rngs=keys,
            mutable=["stats", "batch_stats"],
            method=lambda m, *a: m.prepare_training(*a))
        ctrl = j_task.apply(v, {k: w for k, w in params.items()
                                if k.endswith("_params")},
                            method=lambda m, r: m.decoder.apply_ctrl(r))
        out = j_task.apply(v, rngs=keys, method=lambda m: m.decoder(
            phase=params["phase"], voicing=params["voicing"], **ctrl))
        return ctrl, params["voicing"], out

    def sig(s):
        return Sig(torch.zeros(s.data.shape), s.hop)

    for t in (4800, 7320, 9600):
        x = jax.ShapeDtypeStruct((1, t), jnp.float32)
        ctrl, voicing, out = jax.eval_shape(shapes, x, x)
        got = unsharded_decode_len(
            dec, {k: tuple(sig(s) for s in v) for k, v in ctrl.items()}, t,
            sig(voicing))
        assert got == out.data.shape[1], (t, got, out.data.shape)


def test_unsharded_decode_len_names_a_module_without_a_sharded_branch():
    """A decoder with a module that has no sharded branch (an allpass room
    filter, the sample-wise IIR on the whole clip) raises
    ``NotImplementedError`` with that module's class name."""
    import copy
    from golf_tpu_torch.core.sig import Sig
    from golf_tpu_torch.parallel.seqpar import unsharded_decode_len
    from golf_tpu_torch.tasks.ae import build_voice_autoencoder
    cfg = tiny_cfg(1)
    cfg["decoder"]["init_args"]["room_filter"] = {
        "class_path": "models.filters.LTIComplexConjAllpassFilter",
        "init_args": {"num_roots": 2}}
    dec = build_voice_autoencoder(copy.deepcopy(cfg), device="cpu").decoder
    frames = Sig(torch.zeros(1, 40, 8), 240)
    ctrl = {"harm_oscillator_params": (Sig(torch.zeros(1, 5), 2400),),
            "noise_filter_params": (Sig(torch.zeros(1, 40, 33), 240),),
            "end_filter_params": (Sig(torch.zeros(1, 40), 240), frames)}
    with pytest.raises(NotImplementedError,
                       match="LTIComplexConjAllpassFilter"):
        unsharded_decode_len(dec, ctrl, 9600, None)
