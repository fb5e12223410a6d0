"""The port's time-sharded decoder modules against golf_tpu's sharded
modules under ``shard_map`` on 2 of the conftest's 8 CPU devices, on the
CPU.

The port's side runs once on 2 spawned gloo ranks (``run_ranks`` of
``test_torch_parallel_dp.py``) and returns every module's local output;
the tests hold them, concatenated along time, against golf_tpu's:

* the six filters of ``tests/test_seqpar.py``'s
  ``test_sharded_stft_filters_match`` (MLSA with the minimum-phase
  spectrum and the Taylor cascade, NHV's cepstral filter with zero and
  minimum phase, ∇WORLD's envelope, PQMF), the minimum-phase FIR, and
  ``stft_filter_sharded`` itself with a random one-sided and two-sided
  transfer: golf_tpu's limits, 2e-4 relative and 2e-5 absolute of max|ref|
  on the valid prefix ``min(len, T - hop)``;
* the sine bank (``HarmonicOscillator`` through ``AdditivePulseTrain``),
  ``PulseTrain`` and ``UniformNoise`` on golf_tpu's own ``u`` field, with
  the same limits over the whole window (the bank at 2e-4 of max|ref|),
  and bit for bit against the port's unsharded modules;
* the gradient of the MLSA filter's output (a weighted sum over the valid
  prefix) with respect to x and the mel-cepstrum, against the port's
  unsharded module: 1e-4 of max|ref|.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_parallel_dp import run_ranks

torch.set_num_threads(1)

B, HOP = 2, 240
TL = 8 * HOP
T = 2 * TL
F_GLOB = T // HOP
FILTERS = ("mlsa_min", "mlsa_taylor", "cep_zero", "cep_min", "world_sp",
           "pqmf", "minphase_fir")
STFT = ("stft_onesided", "stft_twosided")
SOURCES = ("additive_pulse_train", "pulse_train", "uniform_noise")


def module_args(case):
    """(class name, keyword arguments) of a case's module in both
    packages, as ``tests/test_seqpar.py`` builds them."""
    return {
        "mlsa_min": ("LTVMLSAFilter", dict(
            filter_order=24, frame_period=HOP, fft_length=1024,
            phase="minimum")),
        "mlsa_taylor": ("LTVMLSAFilter", dict(
            filter_order=24, frame_period=HOP, mode="multi-stage",
            cep_order=64, taylor_order=6)),
        "cep_zero": ("LTVCepFilter", dict(
            filter_order=120, n_fft=1024, hop_length=HOP, phase="zero")),
        "cep_min": ("LTVCepFilter", dict(
            filter_order=120, n_fft=1024, hop_length=HOP, phase="minimum")),
        "world_sp": ("DiffWorldSPFilter", dict(n_mels=40, n_fft=1024,
                                               hop_length=HOP)),
        "pqmf": ("LTVPQMF", dict(n_mag=8, filter_order=63)),
        "minphase_fir": ("LTVMinimumPhaseFIRFilter", dict(
            window="hanning", n_mag=17)),
        "additive_pulse_train": ("AdditivePulseTrain",
                                 dict(num_harmonics=16)),
        "pulse_train": ("PulseTrain", {}),
        "uniform_noise": ("UniformNoise", {}),
    }[case]


def inputs():
    rng = np.random.default_rng(3)
    d = {"x": rng.standard_normal((B, T)).astype(np.float32),
         "w": rng.standard_normal((B, T)).astype(np.float32),
         "phase": rng.uniform(0.001, 0.03, (B, T)).astype(np.float32)}
    ctrl = {"mlsa_min": rng.standard_normal((B, F_GLOB, 25)) * 0.3,
            "mlsa_taylor": rng.standard_normal((B, F_GLOB, 25)) * 0.2,
            "cep_zero": rng.standard_normal((B, F_GLOB, 121)) * 0.1,
            "cep_min": rng.standard_normal((B, F_GLOB, 121)) * 0.1,
            "world_sp": np.abs(rng.standard_normal((B, F_GLOB, 40))) + 0.1,
            "pqmf": rng.standard_normal((B, F_GLOB, 8)) * 0.3,
            "minphase_fir": rng.standard_normal((B, F_GLOB, 17)) * 0.3 - 1}
    d.update({k: v.astype(np.float32) for k, v in ctrl.items()})
    for name, bins in (("stft_onesided", 513), ("stft_twosided", 1024)):
        h = rng.standard_normal((B, F_GLOB, bins, 2)) * 0.5 + [1.0, 0.0]
        d[name] = (h[..., 0] + 1j * h[..., 1]).astype(np.complex64)
    # golf_tpu's u: its unsharded draw over the same (B, T), inverted
    import jax
    import jax.numpy as jnp
    from golf_tpu.core.sig import Sig as JSig
    from golf_tpu.models.noise import UniformNoise
    z = UniformNoise().apply({}, JSig(jnp.zeros((B, T)), 1),
                             rngs={"noise": jax.random.key(11)}).data
    d["u"] = (np.asarray(z, np.float64) / (2 * np.sqrt(3)) + 0.5).astype(
        np.float32)
    return d


def filters_worker(rank, d):
    from golf_tpu_torch.core.sig import Sig
    from golf_tpu_torch.models import filters, noise, synth
    from golf_tpu_torch.parallel import collectives
    from golf_tpu_torch.parallel import seqpar as sp
    env = sp.SeqParEnv(n_time=2, t_global=T, b_global=B, time_index=rank)
    window = slice(rank * TL, (rank + 1) * TL)
    x = torch.from_numpy(d["x"][:, window].copy())
    out = {}
    with sp.activate(env):
        for case in FILTERS:
            name, kw = module_args(case)
            mod = getattr(filters, name)(**kw)
            out[case] = mod(Sig(x, 1), Sig(torch.from_numpy(d[case]),
                                           HOP)).data
        for case in STFT:
            rows = d[case][:, rank * TL // HOP:(rank + 1) * TL // HOP]
            out[case] = sp.stft_filter_sharded(
                x, torch.from_numpy(rows.copy()), 1024, HOP, "hanning", env,
                onesided=case == "stft_onesided")
        phase = Sig(torch.from_numpy(d["phase"][:, window].copy()), 1)
        out["additive_pulse_train"] = synth.AdditivePulseTrain(16)(
            phase).data
        out["pulse_train"] = synth.PulseTrain()(phase).data
        out["uniform_noise"] = noise.UniformNoise()(
            Sig(x, 1), noise=torch.from_numpy(d["u"])).data
        # the MLSA filter's gradient on a weighted sum of the valid prefix
        xg = x.clone().requires_grad_()
        mc = torch.from_numpy(d["mlsa_min"]).requires_grad_()
        name, kw = module_args("mlsa_min")
        y = getattr(filters, name)(**kw)(Sig(xg, 1), Sig(mc, HOP)).data
        g = torch.arange(rank * TL, (rank + 1) * TL)
        w = torch.from_numpy(d["w"][:, window].copy()) * (g < T - HOP)
        (collectives.psum(torch.sum(y * w)) / 2).backward()
        out["grad_x"], out["grad_mc"] = xg.grad, mc.grad
    return {k: v.detach().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = inputs()
    outs = run_ranks(2, tmp_path_factory.mktemp("store"), filters_worker, d)
    got = {k: np.concatenate([o[k] for o in outs], axis=1)
           for k in outs[0] if k != "grad_mc"}
    got["grad_mc"] = sum(o["grad_mc"] for o in outs)
    return d, got


@pytest.fixture(scope="module")
def golf():
    """golf_tpu's sharded modules under shard_map on 2 CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from golf_tpu.core.sig import Sig as JSig
    from golf_tpu.models import filters, noise, synth
    from golf_tpu.parallel import seqpar as js
    from golf_tpu.parallel.mesh import make_mesh

    d = inputs()
    mesh = make_mesh(data=1, time=2, devices=jax.devices()[:2])
    pt = P(None, "time")

    def run(fn, *args):
        def body(*a):
            with js.activate(js.SeqParEnv("time", 2, T, B, None, 1)):
                return fn(*a)
        return np.asarray(jax.jit(shard_map(
            body, mesh=mesh, in_specs=(pt,) * len(args), out_specs=pt,
            check_vma=False))(*[jnp.asarray(a) for a in args]))

    ref = {}
    for case in FILTERS:
        name, kw = module_args(case)
        mod = getattr(filters, name)(**kw)
        ctrl = jnp.asarray(d[case])
        ref[case] = run(lambda v, m=mod, c=ctrl: m.apply(
            {}, JSig(v, 1), JSig(c, HOP)).data, d["x"])
    for case in STFT:
        h = jnp.asarray(d[case])

        def stft(v, h=h, case=case):
            e = js.current()
            rows = jax.lax.dynamic_slice_in_dim(
                h, js.tidx(e) * (TL // HOP), TL // HOP, axis=1)
            return js.stft_filter_sharded(v, rows, 1024, HOP, "hanning", e,
                                          onesided=case == "stft_onesided")
        ref[case] = run(stft, d["x"])
    ref["additive_pulse_train"] = run(lambda p: synth.AdditivePulseTrain(
        num_harmonics=16).apply({}, JSig(p, 1)).data, d["phase"])
    ref["pulse_train"] = run(lambda p: synth.PulseTrain().apply(
        {}, JSig(p, 1)).data, d["phase"])
    ref["uniform_noise"] = run(lambda v: noise.UniformNoise().apply(
        {}, JSig(v, 1), rngs={"noise": jax.random.key(11)}).data, d["x"])
    return ref


def rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


@pytest.mark.parametrize("case", FILTERS + STFT + SOURCES)
def test_sharded_module_matches_golf_tpu(port, golf, case):
    """golf_tpu's limits (``tests/test_seqpar.py``): 2e-4 relative and 2e-5
    absolute of max|ref|, on the valid prefix for the filters. The sine bank
    is held at 2e-4 of max|ref|: the port's unsharded bank already sits
    6.5e-5 of max|ref| from golf_tpu's (float32 sines of k times the phase),
    and its sharding adds nothing (the test below)."""
    got, ref = port[1][case], golf[case]
    assert got.shape == ref.shape
    n = T - HOP if case in FILTERS + STFT else T
    ref, got = ref[:, :n], got[:, :n]
    if case == "additive_pulse_train":
        assert rel(got, ref) <= 2e-4
        return
    scale = np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= 2e-5 * scale + 2e-4 * np.abs(ref)), \
        rel(got, ref)


@pytest.mark.parametrize("case", SOURCES)
def test_sharded_source_is_unsharded_source(port, case):
    """The sources' sharding is exact: bit for bit the port's unsharded
    module on the whole signal (the phase by the global wrapped cumsum, the
    field's window)."""
    from golf_tpu_torch.core.sig import Sig
    from golf_tpu_torch.models import noise, synth
    d, got = port
    name, kw = module_args(case)
    if case == "uniform_noise":
        want = noise.UniformNoise()(Sig(torch.from_numpy(d["x"]), 1),
                                    noise=torch.from_numpy(d["u"]))
    else:
        want = getattr(synth, name)(**kw)(Sig(torch.from_numpy(d["phase"]),
                                              1))
    np.testing.assert_array_equal(got[case], want.data.numpy())


@pytest.mark.parametrize("wrt", ["x", "mc"])
def test_sharded_mlsa_gradient_matches_unsharded(port, wrt):
    """The gradient through ``stft_filter_sharded``'s halos and spills equals
    the port's unsharded MLSA filter's, 1e-4 of max|ref|."""
    from golf_tpu_torch.core.sig import Sig
    from golf_tpu_torch.models import filters
    d, got = port
    x = torch.from_numpy(d["x"]).requires_grad_()
    mc = torch.from_numpy(d["mlsa_min"]).requires_grad_()
    name, kw = module_args("mlsa_min")
    y = getattr(filters, name)(**kw)(Sig(x, 1), Sig(mc, HOP)).data
    n = min(y.shape[1], T - HOP)
    torch.sum(y[:, :n] * torch.from_numpy(d["w"][:, :n])).backward()
    ref = (x if wrt == "x" else mc).grad.numpy()
    assert rel(got["grad_" + wrt], ref) <= 1e-4
