"""Streaming synthesis of the port (``golf_tpu_torch.serve.GOLFStream`` and
``ops.allpole.allpole_stream``) against golf_tpu's and against the port's
offline decoder, on the CPU. The decoder is the one of
``tests/test_stream.py`` (lpc 8, 128 table points, table_size 16, n_mag 33,
room filter of 32 with a random kernel), its weights carried over by the
bridge; the noise is injected, so both sides read the same field."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.core.sig import Sig as JSig
from golf_tpu.ops.allpole import allpole_stream as j_allpole_stream
from golf_tpu.serve import GOLFStream as JStream
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.models.filters import (LTIAcousticFilter,
                                           LTVMinimumPhaseFilter,
                                           LTVMinimumPhaseFilterPrecise,
                                           LTVZeroPhaseFIRFilter)
from golf_tpu_torch.models.noise import StandardNormalNoise
from golf_tpu_torch.models.sf import SourceFilterSynth
from golf_tpu_torch.models.synth import DownsampledIndexedGlottalFlowTable
from golf_tpu_torch.ops import allpole as tap
from golf_tpu_torch.serve import GOLFStream
from tests.test_stream import _build

torch.set_num_threads(1)

CHUNK, N_CHUNKS, HOP = 2400, 8, 240


def _port_decoder(end_filter=None):
    return SourceFilterSynth(
        harm_oscillator=DownsampledIndexedGlottalFlowTable(
            hop_rate=10, in_channels=16, oversampling=4, equal_energy=True,
            table_type="derivative", normalize_method="constant_power",
            align_peak=True, trainable=False, min_R_d=0.3, max_R_d=2.7,
            lf_v2=True, points=128, table_size=16),
        noise_generator=StandardNormalNoise(),
        noise_filter=LTVZeroPhaseFIRFilter(window="hanning", n_mag=33),
        end_filter=end_filter or LTVMinimumPhaseFilterPrecise(
            lpc_order=8, lpc_parameterisation="rc2lpc"),
        room_filter=LTIAcousticFilter(length=32, conv_method="fft"),
        subtract_harmonics=False)


@pytest.fixture(scope="module")
def setup():
    """golf_tpu's decoder, variables, applied ctrl (as numpy) and inputs,
    and the port's decoder with the same weights."""
    j_dec, variables, raw, phase, noise = _build()
    ctrl = jax.jit(lambda rw: j_dec.apply(
        variables, rw, method=lambda m, r_: m.apply_ctrl(r_)))(raw)
    ctrl_np = {k: tuple(np.array(s.data) for s in v)
               for k, v in ctrl.items()
               if k in ("harm_oscillator_params", "noise_filter_params",
                        "end_filter_params")}
    t_dec = _port_decoder()
    load_flax_variables(t_dec, jax.tree_util.tree_map(np.asarray, variables))
    return dict(j_dec=j_dec, variables=variables, ctrl=ctrl_np,
                phase=np.array(phase), noise=np.array(noise),
                t_dec=t_dec)


_HOPS = {"harm_oscillator_params": 2400, "noise_filter_params": HOP,
         "end_filter_params": HOP}


def _chunk_ctrl(ctrl, c, sig, to):
    """Chunk c's rows of every ctrl kind (the table weights at hop 2400,
    one row a chunk)."""
    out = {}
    for k, leaves in ctrl.items():
        per = CHUNK // _HOPS[k]
        out[k] = tuple(sig(to(v[:, c * per:(c + 1) * per]), _HOPS[k])
                       for v in leaves)
    return out


def _tail_ctrl(ctrl, sig, to):
    """The table-weight rows past the last full chunk."""
    k = "harm_oscillator_params"
    return {k: (sig(to(ctrl[k][0][:, N_CHUNKS:]), _HOPS[k]),)}


def _run_stream(stream, ctrl, phase, noise, sig, to, out_np):
    outs = []
    for c in range(N_CHUNKS):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        out = stream.push(_chunk_ctrl(ctrl, c, sig, to), to(phase[:, sl]),
                          to(noise[:, sl]))
        assert (out is None) == (c < 2), c
        if out is not None:
            assert out.shape == (phase.shape[0], CHUNK)
            outs.append(out_np(out))
    flushed = out_np(stream.flush(_tail_ctrl(ctrl, sig, to)))
    assert flushed.shape == (phase.shape[0], 2 * CHUNK)
    return np.concatenate(outs + [flushed], axis=1)


def _port_stream(setup, **kw):
    stream = GOLFStream(setup["t_dec"], chunk=CHUNK, **kw)
    return _run_stream(stream, setup["ctrl"], setup["phase"], setup["noise"],
                       TSig, torch.from_numpy, lambda t: t.numpy())


def test_allpole_stream_chunked_matches_oneshot():
    """Chunks of 1200 chained through zi against the one-shot filter:
    within 2e-5 of max|y| (golf_tpu's bound, ``tests/test_stream.py``)."""
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((2, 4800)).astype(np.float32))
    a = torch.from_numpy((r.standard_normal((2, 4800, 8)) * 0.1)
                         .astype(np.float32))
    ref = tap.allpole(x, a).numpy()
    zi, outs = None, []
    for c in range(4):
        y, zi = tap.allpole_stream(x[:, c * 1200:(c + 1) * 1200],
                                   a[:, c * 1200:(c + 1) * 1200], zi)
        assert zi.shape == (2, 8) and zi.dtype == torch.float32
        outs.append(y.numpy())
    scale = np.abs(ref).max() + 1e-6
    np.testing.assert_allclose(np.concatenate(outs, 1) / scale, ref / scale,
                               atol=2e-5)


@pytest.mark.parametrize("chunk", [40, 1200])
def test_allpole_stream_matches_golf_tpu(chunk):
    """Chunk by chunk against golf_tpu's allpole_stream, y and zi_next,
    from a random initial state: chunks of 40 take the scan on both sides,
    of 1200 the blocked form; within 1e-5 of max|y| (float32 on both
    sides, the blocked form's sums in another order)."""
    r = np.random.default_rng(1)
    t = 4 * chunk
    x = r.standard_normal((2, t)).astype(np.float32)
    a = (r.standard_normal((2, t, 8)) * 0.1).astype(np.float32)
    zj = zt = r.standard_normal((2, 8)).astype(np.float32)
    zt = torch.from_numpy(zt)
    for c in range(4):
        sl = slice(c * chunk, (c + 1) * chunk)
        yj, zj = j_allpole_stream(jnp.asarray(x[:, sl]), jnp.asarray(a[:, sl]),
                                  jnp.asarray(zj))
        yt, zt = tap.allpole_stream(torch.from_numpy(x[:, sl]),
                                    torch.from_numpy(a[:, sl]), zt)
        scale = np.abs(np.asarray(yj)).max()
        assert np.abs(yt.numpy() - np.asarray(yj)).max() / scale < 1e-5, c
        assert np.abs(zt.numpy() - np.asarray(zj)).max() / scale < 1e-5, c


def test_allpole_stream_refuses_short_chunks():
    with pytest.raises(ValueError, match="shorter than the order"):
        tap.allpole_stream(torch.zeros(2, 7), torch.zeros(2, 7, 8))


def test_allpole_chunked_plain_starts_from_zi():
    """The kernel's float64 mirror from an initial state: against a float64
    scan from the same state, one chunk (T <= CHUNK) and several; within
    1e-6 of max|y| (float32 output)."""
    r = np.random.default_rng(2)
    for t in (300, 1300):
        x = torch.from_numpy(r.standard_normal((2, t)).astype(np.float32))
        a = torch.from_numpy((r.standard_normal((2, t, 8)) * 0.1)
                             .astype(np.float32))
        zi = torch.from_numpy(r.standard_normal((2, 8)).astype(np.float32))
        ref = tap.allpole_scan(x.double(), a.double(), zi.double())
        got = tap.allpole_chunked_plain(x, a, zi=zi).double()
        assert ((got - ref).abs().max() / ref.abs().max()).item() < 1e-6, t


def test_golf_stream_matches_golf_tpu(setup):
    """The port's GOLFStream against golf_tpu's on the same applied ctrl and
    noise, push by push and the flush: within 1e-4 of max|y| (float32 on
    both sides; the FFT libraries and the blocked all-pole sum in other
    orders)."""
    ref = _run_stream(JStream(setup["j_dec"], setup["variables"],
                              chunk=CHUNK),
                      setup["ctrl"], setup["phase"], setup["noise"], JSig,
                      jnp.asarray, np.asarray)
    got = _port_stream(setup)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-4, err


def test_golf_stream_matches_offline_decoder(setup):
    """The port's stream against the port's one-shot decoder on every
    sample of the offline support: within 5e-4 of max|y| (golf_tpu's bound,
    ``tests/test_stream.py``)."""
    dec = setup["t_dec"]
    ctrl = {k: tuple(TSig(torch.from_numpy(v), _HOPS[k]) for v in leaves)
            for k, leaves in setup["ctrl"].items()}
    with torch.no_grad():
        ref = dec(TSig(torch.from_numpy(setup["phase"]), 1), **ctrl,
                  noise=torch.from_numpy(setup["noise"])).data.numpy()
    got = _port_stream(setup)
    assert got.shape[1] >= ref.shape[1]
    err = np.abs(got[:, :ref.shape[1]] - ref).max() / np.abs(ref).max()
    assert err < 5e-4, err


def test_golf_stream_default_noise_is_seeded(setup):
    """Without injected noise a stream draws from its own generator: the
    same seed gives the same audio, another seed other audio."""
    def run(seed):
        stream = GOLFStream(setup["t_dec"], chunk=CHUNK, seed=seed)
        outs = [stream.push(_chunk_ctrl(setup["ctrl"], c, TSig,
                                        torch.from_numpy),
                            torch.from_numpy(
                                setup["phase"][:, c * CHUNK:(c + 1) * CHUNK]))
                for c in range(3)]
        return outs[2]
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))


def test_golf_stream_flush_and_voicing(setup):
    stream = GOLFStream(setup["t_dec"], chunk=CHUNK)
    assert stream.flush().shape == (1, 0)            # nothing pushed
    stream = GOLFStream(setup["t_dec"], chunk=CHUNK)
    ctrl = _chunk_ctrl(setup["ctrl"], 0, TSig, torch.from_numpy)
    phase = torch.from_numpy(setup["phase"][:, :CHUNK])
    assert stream.push(ctrl, phase) is None
    # one push: the flush emits chunk 0 alone, on its virtual next chunk
    assert stream.flush().shape == (2, CHUNK)
    with pytest.raises(ValueError, match="voicing"):
        GOLFStream(setup["t_dec"], chunk=CHUNK).push(
            {**ctrl, "voicing": (TSig(torch.ones(2, 10), HOP),)}, phase)


def test_golf_stream_takes_the_hops_from_the_ctrl(setup):
    """The pushed Sigs carry the hops: table weights at other than
    ``hop_rate`` times the end filter's hop are refused on the first push,
    and a later push whose hops differ from the first's is refused."""
    ctrl = _chunk_ctrl(setup["ctrl"], 0, TSig, torch.from_numpy)
    phase = torch.from_numpy(setup["phase"][:, :CHUNK])
    tw = ctrl["harm_oscillator_params"][0]
    bad = {**ctrl, "harm_oscillator_params": (TSig(tw.data, HOP),)}
    with pytest.raises(ValueError, match="disagree"):
        GOLFStream(setup["t_dec"], chunk=CHUNK).push(bad, phase)
    stream = GOLFStream(setup["t_dec"], chunk=CHUNK)
    assert stream.push(ctrl, phase) is None
    with pytest.raises(ValueError, match="differ"):
        stream.push(bad, phase)


def test_golf_stream_refuses_other_end_filters():
    """GOLF-ff's frame-wise end filter has no exact carry: refused."""
    with pytest.raises(NotImplementedError, match="LTVMinimumPhaseFilter"):
        GOLFStream(_port_decoder(LTVMinimumPhaseFilter(
            lpc_order=8, lpc_parameterisation="rc2lpc")), chunk=CHUNK)


def test_stream_demo_runs_on_the_cpu(tmp_path, capsys):
    """``scripts/stream_demo_torch.py`` on ``cfg/ae/synthetic.yaml`` with the
    GOLF-ss decoder and the streaming encoder: one JSON line of the
    encoder's latencies and ctrl error, one of the decoder's, and a wav of
    the whole utterance."""
    import importlib.util
    import json
    spec = importlib.util.spec_from_file_location(
        "stream_demo_torch", "scripts/stream_demo_torch.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    out = tmp_path / "stream.wav"
    assert demo.main(["--config", "cfg/ae/synthetic.yaml", "--model",
                      "cfg/ae/decoder/golf-precise.yaml", "--device", "cpu",
                      "--enc_stream", "8", "--out", str(out),
                      "data.init_args.duration=0.6"]) == 0
    enc, dec = (json.loads(ln) for ln in
                capsys.readouterr().out.strip().splitlines()[-2:])
    assert enc["enc_ctrl_rel_err"] < 2e-2
    assert {"enc_median_push_latency_ms", "enc_p99_push_latency_ms",
            "enc_algorithmic_latency_ms"} <= set(enc)
    assert dec["chunks"] == 6 and dec["samples"] == 6 * 2400
    assert dec["finite"] and dec["dec_algorithmic_latency_ms"] == 200.0
    assert out.exists()
