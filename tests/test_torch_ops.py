"""The port's signal ops against golf_tpu's, on the CPU, on the same
numpy-seeded inputs: the Sig hop algebra, wrapped_cumsum, decimate,
unfold, rc2lpc, zero_phase_fir, the spectrogram, overlap-add and the
numpy host code the port keeps its own copy of."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.core import sig as jsig
from golf_tpu.ops import dsp as jdsp
from golf_tpu.ops import fftsize as jfftsize
from golf_tpu.ops import lf as jlf
from golf_tpu.ops import resample as jresample
from golf_tpu.ops import stft as jstft
from golf_tpu_torch.core import sig as tsig
from golf_tpu_torch.ops import dsp as tdsp
from golf_tpu_torch.ops import fftsize as tfftsize
from golf_tpu_torch.ops import lf as tlf
from golf_tpu_torch.ops import resample as tresample
from golf_tpu_torch.ops import stft as tstft

torch.set_num_threads(1)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("hop,frames", [(240, 11), (4, 7), (1, 5)])
def test_reduce_hop_length_matches(hop, frames):
    """Align-corners upsample to (n-1)*hop + 1 samples (exact positions)."""
    x = _rng(hop).standard_normal((2, frames, 3)).astype(np.float32)
    ref = jsig.Sig(_j(x), hop).reduce_hop_length()
    out = tsig.Sig(_t(x), hop).reduce_hop_length()
    assert out.shape == ref.shape == (2, (frames - 1) * hop + 1, 3)
    assert out.hop == ref.hop == 1
    np.testing.assert_allclose(out.data.numpy(), np.asarray(ref.data),
                               atol=1e-6, rtol=0)


def test_sig_broadcast_arithmetic_and_where_match():
    r = _rng(1)
    a = r.standard_normal((2, 1000)).astype(np.float32)
    g = r.standard_normal((2, 6)).astype(np.float32)
    c = r.standard_normal((2, 6, 4)).astype(np.float32)
    ja, jg, jc = jsig.Sig(_j(a), 1), jsig.Sig(_j(g), 240), jsig.Sig(_j(c), 240)
    ta, tg, tc = tsig.Sig(_t(a), 1), tsig.Sig(_t(g), 240), tsig.Sig(_t(c), 240)
    for ref, out in ((ja * jg, ta * tg), (jg - ja, tg - ta),
                     (ja / (jg + 3.0), ta / (tg + 3.0)),
                     (jsig.sig_where(ja > 0, jg, 0.0),
                      tsig.sig_where(ta > 0, tg, 0.0)),
                     (ja + jc, ta + tc), (2.0 - jg, 2.0 - tg)):
        assert out.shape == tuple(ref.shape) and out.hop == ref.hop
        np.testing.assert_allclose(out.data.numpy(), np.asarray(ref.data),
                                   atol=1e-5, rtol=1e-6)
    ref = jsig.Sig(_j(a), 1).set_hop_length(240).truncate(3)
    out = tsig.Sig(_t(a), 1).set_hop_length(240).truncate(3)
    assert out.hop == ref.hop == 240
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(ref.data))


def test_wrapped_cumsum_matches_over_long_signal():
    # 4x-oversampled 6 s phase increments: the two mod-1 scans group the
    # block totals differently (log-depth trees of other shapes), so they
    # agree to a few ulp(2) per level, well inside 2e-5 of a cycle, where
    # a plain fp32 cumsum % 1 drifts past it
    r = _rng(2)
    t = 576000
    x = (r.uniform(80, 400, (2, 1)) / 96000
         + r.standard_normal((2, t)) * 1e-5).astype(np.float32)
    ref = np.asarray(jdsp.wrapped_cumsum(_j(x)))
    out = tdsp.wrapped_cumsum(_t(x)).numpy()

    def circ(u, v):                               # distance on the circle
        d = np.abs(u - v)
        return np.minimum(d, 1 - d).max()

    assert circ(out, ref) < 2e-5
    exact = np.cumsum(x.astype(np.float64), axis=1) % 1
    assert circ(out, exact) < 2e-5
    assert circ(torch.remainder(torch.cumsum(_t(x), 1), 1).numpy(),
                exact) > 2e-5
    assert out.min() >= 0 and out.max() < 1


@pytest.mark.parametrize("t,q", [(4801, 4), (1000, 2), (999, 3)])
def test_decimate_matches(t, q):
    x = _rng(t).standard_normal((2, t)).astype(np.float32)
    ref = np.asarray(jresample.decimate(_j(x), q))
    out = tresample.decimate(_t(x), q).numpy()
    assert out.shape == ref.shape == (2, -(-t // q))
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("size,step", [(960, 240), (749, 240), (7, 3)])
def test_unfold_matches(size, step):
    x = _rng(size).standard_normal((2, 3000)).astype(np.float32)
    ref = np.asarray(jdsp.unfold(_j(x), size, step))
    out = tdsp.unfold(_t(x), size, step).numpy()
    np.testing.assert_array_equal(out, ref)


def test_rc2lpc_and_zero_phase_fir_match():
    r = _rng(3)
    rc = np.tanh(r.standard_normal((2, 5, 22))).astype(np.float32)
    np.testing.assert_allclose(tdsp.rc2lpc(_t(rc)).numpy(),
                               np.asarray(jdsp.rc2lpc(_j(rc))),
                               atol=1e-5, rtol=1e-5)
    log_mag = (r.standard_normal((2, 5, 256)) * 0.5).astype(np.float32)
    np.testing.assert_allclose(tdsp.zero_phase_fir(_t(log_mag)).numpy(),
                               np.asarray(jdsp.zero_phase_fir(_j(log_mag))),
                               atol=2e-6, rtol=0)


@pytest.mark.parametrize("n_fft,hop,win,window", [(1024, 240, None, "hann"),
                                                  (512, 120, 400, "hanning")])
def test_spectrogram_matches(n_fft, hop, win, window):
    x = _rng(4).standard_normal((2, 4800)).astype(np.float32)
    ref = np.asarray(jstft.spectrogram(_j(x), n_fft, hop, win, window))
    out = tstft.spectrogram(_t(x), n_fft, hop, win, window).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)


def test_overlap_add_matches():
    from golf_tpu.models.filters import _overlap_add as j_ola
    from golf_tpu_torch.models.filters import _overlap_add as t_ola
    r = _rng(5)
    frames = r.standard_normal((2, 9, 960)).astype(np.float32)
    win = np.asarray(jdsp.get_window_fn("hanning")(960), np.float32)
    ref_y, ref_n = j_ola(_j(frames), _j(win), 240, 480)
    out_y, out_n = t_ola(_t(frames), _t(win), 240, 480)
    np.testing.assert_allclose(out_y.numpy(), np.asarray(ref_y), atol=1e-5)
    np.testing.assert_allclose(out_n.numpy(), np.asarray(ref_n), atol=1e-6)


def test_host_numpy_copies_match():
    for n in (1199, 749 + 1024, 32769, 5):
        assert tfftsize.conv_fft_size(n) == jfftsize.conv_fft_size(n)
    for name in ("hanning", "hann", "blackman", "boxcar"):
        np.testing.assert_array_equal(tdsp.get_window_fn(name)(960),
                                      jdsp.get_window_fn(name)(960))
    np.testing.assert_array_equal(tresample.sinc_kernel(4),
                                  jresample.sinc_kernel(4))
    kw = dict(table_size=8, lf_v2=True, points=256)
    np.testing.assert_array_equal(tlf.build_glottal_table(**kw),
                                  jlf.build_glottal_table(**kw))
