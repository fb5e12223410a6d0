"""The autoencoder's test step of the port (MSS loss plus MCD) against
golf_tpu's, on the CPU: ``ops.cepstrum.mcep`` and ``freqt`` on the same
spectra, ``VoiceAutoEncoder.test_step`` at the widths of
``cfg/ae/synthetic.yaml`` with both decoders (weights through the bridge,
noise captured from golf_tpu's run), and ``autoencode_torch.py test``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models.noise import StandardNormalNoise as JNoise
from golf_tpu.ops import cepstrum as jc
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.config.registry import load_config as t_load_config
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.ops import cepstrum as tc
from golf_tpu_torch.tasks.ae import build_voice_autoencoder as t_build
from tests.test_torch_slice import _batch, _jax_task_and_variables, _model_cfg

torch.set_num_threads(1)


def _spectra(seed=0, frames=6, n_bins=257):
    """Harmonic-like amplitude spectra with a spectral tilt and a few
    near-zero bins (clipped at eps inside mcep)."""
    rng = np.random.default_rng(seed)
    f = np.linspace(0, np.pi, n_bins)
    amp = (np.abs(np.sin((10 + 20 * rng.random((frames, 1))) * f)) + 0.02) \
        * np.exp(-f * rng.uniform(0.5, 2.0, (frames, 1)))
    amp[:, 5] = 0.0
    return amp.astype(np.float32)


def test_freqt_matches_golf_tpu():
    """The warping matrix is the same numpy code; the products in float32
    agree within 1e-6 of max|c|."""
    c = np.random.default_rng(1).standard_normal((3, 257)).astype(np.float32)
    ref = np.asarray(jc.freqt(jnp.asarray(c), 34, 0.46))
    got = tc.freqt(torch.from_numpy(c), 34, 0.46).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6


@pytest.mark.parametrize("n_iter", [0, 2])
def test_mcep_matches_golf_tpu(n_iter):
    """Mel-cepstra of order 34 at alpha 0.46 (the test step's), float32 on
    both sides: within 1e-5 of max|mc| for the warped cepstrum (n_iter 0)
    and 1e-4 after two Newton steps (each step solves a 35 x 35 system in
    float32; XLA and LAPACK factor it in other orders)."""
    amp = _spectra()
    ref = np.asarray(jc.mcep(jnp.asarray(amp), 34, alpha=0.46,
                             n_iter=n_iter))
    got = tc.mcep(torch.from_numpy(amp), 34, alpha=0.46,
                  n_iter=n_iter).numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < (1e-5 if n_iter == 0 else 1e-4), err


@pytest.mark.parametrize("decoder", ["golf", "golf-precise"])
def test_test_step_matches_golf_tpu(decoder):
    """The MSS loss and the MCD of one batch, same weights and noise:
    within 1e-5 relative (the loss) and 1e-4 relative (the MCD, whose
    log-spectra and Newton solves amplify rounding in quiet bins); both
    measured near 2e-7."""
    x, f0 = _batch()
    j_task, variables = _jax_task_and_variables(decoder, x, f0)
    out_j, state = jax.jit(lambda v, x_, f0_: j_task.apply(
        v, JSig(x_, 1), JSig(f0_, 1), rngs={"noise": jax.random.key(3)},
        mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise),
        method=lambda m, *a: m.test_step(*a)))(
            variables, jnp.asarray(x), jnp.asarray(f0))
    noise = np.array(state["intermediates"]["decoder"]["noise_generator"]
                     ["__call__"][0].data)

    t_task = t_build(_model_cfg(lambda p: t_load_config([p]), decoder),
                     device="cpu")
    load_flax_variables(t_task, jax.tree_util.tree_map(np.asarray,
                                                       variables))
    t_task.eval()
    with torch.inference_mode():
        out_t = t_task.test_step(TSig(torch.from_numpy(x), 1),
                                 TSig(torch.from_numpy(f0), 1),
                                 noise=torch.from_numpy(noise))
    assert out_t["N"] == int(out_j["N"]) == x.shape[0]
    for key, tol in (("loss", 1e-5), ("mcd", 1e-4)):
        ref, got = float(out_j[key]), float(out_t[key])
        assert np.isfinite(ref) and ref > 0
        assert abs(got - ref) <= tol * abs(ref), (key, got, ref)


def test_test_cli_prints_mss_and_mcd(tmp_path, capsys):
    from golf_tpu_torch.tasks.cli import run
    rc = run(["test", "--config", "cfg/ae/synthetic.yaml", "--model",
              "cfg/ae/decoder/golf-precise.yaml", "--device", "cpu",
              "--run_dir", str(tmp_path), "data.init_args.n_items=8",
              "data.init_args.duration=0.3", "data.init_args.batch_size=2"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(result) == {"avg_mss_loss", "avg_mcd"}
    assert all(np.isfinite(v) and v > 0 for v in result.values())
    logged = [json.loads(ln) for ln in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert logged[-1]["step"] == -1 and "avg_mcd" in logged[-1]
