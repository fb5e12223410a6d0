"""The GOLF decoders of the port against golf_tpu's SourceFilterSynth, on
the CPU: ``cfg/ae/decoder/golf.yaml`` (GOLF-ff) and ``golf-precise.yaml``
(GOLF-ss) on the same ctrl logits, the same weights (through the bridge)
and the same noise (captured from the JAX StandardNormalNoise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golf_tpu.config.registry import instantiate as j_instantiate
from golf_tpu.config.registry import load_config as j_load_config
from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models.noise import StandardNormalNoise as JNoise
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.config.registry import instantiate as t_instantiate
from golf_tpu_torch.config.registry import load_config as t_load_config
from golf_tpu_torch.core.sig import Sig as TSig

torch.set_num_threads(1)

B, T, HOP = 2, 7200, 240


def _raw(frames, sig_cls, to):
    r = np.random.default_rng(3)

    def s(shape, scale, shift=0.0):
        return sig_cls(to((r.standard_normal(shape) * scale + shift)
                          .astype(np.float32)), HOP)

    return {
        "harm_oscillator_params": (s((B, frames, 64), 0.5),),
        "noise_generator_params": (),
        "noise_filter_params": (s((B, frames, 256), 0.3, -2.0),),
        "end_filter_params": (s((B, frames), 0.2), s((B, frames, 22), 0.2)),
        "room_filter_params": (),
    }


def _body(m, ph, rw):
    return m(ph, **m.apply_ctrl(rw))


def _jax_decode(decoder, variables, phase, raw, key):
    return jax.jit(lambda v, ph, rw: decoder.apply(
        v, JSig(ph, 1), rw, rngs={"noise": key}, method=_body,
        mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise)))(
            variables, jnp.asarray(phase), raw)


@pytest.mark.parametrize("name", ["golf", "golf-precise"])
def test_decoder_matches_golf_tpu(name):
    path = f"cfg/ae/decoder/{name}.yaml"
    j_dec = j_instantiate(j_load_config(path)["decoder"])
    t_dec = t_instantiate(t_load_config([path])["decoder"])

    frames = T // HOP + 1
    f0 = 150.0 + 60.0 * np.sin(np.linspace(0, 9.0, T))[None] * np.ones((B, 1))
    phase = (f0 / 24000.0).astype(np.float32)
    j_raw = _raw(frames, JSig, jnp.asarray)
    t_raw = _raw(frames, TSig, torch.from_numpy)

    variables = jax.jit(lambda ph, rw: j_dec.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        JSig(ph, 1), rw, method=_body))(jnp.asarray(phase), j_raw)
    # every weight seeded and non-zero (the room filter starts at zero)
    r = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * 0.1), variables["params"])
    variables = {**variables, "params": params}
    y_j, state = _jax_decode(j_dec, variables, phase, j_raw,
                             jax.random.key(2))
    noise = np.asarray(
        state["intermediates"]["noise_generator"]["__call__"][0].data)

    load_flax_variables(t_dec, jax.tree_util.tree_map(np.asarray,
                                                      variables))
    with torch.no_grad():
        y_t = t_dec(TSig(torch.from_numpy(phase), 1),
                    **t_dec.apply_ctrl(t_raw),
                    noise=torch.from_numpy(noise.copy()))
    ref = np.asarray(y_j.data)
    out = y_t.data.numpy()
    assert out.shape == ref.shape and y_t.hop == 1
    # fp32 on both sides; the mod-1 phase scans group block totals
    # differently and the two FFT libraries sum in another order: measured
    # ~1.5e-5 of the peak for both decoders, so 1e-4
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err < 1e-4, err


def test_noise_generator_takes_generator_or_tensor():
    from golf_tpu_torch.models.noise import StandardNormalNoise
    ref = TSig(torch.zeros(2, 100), 1)
    gen = StandardNormalNoise()
    a = gen(ref, generator=torch.Generator().manual_seed(5)).data
    b = gen(ref, generator=torch.Generator().manual_seed(5)).data
    assert torch.equal(a, b) and a.std() > 0.5
    given = torch.randn(2, 100)
    assert torch.equal(gen(ref, noise=given).data, given)
    with pytest.raises(ValueError):
        gen(ref, noise=torch.randn(2, 99))
