#!/usr/bin/env python3
"""Where the inverse vocoder's float32 step departs from float64 at -30 dB,
on the CPU (no card).

    python tools/inverse_precision_torch.py

The inverse-mode training step of ``tests/test_torch_inverse.py`` (the
ISMIR23 vocoder with golf.yaml's decoder, ``inverse_target``, the widths of
``tests/test_torch_vocoder.py``, B = 2 x 0.5 s) on ``batch()``'s own
voices with -30 dB of white noise, the same seeded weights and noise in
golf_tpu and the port. Prints, as the largest gradient error over the
parameters relative to each one's largest gradient in the port's float64
step:

* golf_tpu's float32 step, the port's float32 step, and the port's float32
  step with the encoder's f0 map in float64, rounded once;
* the port's float64 step with one stage in float32 (its inputs rounded to
  float32, its outputs widened back): the log-mel, the backbone, the head's
  parameter map (f0 and the groups), the harmonic source, the noise filter,
  the inverse filter;

the witnesses that the f0 map's rounding decides the distance in both
packages, each a float32 step whose f0 values are replaced while its
gradients still flow through its own map (f0 + stop_gradient(f0' - f0)):

* golf_tpu's step with the port's float32 f0 values, and with its own map
  moved one ulp up in every frame;
* the port's step with golf_tpu's float32 f0 values, and with its own map
  moved one ulp up;

the port's float32 gradients against golf_tpu's float32 gradients directly
(relative to golf_tpu's largest), and how many of golf_tpu's jitted float32
f0 values equal the port's float32 map's bit for bit (the rest one ulp
apart).
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import golf_tpu  # noqa: E402,F401  (keeps JAX on the CPU)
from golf_tpu.models import enc as jax_enc  # noqa: E402
from golf_tpu.tasks import vocoder as jvoc  # noqa: E402
from golf_tpu_torch.bridge import (flax_to_state_dict,  # noqa: E402
                                   load_flax_variables)
from golf_tpu_torch.core.sig import Sig  # noqa: E402
from golf_tpu_torch.models import enc as port_enc  # noqa: E402
from golf_tpu_torch.tasks import vocoder as tvoc  # noqa: E402
from tests import test_torch_inverse as ti  # noqa: E402
from tests.test_torch_vocoder import fast_jit, j_cfg, np_tree, t_cfg  # noqa: E402


def cast(o, dtype):
    """Tensors (also inside a Sig, tuple, list or dict) in ``dtype``."""
    if isinstance(o, torch.Tensor):
        return o.to(dtype) if o.is_floating_point() else o
    if isinstance(o, Sig):
        return Sig(cast(o.data, dtype), o.hop)
    if isinstance(o, (tuple, list)):
        return type(o)(cast(v, dtype) for v in o)
    if isinstance(o, dict):
        return {k: cast(v, dtype) for k, v in o.items()}
    return o


def port_grads(step, dtype, island=None, f0_map64=False, f0_values=None):
    """The port's step in ``dtype`` (every gradient in float64); ``island``
    (a module path and a method) runs in float32 inside it; with
    ``f0_map64`` the f0 map runs in float64, rounded once; ``f0_values``
    (a function of the map's values) replaces the map's values, its
    gradient still the map's own."""
    task = tvoc.build_ddsp_vocoder(ti._inverse_cfg(t_cfg), device="cpu")
    load_flax_variables(task, np_tree(step["variables"]))
    task = task.to(dtype)
    task.train()
    if island is not None:
        path, method = island
        parent = task
        for name in path.split(".")[:-1]:
            parent = getattr(parent, name)
        mod = getattr(parent, path.split(".")[-1])
        fn = getattr(copy.deepcopy(mod).float(), method)
        setattr(mod, method, lambda *a, **k: cast(
            fn(*cast(a, torch.float32), **cast(k, torch.float32)), dtype))
    orig = port_enc.VocoderParameterEncoderInterface.params_from_head
    if f0_map64:
        def params_from_head(self, h):
            out = orig(self, h)
            logits = port_enc.split_heads(h, *self.layout)["f0"][0].data
            lo, hi = math.log(self.f0_min), math.log(self.f0_max)
            out["f0"] = Sig(torch.exp(torch.sigmoid(logits.double())
                                      * (hi - lo) + lo).to(logits.dtype),
                            out["f0"].hop)
            return out
        port_enc.VocoderParameterEncoderInterface.params_from_head = \
            params_from_head
    elif f0_values is not None:
        def params_from_head(self, h):
            out = orig(self, h)
            f0 = out["f0"].data
            new = torch.as_tensor(f0_values(f0.detach().numpy()),
                                  dtype=f0.dtype)
            out["f0"] = Sig(f0 + (new - f0).detach(), out["f0"].hop)
            return out
        port_enc.VocoderParameterEncoderInterface.params_from_head = \
            params_from_head
    try:
        loss, _ = task.training_step(
            Sig(torch.from_numpy(step["x"]).to(dtype), 1),
            Sig(torch.from_numpy(step["f0"]).to(dtype), 1),
            noise=torch.from_numpy(step["noise"]).to(dtype))
        loss.backward()
    finally:
        port_enc.VocoderParameterEncoderInterface.params_from_head = orig
    return {k: p.grad.double() for k, p in task.named_parameters()
            if p.grad is not None}


@contextlib.contextmanager
def jax_f0_values(f0_values):
    """golf_tpu's encoder with its f0 map's values replaced by
    ``f0_values`` (a function of the traced values), the gradient still
    the map's own: the map's ``jnp.exp`` (the only one in
    ``golf_tpu/models/enc.py``) seen through a proxy, no file edited."""
    def exp(z):
        f0 = jnp.exp(z)
        held = jax.lax.stop_gradient(f0)
        return f0 + (f0_values(held) - held)
    proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                     if not n.startswith("__")})
    proxy.exp = exp
    saved = jax_enc.jnp
    jax_enc.jnp = proxy
    try:
        yield
    finally:
        jax_enc.jnp = saved


def distance(grads, ref) -> float:
    return max(((torch.as_tensor(np.asarray(grads[k]), dtype=torch.float64)
                 - g).abs().max() / g.abs().max()).item()
               for k, g in ref.items() if k in grads and g.abs().max() > 0)


def f0_maps(step):
    """golf_tpu's jitted float32 f0 map (the encoder's, in its training
    step's mode) and the port's float32 map, as numpy arrays."""
    task = jvoc.build_ddsp_vocoder(ti._inverse_cfg(j_cfg))

    def f0_of(m, x):
        return m.encoder(m.feature_trsfm(x, train=True), train=True)["f0"].data
    f0_j = np.asarray(fast_jit(lambda v, x: task.apply(
        v, x, method=f0_of, rngs=ti.RNGS, mutable=["stats"])[0])(
            step["variables"], jnp.asarray(step["x"])))
    port = tvoc.build_ddsp_vocoder(ti._inverse_cfg(t_cfg), device="cpu")
    load_flax_variables(port, np_tree(step["variables"]))
    port.train()
    with torch.no_grad():
        feats = port.feature_trsfm(torch.from_numpy(step["x"]), train=True)
        f0_t = port.encoder(feats, train=True)["f0"].data.numpy()
    return f0_j, f0_t


def main() -> int:
    torch.set_num_threads(4)
    step = ti.run_jax_inverse_step(extra_noise=False)
    ref = port_grads(step, torch.float64)
    out = {
        "golf_tpu32": distance(flax_to_state_dict(
            {"params": np_tree(step["grads"])}), ref),
        "port32": distance(port_grads(step, torch.float32), ref),
        "port32_f0_map64": distance(port_grads(step, torch.float32,
                                               f0_map64=True), ref)}
    for label, island in (("log_mel", ("feature_trsfm", "forward")),
                          ("backbone", ("encoder.backbone", "forward")),
                          ("head_map", ("encoder", "params_from_head")),
                          ("harmonic_source",
                           ("decoder.harm_oscillator", "forward")),
                          ("noise_filter", ("decoder.noise_filter",
                                            "forward")),
                          ("inverse_filter", ("decoder.end_filter",
                                              "reverse"))):
        out[f"port64_with_{label}_in_float32"] = distance(
            port_grads(step, torch.float64, island), ref)
    f0_j, f0_t = f0_maps(step)
    out["f0_bit_equal_fraction"] = float(np.mean(f0_j == f0_t))
    golf32 = flax_to_state_dict({"params": np_tree(step["grads"])})
    port32 = port_grads(step, torch.float32)
    out["port32_vs_golf_tpu32"] = distance(port32, {
        k: torch.as_tensor(np.asarray(v), dtype=torch.float64)
        for k, v in golf32.items()})
    for label, values in (("port_f0", lambda f0: jnp.asarray(f0_t)),
                          ("own_f0_one_ulp_up",
                           lambda f0: jnp.nextafter(f0, jnp.inf))):
        with jax_f0_values(values):
            wit = ti.run_jax_inverse_step(extra_noise=False)
        out[f"golf_tpu32_with_{label}"] = distance(flax_to_state_dict(
            {"params": np_tree(wit["grads"])}), ref)
    out["port32_with_golf_tpu_f0"] = distance(port_grads(
        step, torch.float32, f0_values=lambda f0: f0_j), ref)
    out["port32_with_own_f0_one_ulp_up"] = distance(port_grads(
        step, torch.float32,
        f0_values=lambda f0: np.nextafter(f0, np.float32(np.inf))), ref)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
