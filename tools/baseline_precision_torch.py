#!/usr/bin/env python3
"""How far a float32 training step of a baseline decoder stands from float64,
in golf_tpu and in the port, on the CPU (no card).

    python tools/baseline_precision_torch.py [--decoders mlsa-taylor world]
        [--width vctk|synthetic] [--batch 2] [--seconds 1.0]

For each decoder (``cfg/ae/decoder/<name>.yaml``) under the encoder of
``cfg/ae/vctk.yaml`` (full width, dropout 0) or ``cfg/ae/synthetic.yaml``,
on a synthetic batch with -30 dB of white noise and f0 voiced everywhere,
the same seeded weights and noise on both sides:

* golf_tpu's step in float32 (jitted); golf_tpu has no float64 step (its
  LSTM's carry is float32 whatever the weights, so ``jax.enable_x64`` fails
  to trace it);
* golf_tpu's float32 step op by op (``jax.disable_jit``);
* the port's step in float32 and in float64 (``task.double()``), the
  arbiter of the float32 steps;
* the encoder's conv pyramid alone, on the input and the output cotangent
  it met in the port's float64 step: golf_tpu's ``ConvPyramid`` under
  ``jax.enable_x64`` in float64 (the witness that both packages compute
  the same pyramid: golf_tpu has no float64 step, but its pyramid has),
  in float32 op by op and in float32 under ``jax.jit``, and the port's
  pyramid in float32, each against the port's float64 step's pyramid
  gradients.

Prints, for each decoder, each distance as the largest gradient error over
the parameters, each relative to that parameter's largest float64 gradient
(over all of them, inside and outside the encoder's conv pyramid), the
port's float32 against golf_tpu's, and the losses. The convolution biases
in front of a train-mode batch norm (``ZERO_GRAD``: the norm removes any
shift, so their true gradient is zero) are left out of every distance by
rule; their largest float64 gradient, relative to the largest of all, is
printed beside. One JSON line per decoder, then the seconds it took.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import golf_tpu  # noqa: E402,F401  (keeps JAX on the CPU)
from golf_tpu.config.registry import load_config as j_load_config  # noqa: E402
from golf_tpu.core.sig import Sig as JSig  # noqa: E402
from golf_tpu.models.unet import ConvPyramid  # noqa: E402
from golf_tpu.models.noise import StandardNormalNoise as JNoise  # noqa: E402
from golf_tpu.tasks.ae import build_voice_autoencoder as j_build  # noqa: E402
from golf_tpu_torch.bridge import (flax_to_state_dict,  # noqa: E402
                                   load_flax_variables)
from golf_tpu_torch.config.registry import load_config as t_load_config  # noqa: E402
from golf_tpu_torch.core.sig import Sig as TSig  # noqa: E402
from golf_tpu_torch.tasks.ae import build_voice_autoencoder as t_build  # noqa: E402
from golf_tpu_torch.tasks.data import SyntheticVoiceDataset  # noqa: E402

RNGS = {"noise": jax.random.key(3), "dropout": jax.random.key(4)}
# convolution biases in front of a train-mode batch norm: zero gradient
ZERO_GRAD = re.compile(r"\.pyramid\.convs\.\d+\.bias$")


def model_cfg(loader, base: str, decoder: str) -> dict:
    cfg = loader(f"cfg/ae/{base}.yaml")
    dec = loader(f"cfg/ae/decoder/{decoder}.yaml")
    cfg = {**cfg["model"]["init_args"], "decoder": dec["decoder"]}
    cfg["encoder_init_args"] = {**cfg["encoder_init_args"], "dropout": 0.0}
    return cfg


def batch(n: int, seconds: float):
    ds = SyntheticVoiceDataset(n, seconds, 24000, seed=3)
    items = [ds[i] for i in range(n)]
    x = np.stack([x for x, _ in items])
    x = x + 0.03 * np.random.default_rng(11).standard_normal(x.shape)
    f0 = np.stack([f for _, f in items])
    return (x.astype(np.float32),
            np.where(f0 > 0, f0, 130.0).astype(np.float32))


def train_apply(task, variables, x, f0, **kw):
    return task.apply(variables, JSig(x, 1), JSig(f0, 1), True, rngs=RNGS,
                      method=lambda m, *a: m.training_step(*a), **kw)


def golf_tpu_steps(decoder: str, base: str, x, f0):
    """golf_tpu's seeded variables, its noise, and its float32 (loss,
    gradients as numpy trees), jitted and op by op."""
    task = j_build(model_cfg(j_load_config, base, decoder))
    v = dict(jax.jit(lambda x_, f_: task.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1),
         "dropout": jax.random.key(2)}, JSig(x_, 1), JSig(f_, 1), True,
        method=lambda m, *a: m.training_step(*a)))(x, f0))
    r = np.random.default_rng(5)
    v["params"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * 0.1), v["params"])
    _, state = jax.jit(lambda v_, x_, f_: train_apply(
        task, v_, x_, f_, mutable=["intermediates", "stats", "batch_stats"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise)))(
            v, x, f0)
    noise = np.array(state["intermediates"]["decoder"]["noise_generator"]
                     ["__call__"][0].data)

    def step(variables, x_, f_):
        def loss_fn(params, others):
            (loss, _), _ = train_apply(task, {**others, "params": params},
                                       x_, f_,
                                       mutable=["stats", "batch_stats"])
            return loss
        others = {k: a for k, a in variables.items() if k != "params"}
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"], others)
        return float(loss), jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), grads)

    with jax.disable_jit():
        eager = step(v, x, f0)
    return v, noise, step(v, x, f0), eager


def port_step(decoder: str, base: str, variables, noise, x, f0, dtype,
              seen: dict = None):
    """The port's (loss, gradients); ``seen`` receives the pyramid's
    module, its input and its output cotangent."""
    task = t_build(model_cfg(lambda p: t_load_config([p]), base, decoder),
                   device="cpu")
    load_flax_variables(task, jax.tree_util.tree_map(np.asarray, variables))
    task = task.to(dtype)
    task.train()
    if seen is not None:
        pyramid = task.encoder.backbone.pyramid
        seen["module"] = pyramid

        def hook(mod, inputs, out):
            seen["input"] = inputs[0].detach().clone()
            out.register_hook(lambda g: seen.__setitem__("cotangent",
                                                          g.detach()))
        pyramid.register_forward_hook(hook)
    loss, _ = task.training_step(TSig(torch.from_numpy(x).to(dtype), 1),
                                 TSig(torch.from_numpy(f0).to(dtype), 1),
                                 noise=torch.from_numpy(noise).to(dtype))
    loss.backward()
    return loss.item(), {k: p.grad.double().numpy()
                         for k, p in task.named_parameters()
                         if p.grad is not None}


def port_pyramid(mod, inp, cot, dtype) -> dict:
    """The port's pyramid's parameter gradients (numpy float64, the port's
    names) for input ``inp`` and output cotangent ``cot`` ((B, C, freq, T)
    numpy or tensors), a copy of ``mod`` in ``dtype``, in train mode."""
    port = copy.deepcopy(mod).to(dtype).train()
    out = port(torch.as_tensor(inp).to(dtype))
    out.backward(torch.as_tensor(cot).to(dtype))
    return {f"encoder.backbone.pyramid.{k}": p.grad.double().numpy()
            for k, p in port.named_parameters()}


def pyramid_alone(variables, seen: dict) -> dict:
    """The pyramid's parameter gradients (the port's names, numpy float64)
    for the input and output cotangent of ``seen``: golf_tpu's
    ``ConvPyramid`` in float64, in float32 op by op and in float32 under
    ``jax.jit``, and the port's in float32."""
    mod = seen["module"]
    chans = tuple(c.out_channels for c in mod.convs)
    pyr = ConvPyramid(chans, tuple(mod.strides))
    xin = seen["input"].permute(0, 2, 3, 1).numpy()      # (B, freq, T, C)
    gout = seen["cotangent"].permute(0, 2, 3, 1).numpy()
    backbone = variables["params"]["encoder"]["backbone"]
    stats = variables["batch_stats"]["encoder"]["backbone"]["ConvPyramid_0"]

    def golf(dtype, jit=False):
        with jax.enable_x64(dtype == np.float64):
            cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(np.asarray(a, dtype)), t)
            params, bs = cast(backbone["ConvPyramid_0"]), cast(stats)

            def grads(p, xin_, gout_):
                def fwd(p_):
                    return pyr.apply({"params": p_, "batch_stats": bs}, xin_,
                                     True, mutable=["batch_stats"])[0]
                _, vjp = jax.vjp(fwd, p)
                return vjp(gout_)[0]
            g = (jax.jit(grads) if jit else grads)(
                params, jnp.asarray(xin.astype(dtype)),
                jnp.asarray(gout.astype(dtype)))
            g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), g)
        tree = {"params": {"encoder": {"backbone": {"ConvPyramid_0": g}}}}
        return flax_to_state_dict(tree)

    return {"golf_tpu64": golf(np.float64),
            "golf_tpu32_eager": golf(np.float32),
            "golf_tpu32_jit": golf(np.float32, jit=True),
            "port32": port_pyramid(mod, seen["input"], seen["cotangent"],
                                   torch.float32)}


def distance(grads: dict, ref: dict, skip: str = None,
             only: str = None) -> tuple:
    """(largest error, its parameter) over the parameters but ``ZERO_GRAD``
    ones, those whose name holds ``skip``, and those whose name does not
    hold ``only``."""
    worst, at = 0.0, None
    for k, r in ref.items():
        scale = np.abs(r).max()
        if ZERO_GRAD.search(k) or (skip and skip in k) or \
                (only and only not in k) or scale == 0:
            continue
        e = float(np.abs(np.asarray(grads[k], np.float64) - r).max() / scale)
        if e > worst:
            worst, at = e, k
    return worst, at


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--decoders", nargs="+", default=["mlsa-taylor", "world"])
    ap.add_argument("--width", choices=["vctk", "synthetic"], default="vctk")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    x, f0 = batch(args.batch, args.seconds)
    for decoder in args.decoders:
        t1 = time.perf_counter()
        v, noise, (loss_j, grads_j), (loss_e, grads_e) = golf_tpu_steps(
            decoder, args.width, x, f0)
        j32, e32 = ({k: np.asarray(g, np.float64) for k, g in
                     flax_to_state_dict({"params": g_}).items()}
                    for g_ in (grads_j, grads_e))
        p32 = port_step(decoder, args.width, v, noise, x, f0, torch.float32)
        seen = {}
        p64 = port_step(decoder, args.width, v, noise, x, f0, torch.float64,
                        seen)
        ref = p64[1]
        alone = pyramid_alone(v, seen)
        top = max(np.abs(r).max() for r in ref.values())
        runs = {"golf_tpu32": j32, "golf_tpu32_eager": e32,
                "port32": p32[1]}
        res = {
            "decoder": decoder, "width": args.width,
            "batch": [args.batch, args.seconds],
            "zero_grad_leaves_port64_max": max(
                float(np.abs(r).max() / top) for k, r in ref.items()
                if ZERO_GRAD.search(k)),
            # each against the port's float64 step: over all parameters,
            # inside the encoder's conv pyramid (its float32 gradients are
            # the least exact; chip_smoke.py holds it apart too) and
            # outside it
            **{f"{name}_vs_port64": {
                "all": distance(g, ref),
                "pyramid": distance(g, ref, only=".pyramid."),
                "outside_pyramid": distance(g, ref, ".pyramid.")}
               for name, g in runs.items()},
            "pyramid_alone_vs_port64": {
                name: distance(g, {k: ref[k] for k in g})
                for name, g in alone.items()},
            "port32_vs_golf_tpu32": distance(p32[1], j32),
            "port32_vs_golf_tpu32_eager": distance(p32[1], e32),
            "loss": {"golf_tpu32": loss_j, "golf_tpu32_eager": loss_e,
                     "port32": p32[0], "port64": p64[0]},
            "seconds": time.perf_counter() - t1}
        print(json.dumps(res), flush=True)
    print(f"baseline_precision_torch: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
